from .compressor import Compressor

__all__ = ["Compressor"]
