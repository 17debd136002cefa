from .utility import Calibrator

__all__ = ["Calibrator"]
