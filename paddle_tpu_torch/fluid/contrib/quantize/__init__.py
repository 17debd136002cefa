from .quantize_transpiler import QuantizeTranspiler

__all__ = ["QuantizeTranspiler"]
