"""Models ported from ``paddle_tpu/models``."""
from . import transformer

__all__ = ["transformer"]
