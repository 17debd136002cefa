"""Models ported from ``paddle_tpu/models``."""
from . import bert
from . import deepfm
from . import resnet
from . import transformer

__all__ = ["bert", "deepfm", "resnet", "transformer"]
