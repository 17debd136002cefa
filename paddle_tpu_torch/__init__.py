"""paddle_tpu_torch — the PaddlePaddle Fluid programming model on PyTorch and
CUDA, ported from the JAX package ``paddle_tpu`` beside it.

The user surface mirrors ``paddle_tpu``: ``paddle_tpu_torch.fluid`` builds a
Program with fluid.layers and runs it with an Executor, on an NVIDIA card by
default. The attention kernels are CUDA C++ written for Hopper
(``ops/csrc``), built with nvcc at first use. This package never imports
JAX or ``paddle_tpu``.
"""
from . import fluid  # noqa: F401

__version__ = "0.1.0"
