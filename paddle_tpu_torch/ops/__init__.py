"""paddle_tpu_torch.ops — CUDA kernels for Hopper behind framework ops.
Importing builds nothing: nvcc runs at a kernel's first launch."""
from .attention import fused_attention_bthd

__all__ = ["fused_attention_bthd"]
