"""Math op lowerings: mul/matmul, elementwise_add, scale (the port's
counterpart of ``paddle_tpu/fluid/ops/math_ops.py``). Large products stay
``torch.matmul``, as the JAX package leaves them to XLA."""
import torch

from .registry import register_lowering
from .common import one, align_rank, flatten_to_2d, round_scalar


@register_lowering("mul")
def _mul(ctx, inputs, attrs):
    x, y = one(inputs, "X"), one(inputs, "Y")
    xd = attrs.get("x_num_col_dims", 1)
    yd = attrs.get("y_num_col_dims", 1)
    out = torch.matmul(flatten_to_2d(x, xd), flatten_to_2d(y, yd))
    return {"Out": [out.reshape(tuple(x.shape[:xd]) + tuple(y.shape[yd:]))]}


@register_lowering("matmul")
def _matmul(ctx, inputs, attrs):
    x, y = one(inputs, "X"), one(inputs, "Y")
    tx, ty = attrs.get("transpose_X", False), attrs.get("transpose_Y", False)
    alpha = attrs.get("alpha", 1.0)
    if x.ndim == 1:
        x = x[None, :]
    if y.ndim == 1:
        y = y[:, None]
    if tx:
        x = x.transpose(-1, -2)
    if ty:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    if alpha != 1.0:
        out = out * round_scalar(alpha, out.dtype)
    return {"Out": [out]}


@register_lowering("elementwise_add")
def _elementwise_add(ctx, inputs, attrs):
    x, y = one(inputs, "X"), one(inputs, "Y")
    return {"Out": [x + align_rank(x, y, attrs.get("axis", -1))]}


@register_lowering("scale")
def _scale(ctx, inputs, attrs):
    x = one(inputs, "X")
    scale = round_scalar(attrs.get("scale", 1.0), x.dtype)
    bias = round_scalar(attrs.get("bias", 0.0), x.dtype)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * scale + bias]}
    return {"Out": [(x + bias) * scale]}
