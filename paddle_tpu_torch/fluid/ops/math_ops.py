"""Math op lowerings: mul/matmul, elementwise add/sub/mul/div, scale, sum and
the gradient-clip helpers (the port's counterpart of
``paddle_tpu/fluid/ops/math_ops.py``). Large products stay
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


def _elementwise(fn):
    def lower(ctx, inputs, attrs):
        x, y = one(inputs, "X"), one(inputs, "Y")
        return {"Out": [fn(x, align_rank(x, y, attrs.get("axis", -1)))]}
    return lower


for _name, _fn in [("elementwise_add", torch.add),
                   ("elementwise_sub", torch.sub),
                   ("elementwise_mul", torch.mul),
                   ("elementwise_div", torch.div)]:
    register_lowering(_name)(_elementwise(_fn))


@register_lowering("scale")
def _scale(ctx, inputs, attrs):
    x = one(inputs, "X")
    scale = round_scalar(attrs.get("scale", 1.0), x.dtype)
    bias = round_scalar(attrs.get("bias", 0.0), x.dtype)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * scale + bias]}
    return {"Out": [(x + bias) * scale]}


@register_lowering("sum")
def _sum(ctx, inputs, attrs):
    xs = [x for x in inputs.get("X", []) if x is not None]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register_lowering("sign")
def _sign(ctx, inputs, attrs):
    return {"Out": [torch.sign(one(inputs, "X"))]}


@register_lowering("clip")
def _clip(ctx, inputs, attrs):
    return {"Out": [torch.clamp(one(inputs, "X"), attrs["min"],
                                attrs["max"])]}


@register_lowering("clip_by_norm")
def _clip_by_norm(ctx, inputs, attrs):
    x = one(inputs, "X")
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    return {"Out": [x * scale.to(x.dtype)]}


@register_lowering("squared_l2_norm")
def _squared_l2_norm(ctx, inputs, attrs):
    return {"Out": [torch.sum(torch.square(one(inputs, "X"))).reshape(1)]}
