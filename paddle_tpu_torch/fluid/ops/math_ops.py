"""Math op lowerings: mul/matmul, the elementwise family, scale, sum, the
gradient-clip helpers, cumsum, increment and the norms (the port's
counterpart of ``paddle_tpu/fluid/ops/math_ops.py``). Large products stay
``torch.matmul``, as the JAX package leaves them to XLA.

The elementwise ops keep jnp's semantics: ``elementwise_mod`` takes the
divisor's sign (``torch.remainder``, not ``torch.fmod``),
``elementwise_floordiv`` rounds toward minus infinity, and
``elementwise_max``/``min`` split the gradient evenly between x and y where
they tie, as ``jnp.maximum``/``minimum`` do."""
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


def _floordiv(x, y):
    return torch.div(x, y, rounding_mode="floor")


for _name, _fn in [("elementwise_add", torch.add),
                   ("elementwise_sub", torch.sub),
                   ("elementwise_mul", torch.mul),
                   ("elementwise_div", torch.div),
                   ("elementwise_max", torch.maximum),
                   ("elementwise_min", torch.minimum),
                   ("elementwise_pow", torch.pow),
                   ("elementwise_mod", torch.remainder),
                   ("elementwise_floordiv", _floordiv)]:
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


@register_lowering("squared_l2_distance")
def _squared_l2_distance(ctx, inputs, attrs):
    x, y = one(inputs, "X"), one(inputs, "Y")
    sub = x - torch.broadcast_to(y, x.shape)
    dist = torch.sum(torch.square(sub), dim=tuple(range(1, x.ndim)))
    return {"sub_result": [sub], "Out": [dist.reshape(x.shape[0], 1)]}


@register_lowering("cumsum")
def _cumsum(ctx, inputs, attrs):
    """As the JAX lowering: with ``reverse`` the sum is recomputed from x,
    so ``exclusive`` is dropped when both are set (ROADMAP Queue 3)."""
    x = one(inputs, "X")
    axis = attrs.get("axis", -1) % x.ndim
    out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", False):
        out = torch.cat([torch.zeros_like(out.narrow(axis, 0, 1)),
                         out.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)
    if attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, [axis]), dim=axis),
                         [axis])
    return {"Out": [out]}


@register_lowering("increment")
def _increment(ctx, inputs, attrs):
    x = one(inputs, "X")
    return {"Out": [x + round_scalar(attrs.get("step", 1.0), x.dtype)]}


@register_lowering("minus")
def _minus(ctx, inputs, attrs):
    return {"Out": [one(inputs, "X") - one(inputs, "Y")]}


@register_lowering("cos_sim")
def _cos_sim(ctx, inputs, attrs):
    """Row-wise cosine of X and Y ([1, D] Y broadcasts over X's rows)."""
    x, y = one(inputs, "X"), one(inputs, "Y")
    y = torch.broadcast_to(y, x.shape)
    xn = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=1, keepdim=True))
    out = torch.sum(x * y, dim=1, keepdim=True) / \
        torch.clamp(xn * yn, min=1e-12)
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


@register_lowering("l1_norm")
def _l1_norm(ctx, inputs, attrs):
    return {"Out": [torch.sum(torch.abs(one(inputs, "X"))).reshape(1)]}


@register_lowering("norm")
def _norm(ctx, inputs, attrs):
    x = one(inputs, "X")
    axis = attrs.get("axis", -1)
    eps = attrs.get("epsilon", 1e-10)
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True) +
                      eps)
    return {"Out": [x / norm], "Norm": [norm]}


@register_lowering("isfinite", no_grad=True)
def _isfinite(ctx, inputs, attrs):
    """One [1] bool over every input: are all their elements finite?"""
    ok = torch.ones((), dtype=torch.bool, device=ctx.device)
    for x in inputs.get("X", []):
        if x is not None:
            ok = torch.logical_and(ok, torch.all(torch.isfinite(x)))
    return {"Out": [ok.reshape(1)]}
