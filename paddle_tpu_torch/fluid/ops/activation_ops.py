"""Activation lowerings: the reference's activation set and softmax (the
port's counterpart of ``paddle_tpu/fluid/ops/activation_ops.py``).

gelu is the tanh form: the JAX lowering is ``jax.nn.gelu``, whose default
is ``approximate=True``.

A formula of several operations (elu, swish, selu, the clipped and
shrinking ones) runs in float32 on a bfloat16 or float16 input and rounds
once at the end, as the one-call activations (tanh, sigmoid) do inside
PyTorch. Clipping is ``minimum(maximum(x, lo), hi)``, as ``jnp.clip``: at
a bound that x equals, the gradient is split evenly, where
``torch.clamp`` would pass it whole.
"""
import torch
import torch.nn.functional as F

from .registry import register_lowering
from .common import one, round_scalar


def _f32(fn):
    """fn computed in float32 on a half-precision x, rounded once to x's
    dtype."""
    def wrapped(x, *args):
        if x.dtype in (torch.bfloat16, torch.float16):
            return fn(x.float(), *args).to(x.dtype)
        return fn(x, *args)
    return wrapped


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _act(fn):
    def lower(ctx, inputs, attrs):
        return {"Out": [fn(one(inputs, "X"))]}
    return lower


_ACTS = {
    "abs": torch.abs,
    "acos": torch.acos,
    "asin": torch.asin,
    "atan": torch.atan,
    "ceil": torch.ceil,
    "cos": torch.cos,
    "exp": torch.exp,
    "floor": torch.floor,
    "log": torch.log,
    "reciprocal": torch.reciprocal,
    "relu": torch.relu,
    "round": torch.round,
    "sigmoid": torch.sigmoid,
    "sin": torch.sin,
    "sqrt": torch.sqrt,
    "square": torch.square,
    "softsign": _f32(F.softsign),
    "tanh": torch.tanh,
    "logsigmoid": F.logsigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}
for _n, _f in _ACTS.items():
    register_lowering(_n)(_act(_f))


def _attr_act(op_type, fn, defaults):
    """An activation with float attrs: ``fn(x, *attrs)``, each attr from the
    op or its default."""
    fn = _f32(fn)

    def lower(ctx, inputs, attrs):
        return {"Out": [fn(one(inputs, "X"),
                           *[attrs.get(k, d) for k, d in defaults])]}
    register_lowering(op_type)(lower)


_attr_act("brelu", _clip, [("t_min", 0.0), ("t_max", 24.0)])
_attr_act("elu", lambda x, a: torch.where(
    x > 0, x, a * torch.expm1(torch.where(x > 0, torch.zeros_like(x), x))),
    [("alpha", 1.0)])
_attr_act("hard_shrink", lambda x, t: torch.where(
    torch.abs(x) > t, x, torch.zeros_like(x)), [("threshold", 0.5)])
_attr_act("hard_sigmoid", lambda x, slope, offset: _clip(
    x * slope + offset, 0.0, 1.0), [("slope", 0.2), ("offset", 0.5)])
# jax.nn.leaky_relu keeps x where x >= 0: the gradient at 0 is 1
_attr_act("leaky_relu", lambda x, a: torch.where(x >= 0, x, a * x),
          [("alpha", 0.02)])
_attr_act("relu6", lambda x, t: _clip(x, 0.0, t), [("threshold", 6.0)])
_attr_act("soft_relu", lambda x, t: torch.log1p(torch.exp(_clip(x, -t, t))),
          [("threshold", 40.0)])
_attr_act("softshrink", lambda x, lam: torch.where(
    x > lam, x - lam, torch.where(x < -lam, x + lam, torch.zeros_like(x))),
    [("lambda", 0.5)])
_attr_act("stanh", lambda x, a, b: b * torch.tanh(a * x),
          [("scale_a", 2.0 / 3.0), ("scale_b", 1.7159)])
_attr_act("swish", lambda x, beta: x * torch.sigmoid(beta * x),
          [("beta", 1.0)])
_attr_act("tanh_shrink", lambda x: x - torch.tanh(x), [])
_attr_act("thresholded_relu", lambda x, t: torch.where(
    x > t, x, torch.zeros_like(x)), [("threshold", 1.0)])
_attr_act("selu", lambda x, scale, alpha: scale * torch.where(
    x > 0, x, alpha * (torch.exp(x) - 1.0)),
    [("scale", 1.0507009873554805), ("alpha", 1.6732632423543772)])
# jax.nn.softplus is logaddexp(x, 0), with no linear branch past 20
_attr_act("softplus", lambda x: torch.logaddexp(x, torch.zeros_like(x)), [])


@register_lowering("pow")
def _pow(ctx, inputs, attrs):
    """x ** factor, the factor rounded to x's dtype first."""
    x = one(inputs, "X")
    return {"Out": [torch.pow(x, round_scalar(attrs.get("factor", 1.0),
                                              x.dtype))]}


@register_lowering("prelu")
def _prelu(ctx, inputs, attrs):
    """where(x > 0, x, alpha * x), alpha one value ("all"), one a channel
    ("channel") or one an element of a sample ("element"). The output keeps
    x's dtype (JAX promotes a bfloat16 x times the float32 alpha to float32:
    ROADMAP Queue 3)."""
    x, alpha = one(inputs, "X"), one(inputs, "Alpha")
    mode = attrs.get("mode", "all")
    if mode == "all":
        a = alpha.reshape(())
    elif mode == "channel":
        a = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    else:  # element
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    xf = x.to(torch.promote_types(x.dtype, alpha.dtype))
    return {"Out": [torch.where(x > 0, xf, a * xf).to(x.dtype)]}


@register_lowering("maxout")
def _maxout(ctx, inputs, attrs):
    """The max over each group of ``groups`` channels (NCHW); tied maxima
    share the gradient evenly, as jnp.max's."""
    x = one(inputs, "X")
    groups = attrs["groups"]
    n, c, h, w = x.shape
    return {"Out": [torch.amax(x.reshape(n, c // groups, groups, h, w),
                               dim=2)]}


@register_lowering("softmax")
def _softmax(ctx, inputs, attrs):
    # fluid softmax normalizes over the last dim
    return {"Out": [torch.softmax(one(inputs, "X"), dim=-1)]}
