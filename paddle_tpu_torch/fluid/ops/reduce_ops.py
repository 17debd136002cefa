"""Reduction lowerings: mean and reduce_sum (the port's counterpart of
``paddle_tpu/fluid/ops/reduce_ops.py``)."""
import torch

from .registry import register_lowering
from .common import one


@register_lowering("mean")
def _mean(ctx, inputs, attrs):
    return {"Out": [one(inputs, "X").mean()]}


@register_lowering("reduce_sum")
def _reduce_sum(ctx, inputs, attrs):
    """Over ``dim`` (a list, negative dims counted from the end), or over
    everything with ``reduce_all``; ``keep_dim`` keeps the reduced dims as
    size 1."""
    x = one(inputs, "X")
    keep = attrs.get("keep_dim", False)
    if attrs.get("reduce_all", False):
        out = torch.sum(x)
        return {"Out": [out.reshape((1,) * x.ndim) if keep else out]}
    axes = tuple(d % x.ndim for d in attrs.get("dim", [0]))
    return {"Out": [torch.sum(x, dim=axes, keepdim=keep)]}
