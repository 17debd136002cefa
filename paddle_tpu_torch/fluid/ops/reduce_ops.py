"""Reduction lowerings: mean and reduce_sum, reduce_mean, reduce_max,
reduce_min and reduce_prod (the port's counterpart of
``paddle_tpu/fluid/ops/reduce_ops.py``). reduce_max and reduce_min share
the gradient evenly among tied elements (``torch.amax``/``amin``), as
jnp.max and jnp.min do."""
import torch

from .registry import register_lowering
from .common import one


def _prod(x, dim=None, keepdim=False):
    """torch.prod over a tuple of dims (torch.prod takes one at a time)."""
    if dim is None:
        return torch.prod(x)
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _reduce(fn):
    def lower(ctx, inputs, attrs):
        """Over ``dim`` (a list, negative dims counted from the end), or over
        everything with ``reduce_all``; ``keep_dim`` keeps the reduced dims
        as size 1."""
        x = one(inputs, "X")
        keep = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False):
            out = fn(x)
            return {"Out": [out.reshape((1,) * x.ndim) if keep else out]}
        axes = tuple(d % x.ndim for d in attrs.get("dim", [0]))
        return {"Out": [fn(x, dim=axes, keepdim=keep)]}
    return lower


for _name, _fn in [
    ("reduce_sum", torch.sum),
    ("reduce_mean", torch.mean),
    ("reduce_max", torch.amax),
    ("reduce_min", torch.amin),
    ("reduce_prod", _prod),
]:
    register_lowering(_name)(_reduce(_fn))


@register_lowering("mean")
def _mean(ctx, inputs, attrs):
    return {"Out": [one(inputs, "X").mean()]}
