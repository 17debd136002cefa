"""Compare and logical lowerings: equal ... greater_equal, the four
logical ops and is_empty (the port's counterpart of
``paddle_tpu/fluid/ops/compare_ops.py``). Each output is a bool tensor on
the inputs' device; none has a gradient."""
import torch

from .registry import register_lowering
from .common import one
# Y aligned to X's dims from ``axis``, as the elementwise ops take it
from .math_ops import _elementwise as _cmp

for _name, _fn in [
    ("equal", torch.eq),
    ("not_equal", torch.ne),
    ("less_than", torch.lt),
    ("less_equal", torch.le),
    ("greater_than", torch.gt),
    ("greater_equal", torch.ge),
]:
    register_lowering(_name, no_grad=True)(_cmp(_fn))


def _logical(fn, binary=True):
    def lower(ctx, inputs, attrs):
        x = one(inputs, "X")
        if binary:
            return {"Out": [fn(x, one(inputs, "Y"))]}
        return {"Out": [fn(x)]}
    return lower


register_lowering("logical_and", no_grad=True)(_logical(torch.logical_and))
register_lowering("logical_or", no_grad=True)(_logical(torch.logical_or))
register_lowering("logical_xor", no_grad=True)(_logical(torch.logical_xor))
register_lowering("logical_not", no_grad=True)(_logical(torch.logical_not,
                                                        binary=False))


@register_lowering("is_empty", no_grad=True)
def _is_empty(ctx, inputs, attrs):
    """A 0-d bool: does X hold no element? (known from the shape, no sync)"""
    x = one(inputs, "X")
    return {"Out": [torch.tensor(x.numel() == 0, device=x.device)]}
