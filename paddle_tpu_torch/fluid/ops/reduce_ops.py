"""Reduction lowerings: mean (the port's counterpart of
``paddle_tpu/fluid/ops/reduce_ops.py``)."""
from .registry import register_lowering
from .common import one


@register_lowering("mean")
def _mean(ctx, inputs, attrs):
    return {"Out": [one(inputs, "X").mean()]}
