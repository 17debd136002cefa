"""Activation lowerings: relu, sqrt and softmax (the port's counterpart of
``paddle_tpu/fluid/ops/activation_ops.py``)."""
import torch

from .registry import register_lowering
from .common import one


@register_lowering("relu")
def _relu(ctx, inputs, attrs):
    return {"Out": [torch.relu(one(inputs, "X"))]}


@register_lowering("softmax")
def _softmax(ctx, inputs, attrs):
    # fluid softmax normalizes over the last dim
    return {"Out": [torch.softmax(one(inputs, "X"), dim=-1)]}


@register_lowering("sqrt")
def _sqrt(ctx, inputs, attrs):
    return {"Out": [torch.sqrt(one(inputs, "X"))]}
