"""Activation lowerings: relu, sqrt, tanh, sigmoid, square, gelu and softmax
(the port's counterpart of ``paddle_tpu/fluid/ops/activation_ops.py``).

gelu is the tanh form: the JAX lowering is ``jax.nn.gelu``, whose default
is ``approximate=True``."""
import torch
import torch.nn.functional as F

from .registry import register_lowering
from .common import one


def _act(fn):
    def lower(ctx, inputs, attrs):
        return {"Out": [fn(one(inputs, "X"))]}
    return lower


for _name, _fn in [("relu", torch.relu), ("sqrt", torch.sqrt),
                   ("tanh", torch.tanh), ("sigmoid", torch.sigmoid),
                   ("square", torch.square),
                   ("gelu", lambda x: F.gelu(x, approximate="tanh"))]:
    register_lowering(_name)(_act(_fn))


@register_lowering("softmax")
def _softmax(ctx, inputs, attrs):
    # fluid softmax normalizes over the last dim
    return {"Out": [torch.softmax(one(inputs, "X"), dim=-1)]}
