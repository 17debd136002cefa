"""Op registry: op type -> PyTorch lowering.

The port's counterpart of ``paddle_tpu/fluid/ops/registry.py``, with the
same ``register_lowering`` / slot / attr protocol: a lowering is a plain
function ``fn(ctx, inputs, attrs) -> outputs`` on tensors, where inputs
and outputs map a slot name to a list of tensors (None for a missing
dispensable slot). The executor calls it eagerly on the executor's
device. Shape inference runs the same lowering on ``device="meta"``
tensors (``infer_outputs``) in place of ``jax.eval_shape``.

Randomness: where the JAX package folds a step key into per-op
``jax.random`` keys, the ``LoweringContext`` carries one
``torch.Generator`` on the run's device; ``next_rng`` hands it out.
"""
import torch

__all__ = [
    "register_lowering", "get_lowering", "has_lowering",
    "LoweringContext", "infer_outputs", "lower_op",
]

_LOWERINGS = {}


class LoweringContext(object):
    """Per-run context handed to lowerings: the device to create tensors
    on, the run's random generator and the test-mode flag."""

    def __init__(self, device, generator=None, is_test=False):
        self.device = torch.device(device)
        self.generator = generator
        self.is_test = is_test

    def next_rng(self, seed=0):
        """Generator for the next random op. seed!=0 -> a fresh generator
        seeded with it, independent of the run's stream (the reference's
        fixed-seed uniform_random semantics). None under shape inference,
        where no values are drawn."""
        if self.device.type == "meta":
            return None
        if seed:
            g = torch.Generator(device=self.device)
            g.manual_seed(int(seed))
            return g
        return self.generator


def register_lowering(op_type):
    """Decorator: ``fn(ctx, inputs, attrs) -> outputs``."""
    def deco(fn):
        _LOWERINGS[op_type] = fn
        return fn
    return deco


def get_lowering(op_type):
    if op_type not in _LOWERINGS:
        raise NotImplementedError(
            "no PyTorch lowering registered for op %r" % op_type)
    return _LOWERINGS[op_type]


def has_lowering(op_type):
    return op_type in _LOWERINGS


def lower_op(op, env, ctx):
    """Run one op: read its inputs from env, write its outputs into env."""
    inputs = {}
    for slot, names in op.inputs.items():
        inputs[slot] = [None if n == "@EMPTY@" else env[n] for n in names]
    outs = get_lowering(op.type)(ctx, inputs, op.attrs)
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        for i, n in enumerate(names):
            if n == "@EMPTY@" or i >= len(vals) or vals[i] is None:
                continue
            env[n] = vals[i]


def infer_outputs(op_type, input_metas, attrs):
    """Run an op's lowering on meta tensors to get output shapes/dtypes.

    input_metas: dict slot -> list of meta tensors (or None).
    Returns dict slot -> list of meta tensors.
    """
    ctx = LoweringContext("meta")
    return get_lowering(op_type)(ctx, input_metas, attrs)
