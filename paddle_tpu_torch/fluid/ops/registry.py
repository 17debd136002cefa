"""Op registry: op type -> PyTorch lowering (+ optional custom grad maker).

The port's counterpart of ``paddle_tpu/fluid/ops/registry.py``, with the
same ``register_lowering`` / slot / attr protocol: a lowering is a plain
function ``fn(ctx, inputs, attrs) -> outputs`` on tensors, where inputs
and outputs map a slot name to a list of tensors (None for a missing
dispensable slot). The executor calls it eagerly on the executor's
device. Shape inference runs the same lowering on ``device="meta"``
tensors (``infer_outputs``) in place of ``jax.eval_shape``.

Gradients follow the JAX package's protocol: most ops get the generic
``grad_of`` op (ops/grad_ops.py); ops whose grad needs other plumbing
(dropout's mask, lookup_table's scatter, the cross-entropy's fused grad)
register a grad maker ``fn(op, block, no_grad_set) -> (descs,
grad_to_var)``.

Randomness: where the JAX package folds a step key into per-op
``jax.random`` keys, the ``LoweringContext`` carries one
``torch.Generator`` on the run's device; ``next_rng`` hands it out.
"""
import torch

__all__ = [
    "register_lowering", "get_lowering", "has_lowering",
    "register_grad_maker", "get_grad_maker", "has_grad_maker",
    "maker_wants_og", "mark_no_grad", "is_no_grad", "is_host_op",
    "LoweringContext", "infer_outputs", "lower_op",
]

_LOWERINGS = {}
_GRAD_MAKERS = {}
_OG_MAKERS = set()       # makers that take the og_avail 4th argument
_NO_GRAD_OPS = set()     # ops with no gradient
_HOST_OPS = set()        # ops run on the host outside the device step


class LoweringContext(object):
    """Per-step context handed to lowerings: the device to create tensors
    on, the run's random generator, the test-mode flag, the dropout
    generator snapshots of this step (rng_tag -> generator state, read back
    by dropout_grad), the forward record a ``grad_of`` op consumes, and the
    output slots of the running op that a later op or a fetch reads or that
    are persistable (``live_outputs``; None = all). The executor sets the
    last two just before each op."""

    def __init__(self, device, generator=None, is_test=False):
        self.device = torch.device(device)
        self.generator = generator
        self.is_test = is_test
        self.dropout_states = {}
        self.record = None
        self.live_outputs = None

    def output_live(self, slot):
        """Is output ``slot`` of the running op read by a later op or a
        fetch, or persistable? A lowering may skip an output that is not,
        as XLA's dead-code elimination drops it in the JAX package."""
        return self.live_outputs is None or slot in self.live_outputs

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


def register_lowering(op_type, no_grad=False, host=False):
    """Decorator: ``fn(ctx, inputs, attrs) -> outputs``."""
    def deco(fn):
        _LOWERINGS[op_type] = fn
        if no_grad:
            _NO_GRAD_OPS.add(op_type)
        if host:
            _HOST_OPS.add(op_type)
        return fn
    return deco


def get_lowering(op_type):
    if op_type not in _LOWERINGS:
        raise NotImplementedError(
            "no PyTorch lowering registered for op %r" % op_type)
    return _LOWERINGS[op_type]


def has_lowering(op_type):
    return op_type in _LOWERINGS


def register_grad_maker(op_type, wants_og=False):
    """Decorator: ``fn(op, block, no_grad_set) -> (grad_op_descs,
    grad_to_var)``; wants_og=True makers take a 4th argument, the set of
    forward output names whose grad is available."""
    def deco(fn):
        _GRAD_MAKERS[op_type] = fn
        if wants_og:
            _OG_MAKERS.add(op_type)
        return fn
    return deco


def get_grad_maker(op_type):
    return _GRAD_MAKERS.get(op_type)


def maker_wants_og(op_type):
    return op_type in _OG_MAKERS


def has_grad_maker(op_type):
    return op_type in _GRAD_MAKERS


def mark_no_grad(op_type):
    _NO_GRAD_OPS.add(op_type)


def is_no_grad(op_type):
    return op_type in _NO_GRAD_OPS


def is_host_op(op_type):
    return op_type in _HOST_OPS


def lower_op(op, env, ctx):
    """Run one op: read its inputs from env, write its outputs into env."""
    inputs = {}
    for slot, names in op.inputs.items():
        inputs[slot] = [None if n == "@EMPTY@" else env[n] for n in names]
    write_outputs(op, get_lowering(op.type)(ctx, inputs, op.attrs), env)


def write_outputs(op, outs, env):
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
