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
grad_to_var)``. A grad op of such a maker may read what its forward op
computed (``register_paired_grad``): the executor pairs the two as it
pairs ``grad_of`` with its forward op and hands the grad op the forward
op's outputs (batch_norm_grad reads batch_norm's batch statistics).

Randomness: where the JAX package folds a step key into per-op
``jax.random`` keys, the ``LoweringContext`` carries one
``torch.Generator`` on the run's device; ``next_rng`` hands it out.

Control flow and tensor arrays: ``while`` and ``conditional_block`` run
their sub-block through the executor's block runner (``ctx.block_runner``,
executor.py ``_BlockRunner``); the tensor-array ops are env lowerings
(``register_env_lowering``: ``fn(ctx, env, op)``, which read and write the
run's values by name, an array being a Python list of tensors). An array
index must be a constant that ``fold_const`` recovers from the program
(fill_constant / increment chains), as in the JAX package, where
everything inside jit is a tracer.
"""
import numpy as np
import torch

__all__ = [
    "register_lowering", "get_lowering", "has_lowering",
    "register_group_lowering", "group_key", "lower_group",
    "register_grad_maker", "get_grad_maker", "has_grad_maker",
    "maker_wants_og", "register_paired_grad", "paired_forward",
    "mark_no_grad", "is_no_grad", "mark_host_op", "is_host_op",
    "register_env_lowering", "is_env_op", "OpProxy",
    "LoweringContext", "infer_outputs", "lower_op", "lower_op_list",
]

_LOWERINGS = {}
_ENV_LOWERINGS = {}      # ops that read and write the run's env (arrays)
# ops whose sub-block the executor's block runner runs
CONTROL_OPS = ("while", "conditional_block")
_GRAD_MAKERS = {}
_OG_MAKERS = set()       # makers that take the og_avail 4th argument
_NO_GRAD_OPS = set()     # ops with no gradient
_HOST_OPS = set()        # ops run on the host outside the device step
_GROUP_LOWERINGS = {}    # op type -> (group lowering, run key)
_PAIRED_GRADS = {}       # grad op type -> (forward op type, shared slots)


class LoweringContext(object):
    """Per-step context handed to lowerings: the device to create tensors
    on, the run's random generator, the test-mode flag, the dropout
    generator snapshots of this step (rng_tag -> generator state, read back
    by dropout_grad), the forward record a ``grad_of`` op or a paired grad
    op consumes (ops/grad_ops.py ``ForwardRecord``) and whether a later
    grad op of the same forward op consumes it too (``retain_graph``), and
    the output slots of the running op that a later op or a fetch reads or
    that are persistable (``live_outputs``; None = all). The executor sets
    the last three just before each op.

    For control flow: the runner of while / conditional_block sub-blocks
    (``block_runner``), the generator state at each control op by its
    sub-block (``ctrl_rng``, which a grad op's replay restores so that it
    draws what the forward drew), whether this context replays a sub-block
    for a gradient (``grad_replay``: a nested while then needs its
    ``max_trip_count``), the scalar constants folded so far
    (``const_env``: var name -> numpy value, which address tensor arrays),
    and ``keyless``: a StaticRNN step's context, which draws as the JAX
    package's keyless context does (one fixed stream for each seed)."""

    def __init__(self, device, generator=None, is_test=False,
                 block_runner=None):
        self.device = torch.device(device)
        self.generator = generator
        self.is_test = is_test
        self.dropout_states = {}
        self.record = None
        self.retain_graph = False
        self.live_outputs = None
        self.block_runner = block_runner
        self.ctrl_rng = {}
        self.grad_replay = False
        self.const_env = {}
        self.keyless = False

    def output_live(self, slot):
        """Is output ``slot`` of the running op read by a later op or a
        fetch, or persistable? A lowering may skip an output that is not,
        as XLA's dead-code elimination drops it in the JAX package."""
        return self.live_outputs is None or slot in self.live_outputs

    def next_rng(self, seed=0):
        """Generator for the next random op. seed!=0 -> a fresh generator
        seeded with it, independent of the run's stream (the reference's
        fixed-seed uniform_random semantics); in a ``keyless`` context a
        fresh generator seeded with seed, 0 too. None under shape
        inference, where no values are drawn."""
        if self.device.type == "meta":
            return None
        if seed or self.keyless:
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


def register_group_lowering(op_type, key):
    """Decorator: ``fn(ctx, [inputs], [attrs]) -> [outputs]`` lowers a run of
    consecutive ops of ``op_type`` at once (the executor's plan finds the
    runs). ``key(op)`` is what the ops of one run share, or None for an op
    that runs alone through its own lowering."""
    def deco(fn):
        _GROUP_LOWERINGS[op_type] = (fn, key)
        return fn
    return deco


def group_key(op):
    """The run key of ``op``, or None if its type has no group lowering."""
    entry = _GROUP_LOWERINGS.get(op.type)
    return entry[1](op) if entry else None


def lower_group(ops, env, ctx):
    """Run a run of ops (one type, one key) through its group lowering."""
    fn = _GROUP_LOWERINGS[ops[0].type][0]
    inputs = [{slot: [None if n == "@EMPTY@" else env[n] for n in names]
               for slot, names in op.inputs.items()} for op in ops]
    for op, outs in zip(ops, fn(ctx, inputs, [op.attrs for op in ops])):
        write_outputs(op, outs, env)


def register_env_lowering(op_type, no_grad=True):
    """Decorator: ``fn(ctx, env, op)`` for an op that reads and writes the
    run's values by name (the tensor-array ops: an array is an op output
    that is read, changed and written back)."""
    def deco(fn):
        _ENV_LOWERINGS[op_type] = fn
        if no_grad:
            _NO_GRAD_OPS.add(op_type)
        return fn
    return deco


def is_env_op(op_type):
    return op_type in _ENV_LOWERINGS


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


def register_paired_grad(grad_type, fwd_type, slots):
    """Grad ops of ``grad_type`` read the outputs of their forward op: the
    latest op of ``fwd_type`` before them, not yet paired, whose input
    ``slots`` hold the same names as theirs. The executor runs that forward
    op once and hands its outputs to the grad op as ``ctx.record``."""
    _PAIRED_GRADS[grad_type] = (fwd_type, tuple(slots))


def paired_forward(op_type):
    """(forward op type, shared slots) of a paired grad op type, or None."""
    return _PAIRED_GRADS.get(op_type)


def mark_no_grad(op_type):
    _NO_GRAD_OPS.add(op_type)


def is_no_grad(op_type):
    return op_type in _NO_GRAD_OPS


def mark_host_op(op_type):
    _HOST_OPS.add(op_type)


def is_host_op(op_type):
    return op_type in _HOST_OPS


class OpProxy(object):
    """An op rebuilt from its ``to_dict`` form (the step ops a ``recurrent``
    op carries in its ``sub_ops_desc`` attr)."""

    __slots__ = ("type", "inputs", "outputs", "attrs")

    def __init__(self, d):
        self.type = d["type"]
        self.inputs = d.get("inputs", {})
        self.outputs = d.get("outputs", {})
        self.attrs = d.get("attrs", {})

    @property
    def input_arg_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    @property
    def output_arg_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])


def fold_const(op, ctx):
    """Carry scalar constants through a program's index arithmetic
    (fill_constant, increment, assign, cast, scale) in ``ctx.const_env``;
    any other writer of a folded name drops it. The JAX package's
    ``_fold_const``: a while op drops the names its body writes, so an
    array index that a loop changes is no constant."""
    c = ctx.const_env
    t = op.type
    try:
        if t == "fill_constant":
            shape = tuple(op.attrs.get("shape") or (1,))
            if int(np.prod(shape)) == 1:
                c[op.output("Out")[0]] = np.asarray(
                    op.attrs.get("value", 0.0)).reshape(shape)
            else:
                c.pop(op.output("Out")[0], None)
        elif t == "increment":
            src = op.input("X")[0]
            if src in c:
                c[op.output("Out")[0]] = c[src] + op.attrs.get("step", 1.0)
            else:
                c.pop(op.output("Out")[0], None)
        elif t in ("assign", "cast", "scale"):
            src = op.input("X")[0]
            if src in c:
                v = c[src]
                if t == "scale":
                    v = v * op.attrs.get("scale", 1.0) + \
                        op.attrs.get("bias", 0.0)
                c[op.output("Out")[0]] = v
            else:
                c.pop(op.output("Out")[0], None)
        else:
            for n in op.output_arg_names:
                c.pop(n, None)
    except Exception:
        pass


def lower_op_list(ops, env, ctx):
    """Run ops one after another on env (a sub-block's, a StaticRNN
    step's), folding constants as it goes."""
    for op in ops:
        fold_const(op, ctx)
        lower_op(op, env, ctx)


def lower_op(op, env, ctx):
    """Run one op: read its inputs from env, write its outputs into env.
    A while or conditional_block op goes to the block runner, an env op to
    its env lowering."""
    if op.type in CONTROL_OPS:
        if ctx.block_runner is None:
            raise NotImplementedError(
                "%s op requires a block runner (the executor's)" % op.type)
        ctx.block_runner.run_control_op(op, env, ctx)
        return
    env_fn = _ENV_LOWERINGS.get(op.type)
    if env_fn is not None:
        env_fn(ctx, env, op)
        return
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
