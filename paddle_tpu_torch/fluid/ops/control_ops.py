"""while / conditional_block and their gradients.

The port's counterpart of ``paddle_tpu/fluid/ops/control_ops.py`` (its
``while``, ``conditional_block``, ``while_grad`` and
``conditional_block_grad``; ``get_places`` and ``allreduce`` wait for
ROADMAP Queue 1 item 7). The executor's block runner
(executor.py ``_BlockRunner``) runs a while op's sub-block eagerly, a trip
at a time, reading the condition on the host once a trip, and a
conditional_block's sub-block when its predicate holds.

The grad makers are the JAX package's: the same snapshot ``assign`` ops
before the forward op, the same grad op descs, the same bound on a while's
trips (given or inferred from the counter pattern) and the same errors at
``append_backward``. Where the JAX grad lowerings replay the sub-block as a
bounded ``lax.scan`` (or a ``lax.cond``) under ``jax.vjp``, the port's
replay the sub-block eagerly from the snapshots with autograd on, at most
``max_trip_count`` trips, and call ``torch.autograd.grad``. A replay
restores the generator state the forward op saw at each trip, so it draws
what the forward drew. A condition that still holds after the bound makes
every input gradient NaN, as in the JAX package.
"""
import math

import torch

from .registry import (register_lowering, register_grad_maker,
                       lower_op_list, LoweringContext)

EMPTY_VAR = "@EMPTY@"
NESTED_BOUND_MESSAGE = (
    "gradient through a NESTED while loop needs a static trip-count bound "
    "on the inner loop: pass While(cond, max_trip_count=N) on the inner "
    "While")


@register_lowering("while", no_grad=True)
def _while(ctx, inputs, attrs):
    """A while op runs through the executor's block runner (registry
    ``lower_op``), which needs the op's names; its lowering alone cannot."""
    raise NotImplementedError("while op requires a block runner")


@register_lowering("conditional_block", no_grad=True)
def _conditional_block(ctx, inputs, attrs):
    raise NotImplementedError("conditional_block requires a block runner")


def _sub_block_writes(sub):
    writes = set()
    for o in sub.ops:
        writes.update(n for n in o.output_arg_names if n != EMPTY_VAR)
    return writes


def _const_scalar_before(block, name, stop_op):
    """The value of a scalar fill_constant chain just before ``stop_op`` in
    ``block``, or None."""
    val = None
    for o in block.ops:
        if o is stop_op:
            break
        if name in o.output_arg_names:
            val = None
            if o.type == "fill_constant" and o.output("Out") and \
                    o.output("Out")[0] == name:
                val = float(o.attrs.get("value", 0.0))
    return val


def _infer_while_bound(block, op, sub):
    """The trip count of the counter loop ``i = c0; while i < limit: ...;
    i += step`` (the reference tests' While), or None when the loop does
    not match it."""
    cond_name = op.input("Condition")[0]
    cmp_op = None
    for o in sub.ops:
        if cond_name in o.output_arg_names and \
                o.type in ("less_than", "less_equal"):
            cmp_op = o
    if cmp_op is None:
        return None
    i_name, lim_name = cmp_op.input("X")[0], cmp_op.input("Y")[0]
    if lim_name in _sub_block_writes(sub):
        return None
    lim = _const_scalar_before(block, lim_name, op)
    i0 = _const_scalar_before(block, i_name, op)
    if lim is None or i0 is None:
        return None
    step = None
    for o in sub.ops:
        if o.type == "increment" and o.input("X") and \
                o.input("X")[0] == i_name:
            step = float(o.attrs.get("step", 1.0))
    if not step or step <= 0:
        return None
    n = (lim - i0) / step
    bound = int(math.ceil(n)) if cmp_op.type == "less_than" \
        else int(math.floor(n)) + 1
    return max(bound, 0)


def _needs_grad(block, name, no_grad_set):
    from ..core_types import dtype_is_floating
    if name in no_grad_set or name == EMPTY_VAR:
        return False
    try:
        v = block._var_recursive(name)
    except ValueError:
        return False
    if v.stop_gradient:
        return False
    return dtype_is_floating(v.dtype or "float32")


def _grad_wiring(block, ins, outs, no_grad_set, og_avail):
    """Which inputs need grads, the OG names to read (@EMPTY@ where no grad
    flows into an output), the IG names to write, and the grad -> var map."""
    from ..framework import grad_var_name
    need = [_needs_grad(block, n, no_grad_set) for n in ins]
    ogs = [grad_var_name(n) if n in og_avail else EMPTY_VAR for n in outs]
    igs = [grad_var_name(n) if f else EMPTY_VAR for n, f in zip(ins, need)]
    g2v = {grad_var_name(n): n for n, f in zip(ins, need) if f}
    return need, ogs, igs, g2v


def _check_nested_whiles_bounded(program, sub):
    """Raise at append_backward when the differentiated sub-block holds a
    while with no bound."""
    for o in sub.ops:
        if o.type in ("while", "conditional_block"):
            inner = program.block(o.attr("sub_block"))
            if o.type == "while" and not o.attr("max_trip_count"):
                raise NotImplementedError(NESTED_BOUND_MESSAGE)
            _check_nested_whiles_bounded(program, inner)


def _snapshot_inputs(block, op, names, tag):
    """Insert an assign op before ``op`` for each name its sub-block
    overwrites, so the grad op reads the value from before the loop.
    Returns the names the grad op reads."""
    from .. import unique_name
    sub = block.program.block(op.attr("sub_block"))
    writes = _sub_block_writes(sub)
    idx = block.ops.index(op)
    result = []
    for n in names:
        if n not in writes:
            result.append(n)
            continue
        snap = unique_name.generate(n + "@" + tag)
        v = block._var_recursive(n)
        block.create_var(name=snap, shape=v.shape, dtype=v.dtype)
        block.insert_op(idx, type="assign", inputs={"X": [n]},
                        outputs={"Out": [snap]})
        idx += 1
        result.append(snap)
    return result


@register_grad_maker("while", wants_og=True)
def _while_grad_maker(op, block, no_grad_set, og_avail=()):
    """Gradient of the while op (reference: controlflow/while_op.cc:118
    WhileGradOp): one while_grad op that replays the loop from snapshots of
    its inputs, at most the loop's bound of trips: ``While(cond,
    max_trip_count=N)`` or the inferred counter pattern."""
    sub = block.program.block(op.attr("sub_block"))
    bound = op.attr("max_trip_count") or _infer_while_bound(block, op, sub)
    if not bound:
        raise NotImplementedError(
            "append_backward: gradient through a while loop needs a static "
            "trip-count bound for the reverse-scan replay (XLA static-shape "
            "discipline); pass While(cond, max_trip_count=N) or use the "
            "canonical `i = const; while i < const: i += const` pattern "
            "so the bound can be inferred")
    _check_nested_whiles_bounded(block.program, sub)
    ext = list(op.input("X"))
    cond_name = op.input("Condition")[0]
    snaps = _snapshot_inputs(block, op, ext, "WHILE_IN")
    # a body that never touches the condition leaves it out of X: carry it
    # as an input of its own
    cond_snaps = [] if cond_name in ext else \
        _snapshot_inputs(block, op, [cond_name], "WHILE_IN")
    need, ogs, igs, g2v = _grad_wiring(block, ext, ext, no_grad_set, og_avail)
    grad_op = {
        "type": "while_grad",
        "inputs": {"X": snaps, "Cond": cond_snaps, "OG": ogs},
        "outputs": {"IG": igs},
        "attrs": {"sub_block": op.attr("sub_block"),
                  "ext_names": ext, "cond_name": cond_name,
                  "max_trip_count": int(bound),
                  "need_grad": need},
    }
    return [grad_op], g2v


def _replay_ctx(ctx):
    """The context of a grad op's replay of a sub-block: the run's device,
    generator, runner and generator snapshots, and ``grad_replay`` set, so
    that a nested while runs at most its bound of trips."""
    sub_ctx = LoweringContext(ctx.device, ctx.generator, is_test=ctx.is_test,
                              block_runner=ctx.block_runner)
    sub_ctx.ctrl_rng = ctx.ctrl_rng
    sub_ctx.grad_replay = True
    return sub_ctx


class _ReplayRng(object):
    """Context manager of a replay: ``restore()`` sets the generator to the
    state the forward op saw (if the run recorded one); on exit the
    generator goes back to where the run had it."""

    def __init__(self, ctx, sub_block_idx):
        self.gen = ctx.generator
        self.snap = ctx.ctrl_rng.get(sub_block_idx)
        self.saved = None

    def __enter__(self):
        if self.gen is not None and self.snap is not None:
            self.saved = self.gen.get_state()
        return self

    def restore(self):
        if self.saved is not None:
            self.gen.set_state(self.snap)

    def __exit__(self, *exc):
        if self.saved is not None:
            self.gen.set_state(self.saved)
        return False


def _leaves(xs, need):
    """The replay's inputs: a detached leaf with grad for each input that
    needs a gradient."""
    vals = list(xs)
    leaves = {}
    for i, f in enumerate(need):
        if f and vals[i] is not None:
            vals[i] = leaves[i] = vals[i].detach().requires_grad_(True)
    return vals, leaves


def _input_grads(n, fin, ogs, leaves, poison=False):
    """torch.autograd.grad of the replay's outputs ``fin`` under their
    output grads ``ogs`` (an absent one is zero) with respect to
    ``leaves``; zeros for a leaf nothing reaches, NaN for every one when
    ``poison``."""
    outs, cots = [], []
    for o, g in zip(fin, ogs):
        if g is None or o is None or not o.requires_grad:
            continue
        outs.append(o)
        cots.append(torch.broadcast_to(g, o.shape).to(o.dtype))
    idx = sorted(leaves)
    grads = torch.autograd.grad(outs, [leaves[i] for i in idx], cots,
                                allow_unused=True) \
        if outs and idx else [None] * len(idx)
    igs = [None] * n
    for i, g in zip(idx, grads):
        g = torch.zeros_like(leaves[i]) if g is None else g
        igs[i] = torch.full_like(g, float("nan")) if poison else g
    return igs


def as_condition(v):
    return v.reshape(()).to(torch.bool)


@register_lowering("while_grad", no_grad=True)
def _while_grad(ctx, inputs, attrs):
    """Replay the loop from its snapshots with autograd on, at most
    max_trip_count trips, and differentiate; a condition that still holds
    after the bound (the forward ran more trips) poisons every input
    gradient with NaN."""
    sub = ctx.block_runner.program.block(attrs["sub_block"])
    ext = list(attrs["ext_names"])
    cond_name = attrs["cond_name"]
    bound = int(attrs["max_trip_count"])
    need = list(attrs["need_grad"])
    xs = inputs["X"]
    ogs = inputs.get("OG") or [None] * len(ext)
    cond_extra = inputs.get("Cond") or []
    cond_val = xs[ext.index(cond_name)] if cond_name in ext \
        else cond_extra[0]
    sub_ctx = _replay_ctx(ctx)
    with torch.enable_grad(), _ReplayRng(ctx, attrs["sub_block"]) as rng:
        vals, leaves = _leaves(xs, need)
        cond = as_condition(cond_val)
        for _ in range(bound):
            if not bool(cond):         # one host sync a trip
                break
            rng.restore()
            env = dict(zip(ext, vals))
            if cond_name not in ext:
                env[cond_name] = cond_val
            lower_op_list(sub.ops, env, sub_ctx)
            vals = [env[n] for n in ext]
            cond = as_condition(env[cond_name])
        poison = bool(cond)
        return {"IG": _input_grads(len(ext), vals, ogs, leaves, poison)}


@register_grad_maker("conditional_block", wants_og=True)
def _conditional_block_grad_maker(op, block, no_grad_set, og_avail=()):
    """Gradient of conditional_block (reference:
    controlflow/conditional_block_op.cc:147 ConditionalBlockGradOp): the
    grad op replays the block when its predicate held; the untaken branch
    passes each output's grad to the input of its name."""
    _check_nested_whiles_bounded(block.program,
                                 block.program.block(op.attr("sub_block")))
    ins = list(op.input("Input"))
    outs = list(op.output("Out"))
    conds = list(op.input("Cond"))
    snaps = _snapshot_inputs(block, op, ins, "COND_IN")
    cond_snaps = _snapshot_inputs(block, op, conds, "COND_IN") if conds \
        else []
    need, ogs, igs, g2v = _grad_wiring(block, ins, outs, no_grad_set,
                                       og_avail)
    grad_op = {
        "type": "conditional_block_grad",
        "inputs": {"Input": snaps, "Cond": cond_snaps, "OG": ogs},
        "outputs": {"IG": igs},
        "attrs": {"sub_block": op.attr("sub_block"),
                  "in_names": ins, "out_names": outs,
                  "need_grad": need},
    }
    return [grad_op], g2v


@register_lowering("conditional_block_grad", no_grad=True)
def _conditional_block_grad(ctx, inputs, attrs):
    sub = ctx.block_runner.program.block(attrs["sub_block"])
    in_names = list(attrs["in_names"])
    out_names = list(attrs["out_names"])
    need = list(attrs["need_grad"])
    xs = inputs["Input"]
    ogs = inputs.get("OG") or [None] * len(out_names)
    conds = inputs.get("Cond") or []
    taken = not conds or conds[0] is None or bool(as_condition(conds[0]))
    with torch.enable_grad(), _ReplayRng(ctx, attrs["sub_block"]) as rng:
        vals, leaves = _leaves(xs, need)
        env = dict(zip(in_names, vals))
        if taken:
            rng.restore()
            lower_op_list(sub.ops, env, _replay_ctx(ctx))
        fin = [env.get(n) for n in out_names]
        return {"IG": _input_grads(len(in_names), fin, ogs, leaves)}
