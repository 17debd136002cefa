"""Executor: runs a Program's block 0 eagerly, op by op, on one torch.device.

The port's counterpart of ``paddle_tpu/fluid/executor.py``. Where the JAX
executor traces the block into one jitted XLA function, this one walks the
ops and calls each op's PyTorch lowering on the executor's device. What XLA
did for free is done here by a per-(program, fetch list) plan:

- only the ops that the fetches or a persistable write need are run
  (XLA's dead-code elimination);
- each intermediate is dropped after its last reader, so a long request
  holds only its live activations (XLA's buffer liveness);
- a training program's forward ops run once: each ``grad_of`` op is paired
  with its forward op, which runs under autograd and keeps its record until
  its last grad op takes the gradient (XLA merged the JAX package's
  recomputed forward with the real one; ops/grad_ops.py); a grad op
  registered as paired (batch_norm_grad) gets its forward op's outputs the
  same way. A forward op may have a grad op for each backward pass over it
  (append_backward and calc_gradient on one forward);
- a run of consecutive ops with a group lowering (the optimizer's adam ops,
  one per parameter) runs as one call, so its kernel launches once for the
  run (XLA fused the JAX package's per-op updates into one program).

``run_steps`` runs a training program over stacked feeds, one eager step
after another.

Host ops (``feed``, ``fetch`` and ``print`` here; ``save`` and ``load`` in
io.py) run on the host through ``register_host_handler``, always, in their
place in the block, as the JAX executor runs them between its device
segments.

Control flow (``_BlockRunner``, the JAX executor's ``_BlockLowerer``): a
while op runs its sub-block a trip at a time on a child env and reads its
condition on the host once a trip (one device-to-host sync a trip); a
conditional_block reads its predicate on the host and runs its sub-block
or passes its outputs through. Every trip of a while draws what the first
drew (the generator is set back at each trip), as the JAX package's body,
traced once, does. The plan counts what a sub-block reads, and a
``write_to_array`` op reads the array it writes.

``Executor()`` runs on ``CUDAPlace(0)`` and raises when there is no card;
the CPU is used only when the caller passes ``CPUPlace()``.
"""
import contextlib
import itertools
import json
import zlib

import numpy as np
import torch

from . import flags, framework
from .core_types import to_torch_dtype
from .framework import Variable, default_main_program
from .interop import tensor_from_numpy
from .ops.control_ops import NESTED_BOUND_MESSAGE, as_condition
from .ops.grad_ops import record_forward
from .ops.registry import (CONTROL_OPS, LoweringContext, fold_const,
                           group_key, is_host_op, lower_group, lower_op,
                           lower_op_list, mark_host_op, paired_forward)

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "as_numpy",
           "register_host_handler"]


class Scope(object):
    """name -> runtime value (torch tensor) (reference: framework/scope.h:48),
    plus the random streams of the programs run in it."""

    def __init__(self):
        self._vars = {}
        self._generators = {}   # (program fingerprint, device) -> Generator

    def var(self, name):
        """Create (or get) a slot."""
        self._vars.setdefault(name, None)
        return _VarHandle(self, name)

    def find_var(self, name):
        return _VarHandle(self, name) if name in self._vars else None

    def get(self, name):
        return self._vars.get(name)

    def has(self, name):
        return self._vars.get(name) is not None

    def set(self, name, value):
        self._vars[name] = value

    def erase(self, names):
        """Drop the values of `names` (absent names are skipped)."""
        for n in names:
            self._vars.pop(n, None)


class _VarHandle(object):
    """The reference pybind Variable handle surface (get_tensor etc.)."""

    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def get_tensor(self):
        return self

    def set(self, value, place=None):
        self._scope.set(self._name, value if isinstance(value, torch.Tensor)
                        else tensor_from_numpy(np.asarray(value)))

    def value(self):
        return self._scope.get(self._name)

    def __array__(self, dtype=None):
        v = as_numpy(self._scope.get(self._name))
        return v.astype(dtype) if dtype else v

    def shape(self):
        return list(self._scope.get(self._name).shape)


_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope():
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


def as_numpy(value):
    """Host numpy copy of a tensor. numpy has no bfloat16, so a bf16 tensor
    comes back as float32 (exact: every bf16 value is a float32 value)."""
    if not isinstance(value, torch.Tensor):
        return np.asarray(value)
    value = value.detach().cpu()
    if value.dtype == torch.bfloat16:
        value = value.float()
    return value.numpy()


# host-side op handlers: op type -> fn(executor, op, state), where state is
# the run's _RunState
_HOST_HANDLERS = {}


def register_host_handler(op_type):
    def deco(fn):
        _HOST_HANDLERS[op_type] = fn
        mark_host_op(op_type)
        return fn
    return deco


class _RunState(object):
    """What a host op of one run() sees: the run's values (env), its feed
    dict, scope and program, and the values its fetch ops collected."""

    def __init__(self, env, feed, scope, program):
        self.env = env
        self.feed = feed
        self.scope = scope
        self.program = program
        self.fetch_results = []


@register_host_handler("feed")
def _handle_feed(exe, op, st):
    out = op.output("Out")[0]
    if out not in st.feed:
        raise ValueError("feed op output %r missing from feed dict" % out)


@register_host_handler("fetch")
def _handle_fetch(exe, op, st):
    st.fetch_results.append(exe._fetch(st.env, st.scope, op.input("X")[0]))


@register_host_handler("print")
def _handle_print(exe, op, st):
    name = op.input("In")[0]
    val = st.env.get(name, st.scope.get(name))
    print("%s %s %s" % (op.attr("message", ""), name, as_numpy(val)))
    outs = op.output("Out")
    if outs:
        st.env[outs[0]] = val


class _BlockRunner(object):
    """Runs the sub-block of a while or conditional_block op (registry
    ``lower_op`` hands it the op) eagerly on a child env of the run's
    values; a name the sub-block writes reaches the outer env only as an
    output of the op (a while's X, a conditional_block's Out)."""

    def __init__(self, program):
        self.program = program

    def run_control_op(self, op, env, ctx):
        if op.type == "while":
            self._while(op, env, ctx)
        else:
            self._conditional_block(op, env, ctx)

    @staticmethod
    def _snapshot(ctx, op):
        state = ctx.generator.get_state() if ctx.generator is not None \
            else None
        ctx.ctrl_rng[op.attr("sub_block")] = state
        return state

    def _while(self, op, env, ctx):
        """The carried names are the op's X that hold a value; a condition
        the body does not carry comes back a 0-d bool. In a grad op's
        replay a nested
        while runs at most its max_trip_count trips, and a condition that
        still holds after them makes its floating carries NaN (the JAX
        executor's multiplicative poison)."""
        sub = self.program.block(op.attr("sub_block"))
        cond_name = op.input("Condition")[0]
        ext = [n for n in op.input("X") if n in env]
        bound = None
        if ctx.grad_replay:
            bound = int(op.attr("max_trip_count") or 0)
            if not bound:
                raise NotImplementedError(NESTED_BOUND_MESSAGE)
        state = self._snapshot(ctx, op)
        vals = [env[n] for n in ext]
        cond = as_condition(env[cond_name])
        trips = 0
        while (bound is None or trips < bound) and bool(cond):
            if state is not None:
                ctx.generator.set_state(state)
            inner = dict(env)
            inner.update(zip(ext, vals))
            lower_op_list(sub.ops, inner, ctx)
            vals = [inner[n] for n in ext]
            cond = as_condition(inner[cond_name])
            trips += 1
        if bound is not None and bool(cond):
            vals = [v * float("nan") if isinstance(v, torch.Tensor) and
                    v.is_floating_point() else v for v in vals]
        env[cond_name] = cond
        env.update(zip(ext, vals))

    def _conditional_block(self, op, env, ctx):
        """Run the sub-block when the predicate holds (or there is none);
        else each output keeps its value, zeros of the sub-block's shape
        for an output that has none yet."""
        sub = self.program.block(op.attr("sub_block"))
        self._snapshot(ctx, op)
        conds = op.input("Cond")
        outs = op.output("Out")
        if not conds or bool(as_condition(env[conds[0]])):
            inner = dict(env)
            lower_op_list(sub.ops, inner, ctx)
            env.update((n, inner[n]) for n in outs)
            return
        missing = [n for n in outs if n not in env]
        if missing:
            meta = {n: v.to("meta") if isinstance(v, torch.Tensor) else v
                    for n, v in env.items()}
            mctx = LoweringContext("meta", block_runner=self)
            mctx.const_env = dict(ctx.const_env)
            lower_op_list(sub.ops, meta, mctx)
            for n in missing:
                env[n] = torch.zeros(meta[n].shape, dtype=meta[n].dtype,
                                     device=ctx.device)


def _sub_block_reads(program, idx):
    """Every name an op of block ``idx`` or of a block nested in it reads
    (an array that write_to_array extends among them)."""
    names = []
    for op in program.block(idx).ops:
        names.extend(_op_reads(op, program))
    return names


def _op_reads(op, program):
    """The names op reads: its inputs, the array a write_to_array op
    extends, and what the sub-block of a control op reads."""
    names = [n for n in op.input_arg_names if n != "@EMPTY@"]
    if op.type == "write_to_array":
        names.extend(op.output_arg_names)
    if op.type in CONTROL_OPS:
        names.extend(_sub_block_reads(program, op.attr("sub_block")))
    return names


def _fetch_names(fetch_list):
    return [v.name if isinstance(v, Variable) else str(v)
            for v in (fetch_list or [])]


def _program_rng_fp(program):
    """Structural fingerprint keying a program's random stream in a scope
    (the same string the JAX executor builds)."""
    return "|".join("%s>%s" % (op.type, ",".join(
        n for ns in op.outputs.values() for n in ns))
        for b in program.blocks for op in b.ops)


def _attrs_key(attrs):
    return json.dumps(attrs, sort_keys=True, default=repr)


def _grad_bases(names):
    """The forward variables that gradient names ``<var>@GRAD...`` belong
    to."""
    return {n.split("@GRAD")[0] for n in names if "@GRAD" in n}


def _pair_grad_ops(ops):
    """{index of a grad op: index of its forward op}. The candidates for a
    ``grad_of`` op are the ops before it of its fwd_type, attrs and inputs;
    for a paired grad op (registry.register_paired_grad) the ops before it
    of its forward type with the same names in the shared input slots. Of
    them the grad op takes the latest that writes a variable whose gradient
    it reads (``<out>@GRAD...``: two copies of one op on one input keep
    their own grad ops), else the latest. A forward op may have any number
    of grad ops: one for each append_backward or calc_gradient that walks
    through it."""
    pairs, keys, by_inputs = {}, {}, {}
    for i, op in enumerate(ops):
        if op.type == "grad_of":
            fwd_type = op.attrs["fwd_type"]
            slots = tuple(sorted(k[len("FWD_IN:"):] for k in op.inputs
                                 if k.startswith("FWD_IN:")))
            fwd_in = tuple(tuple(op.inputs["FWD_IN:" + s]) for s in slots)
            attrs = _attrs_key(op.attrs["fwd_attrs"])
            bases = _grad_bases(n for k, ns in op.inputs.items()
                                if k.startswith("OG:") for n in ns)
        elif paired_forward(op.type) is not None:
            fwd_type, slots = paired_forward(op.type)
            fwd_in = tuple(tuple(op.inputs.get(s, ())) for s in slots)
            attrs = None
            bases = _grad_bases(n for k, ns in op.inputs.items()
                                if k not in slots for n in ns)
        else:
            continue
        # the ops of fwd_type by their names in `slots` (a grad_of's
        # forward op has no other input slot)
        exact = attrs is not None
        index = by_inputs.get((fwd_type, slots, exact))
        if index is None:
            index = by_inputs[(fwd_type, slots, exact)] = {}
            for j, f in enumerate(ops):
                if f.type == fwd_type and \
                        (not exact or set(f.inputs) == set(slots)):
                    index.setdefault(tuple(tuple(f.inputs.get(s, ()))
                                           for s in slots), []).append(j)
        found = None
        for j in reversed(index.get(fwd_in, ())):
            if j >= i:
                continue
            if attrs is not None:
                if j not in keys:
                    keys[j] = _attrs_key(ops[j].attrs)
                if keys[j] != attrs:
                    continue
            if found is None:
                found = j
            if bases & set(ops[j].output_arg_names):
                found = j
                break
        if found is not None:
            pairs[i] = found
    return pairs


def _runs(ops, taped):
    """{step of a run's first op: the steps of the run}: each maximal run
    (two ops or more) of consecutive ops of one type with a group lowering
    and one run key (registry.group_key), none taped, where no name that one
    op of the run writes is read or written by another."""
    runs, k = {}, 0
    while k < len(ops):
        key = group_key(ops[k]) if k not in taped else None
        run = [k]
        if key is not None:
            written = set(ops[k].output_arg_names)
            touched = set(ops[k].input_arg_names) | written
            j = k + 1
            while j < len(ops) and j not in taped and \
                    ops[j].type == ops[k].type and group_key(ops[j]) == key:
                ins, outs = set(ops[j].input_arg_names), \
                    set(ops[j].output_arg_names)
                if (ins | outs) & written or outs & touched:
                    break
                written |= outs
                touched |= ins | outs
                run.append(j)
                j += 1
        if len(run) > 1:
            runs[k] = run
        k = run[-1] + 1
    return runs


class _Plan(object):
    """The ops a run must execute (every host op among them), for each op
    the output slots that a later op or a fetch reads or that are
    persistable (a lowering may skip the others), and after each op the
    names no later op or fetch reads. A plan for run_steps (``steps``)
    leaves the feed and fetch ops out and refuses any other host op. Each
    ``grad_of`` op is paired with its forward op, which the run tapes
    (ops/grad_ops.py): a kept grad op keeps its forward op, and a forward op
    with several grad ops is taped once for all of them. Runs of ops with a
    group lowering (``runs``: first step -> its steps) run as one call."""

    def __init__(self, program, fetch_names, steps=False):
        block = program.global_block()
        self.rng_fp = _program_rng_fp(program)

        def persistable(n):
            meta = block.vars.get(n)
            return meta is not None and meta.persistable

        ops = block.ops
        if steps:
            ops = [op for op in ops if op.type not in ("feed", "fetch")]
            host = sorted({op.type for op in ops if is_host_op(op.type)})
            if host:
                raise NotImplementedError(
                    "run_steps cannot cross host op(s) %s; use run()" % host)
        pairs = _pair_grad_ops(ops)
        needed = set(fetch_names)
        forced, kept_idx = set(), []
        for i in range(len(ops) - 1, -1, -1):
            op = ops[i]
            if i in forced or is_host_op(op.type) or \
                    any(o in needed or persistable(o)
                        for o in op.output_arg_names):
                kept_idx.append(i)
                needed.update(_op_reads(op, program))
                if i in pairs:
                    forced.add(pairs[i])
        kept_idx.reverse()
        pos = {i: k for k, i in enumerate(kept_idx)}
        kept = [ops[i] for i in kept_idx]
        reads = [_op_reads(op, program) for op in kept]
        keep = set(fetch_names)
        # walking back: does the next op after step k that touches a name
        # read it? A name written again before any read (a second backward
        # pass's h@GRAD, an in-place increment) is dead in between
        read_next = {}
        steps, live = [], []
        for k in range(len(kept) - 1, -1, -1):
            op = kept[k]
            needed_after = lambda n: n in keep or read_next.get(n, False)
            touched = set(reads[k]) | set(op.output_arg_names)
            steps.append((op, [n for n in touched if not needed_after(n)]))
            live.append(frozenset(
                slot for slot, names in op.outputs.items()
                if any(needed_after(n) or persistable(n) for n in names)))
            read_next.update(dict.fromkeys(op.output_arg_names, False))
            read_next.update(dict.fromkeys(reads[k], True))
        self.steps, self.live = steps[::-1], live[::-1]
        self.reads = reads
        # step of a grad op -> step of its forward op; step of a taped
        # forward op -> the union of its grad_of ops' need_grad flags ({}
        # for a paired grad op, which reads the forward op's outputs and no
        # gradient) and the step of its last grad op, which frees the record
        self.grad_fwd = {pos[i]: pos[pairs[i]] for i in kept_idx
                         if i in pairs}
        self.taped, self.last_grad = {}, {}
        for k, f in sorted(self.grad_fwd.items()):
            flags = self.taped.setdefault(f, {})
            for slot, fl in kept[k].attrs.get("need_grad", {}).items():
                had = flags.get(slot, [])
                flags[slot] = [a or b for a, b in itertools.zip_longest(
                    had, fl, fillvalue=False)]
            self.last_grad[f] = k
        self.runs = _runs(kept, self.taped)
        self.in_run = {j for run in self.runs.values() for j in run[1:]}
        self.persistable = {n for op in kept for n in op.output_arg_names
                            if persistable(n)}
        self.host = {k for k, op in enumerate(kept) if is_host_op(op.type)}
        # what FLAGS_check_nan_inf scans: the names the run writes (in
        # program order) that end in the scope or in the fetches
        self.written = list(dict.fromkeys(
            n for op in kept for n in op.output_arg_names if n != "@EMPTY@"))
        self.fetched = set(fetch_names) | {
            op.input("X")[0] for op in kept if op.type == "fetch"}

    def record_for(self, tape, k):
        """(the forward record that grad step k reads, whether a later grad
        op reads it too): the last grad op of a forward op takes the record
        off ``tape``, and frees its graph; an earlier one leaves both."""
        f = self.grad_fwd[k]
        if self.last_grad[f] == k:
            return tape.pop(f, None), False
        return tape.get(f), True


class Executor(object):
    """Reference surface: Executor(place).run(program, feed, fetch_list, ...)
    (reference: python/paddle/fluid/executor.py:262,451), and run_steps."""

    def __init__(self, place=None):
        self.place = place if place is not None else framework.CUDAPlace(0)
        if self.place.kind == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "%r needs a CUDA card and torch.cuda.is_available() is "
                "False; pass fluid.CPUPlace() to run on the CPU" % self.place)
        self.device = self.place.torch_device()
        self._plans = {}
        # the reference's FLAGS_check_nan_inf scan (operator.cc:963); may be
        # set by hand
        self.check_nan_inf = flags.get("check_nan_inf")

    def _plan(self, program, fetch_names, steps=False):
        key = (program.id, program.version, tuple(fetch_names), steps)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = _Plan(program, fetch_names, steps)
        return plan

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True):
        """Run ``program`` once. Returns the values of its fetch ops (a
        program loaded by io.load_inference_model has them) followed by
        those of ``fetch_list``, as the JAX executor does. With
        ``check_nan_inf`` set (FLAGS_check_nan_inf) a non-finite value
        among those the run wrote to the scope or fetched raises
        FloatingPointError."""
        if program is None:
            program = default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = _fetch_names(fetch_list)
        block = program.global_block()
        plan = self._plan(program, fetch_names)
        env = {n: self._to_device(v, block.vars.get(n))
               for n, v in (feed or {}).items()}
        gen = self._generator(scope, program, plan.rng_fp)
        st = _RunState(env, feed or {}, scope, program)
        self._run_step(plan, env, scope, block, gen, program._is_test, st)
        if self.check_nan_inf:
            self._check_finite(plan, env, scope)
        results = st.fetch_results + [self._fetch(env, scope, n)
                                      for n in fetch_names]
        if return_numpy:
            results = [as_numpy(r) for r in results]
        return results

    def run_steps(self, program=None, feed=None, n_steps=1, fetch_list=None,
                  scope=None, return_numpy=True):
        """Run ``program`` ``n_steps`` times, one training step after
        another: every feed is stacked on a leading [n_steps] axis and
        moved to the device once, step i reads slice i, each step draws
        from the run's generator, and the parameters, moments and beta
        powers in the scope are updated after every step. Fetches come
        back stacked the same way. The step loop runs eagerly on the host.
        A program's feed and fetch ops are skipped; any other host op
        cannot run inside the loop: use run()."""
        if program is None:
            program = default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = _fetch_names(fetch_list)
        block = program.global_block()
        plan = self._plan(program, fetch_names, steps=True)
        stacked = {}
        for name, value in (feed or {}).items():
            shape = tuple(value.shape) if hasattr(value, "shape") \
                else np.shape(value)
            if not shape or shape[0] != n_steps:
                raise ValueError(
                    "run_steps feed %r must be stacked [n_steps, ...]; got "
                    "shape %s for n_steps %d" % (name, shape, n_steps))
            stacked[name] = self._to_device(value, block.vars.get(name))
        gen = self._generator(scope, program, plan.rng_fp)
        per_step = []
        for i in range(n_steps):
            env = {n: v[i] for n, v in stacked.items()}
            self._run_step(plan, env, scope, block, gen, program._is_test)
            # a fetched state tensor may be updated in place next step
            per_step.append([
                v.clone() if n in plan.persistable or scope.has(n) else v
                for n, v in ((n, self._fetch(env, scope, n))
                             for n in fetch_names)])
        results = [torch.stack([s[j] for s in per_step])
                   for j in range(len(fetch_names))]
        if return_numpy:
            results = [as_numpy(r) for r in results]
        return results

    def _run_step(self, plan, env, scope, block, gen, is_test, st=None):
        """Run the plan once on env; taped forward ops keep their autograd
        record until their grad_of consumes it, each run of grouped ops
        goes through its group lowering in one call, and each host op
        through its handler on the run's state ``st``."""
        ctx = LoweringContext(self.device, gen, is_test=is_test,
                              block_runner=_BlockRunner(block.program))
        tape = {}
        with torch.no_grad():
            for k, (op, drop) in enumerate(plan.steps):
                if k in plan.in_run:
                    continue
                run = plan.runs.get(k, (k,))
                if k in plan.host:
                    handler = _HOST_HANDLERS.get(op.type)
                    if handler is None:
                        raise NotImplementedError(
                            "host op %r has no handler" % op.type)
                    handler(self, op, st)
                    for n in drop:
                        env.pop(n, None)
                    continue
                for j in run:
                    op_j = plan.steps[j][0]
                    fold_const(op_j, ctx)
                    if op_j.type in CONTROL_OPS:
                        # a carried name may have no value yet
                        for n in plan.reads[j]:
                            if n not in env and scope.has(n):
                                env[n] = self._read_state(scope, n, block)
                        continue
                    for n in op_j.input_arg_names:
                        if n not in env and n != "@EMPTY@":
                            env[n] = self._read_state(scope, n, block)
                ctx.live_outputs = plan.live[k]
                if len(run) > 1:
                    ctx.live_outputs = None
                    lower_group([plan.steps[j][0] for j in run], env, ctx)
                elif k in plan.taped:
                    tape[k] = record_forward(op, env, ctx, plan.taped[k])
                elif k in plan.grad_fwd:
                    ctx.record, ctx.retain_graph = plan.record_for(tape, k)
                    lower_op(op, env, ctx)
                    ctx.record, ctx.retain_graph = None, False
                else:
                    lower_op(op, env, ctx)
                for j in run:
                    op_j, drop_j = plan.steps[j]
                    for n in op_j.output_arg_names:
                        if n in env and (n in plan.persistable or
                                         scope.has(n)):
                            scope.set(n, env[n])
                    for n in drop_j:
                        env.pop(n, None)

    @staticmethod
    def _check_finite(plan, env, scope):
        """FLAGS_check_nan_inf after a run: the floating values that the run
        wrote to the scope or fetched, screened by one sum of |x| a tensor
        on the device (NaN and Inf carry through a sum; the tensors grouped
        by dtype) and one host sync; a tensor the screen flags is checked
        exactly, and the first non-finite one in program order raises
        FloatingPointError, as the JAX executor's scan does. run_steps does
        not scan, as in the JAX package."""
        names, values = [], []
        for n in plan.written:
            if n in plan.fetched or n in plan.persistable or scope.has(n):
                v = env.get(n)
                v = scope.get(n) if v is None else v
                if isinstance(v, torch.Tensor) and v.is_floating_point() \
                        and v.numel():
                    names.append(n)
                    values.append(v.detach())
        if not values:
            return
        groups = {}
        for i, v in enumerate(values):
            groups.setdefault(v.dtype, []).append(i)
        order = [i for idx in groups.values() for i in idx]
        sums = torch.cat([torch.stack(torch._foreach_norm(
            [values[i] for i in idx], 1)).float()
            for idx in groups.values()])
        finite = torch.isfinite(sums).cpu().tolist()     # the one sync
        for i in sorted(i for i, ok in zip(order, finite) if not ok):
            if not bool(torch.isfinite(values[i]).all()):
                raise FloatingPointError(
                    "NaN/Inf detected in variable %r after segment run"
                    % names[i])

    @staticmethod
    def _fetch(env, scope, name):
        v = env.get(name)
        if v is None:
            v = scope.get(name)
        if v is None:
            raise ValueError(
                "fetch variable %r was not produced by the program and is "
                "not in the scope" % name)
        return v.detach()

    def _read_state(self, scope, name, block):
        v = scope.get(name)
        if v is None:
            raise RuntimeError(
                "variable %r is not initialized (feed it or run the startup "
                "program first)" % name)
        moved = self._to_device(v, block.vars.get(name))
        if moved is not v:
            scope.set(name, moved)
        return moved

    def _to_device(self, value, var_meta):
        """A feed or state value as a tensor of the variable's dtype on the
        executor's device (a LoDTensor feeds its packed rows, as in the JAX
        executor)."""
        if hasattr(value, "recursive_sequence_lengths"):
            value = np.asarray(value)
        if not isinstance(value, torch.Tensor):
            value = tensor_from_numpy(np.asarray(value))
        dtype = value.dtype
        if var_meta is not None and var_meta.dtype is not None:
            dtype = to_torch_dtype(var_meta.dtype)
        return value.to(device=self.device, dtype=dtype)

    def _generator(self, scope, program, fp):
        """One random stream per (scope, program structure, device): the
        seed comes from the program's random_seed or its structure `fp`,
        never from a global stream, and each run advances only its own
        stream."""
        key = (fp, str(self.device))
        gen = scope._generators.get(key)
        if gen is None:
            seed = program.random_seed or (zlib.crc32(fp.encode()) & 0x7FFFFFFF)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            scope._generators[key] = gen
        return gen
