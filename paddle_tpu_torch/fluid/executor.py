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
  the grad op takes the gradient (XLA merged the JAX package's recomputed
  forward with the real one; ops/grad_ops.py); a grad op registered as
  paired (batch_norm_grad) gets its forward op's outputs the same way;
- a run of consecutive ops with a group lowering (the optimizer's adam ops,
  one per parameter) runs as one call, so its kernel launches once for the
  run (XLA fused the JAX package's per-op updates into one program).

``run_steps`` runs a training program over stacked feeds, one eager step
after another.

Host ops (``feed`` and ``fetch`` here; ``save`` and ``load`` in io.py) run
on the host through ``register_host_handler``, always, in their place in
the block, as the JAX executor runs them between its device segments.

``Executor()`` runs on ``CUDAPlace(0)`` and raises when there is no card;
the CPU is used only when the caller passes ``CPUPlace()``.
"""
import contextlib
import json
import zlib

import numpy as np
import torch

from . import framework
from .core_types import to_torch_dtype
from .framework import Variable, default_main_program
from .interop import tensor_from_numpy
from .ops.grad_ops import record_forward
from .ops.registry import (LoweringContext, group_key, is_host_op,
                           lower_group, lower_op, mark_host_op,
                           paired_forward)

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


def _pair_grad_ops(ops):
    """{index of a grad op: index of its forward op}. A ``grad_of`` op's
    forward op is the latest op before it, not yet paired, of its fwd_type,
    attrs and inputs; a paired grad op's (registry.register_paired_grad)
    the latest one, not yet paired, of its forward type with the same names
    in the shared input slots."""
    pairs, taken, keys = {}, set(), {}
    for i, op in enumerate(ops):
        if op.type == "grad_of":
            fwd_type = op.attrs["fwd_type"]
            fwd_in = {k[len("FWD_IN:"):]: list(v)
                      for k, v in op.inputs.items()
                      if k.startswith("FWD_IN:")}
            key = _attrs_key(op.attrs["fwd_attrs"])
            same = lambda f: dict(f.inputs) == fwd_in
        elif paired_forward(op.type) is not None:
            fwd_type, slots = paired_forward(op.type)
            fwd_in = {s: list(op.inputs.get(s, ())) for s in slots}
            key = None
            same = lambda f: all(list(f.inputs.get(s, ())) == v
                                 for s, v in fwd_in.items())
        else:
            continue
        for j in range(i - 1, -1, -1):
            f = ops[j]
            if j in taken or f.type != fwd_type or not same(f):
                continue
            if key is not None:
                if j not in keys:
                    keys[j] = _attrs_key(f.attrs)
                if keys[j] != key:
                    continue
            pairs[i] = j
            taken.add(j)
            break
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
    (ops/grad_ops.py): a kept grad op keeps its forward op. Runs of ops with
    a group lowering (``runs``: first step -> its steps) run as one call."""

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
                needed.update(n for n in op.input_arg_names if n != "@EMPTY@")
                if i in pairs:
                    forced.add(pairs[i])
        kept_idx.reverse()
        pos = {i: k for k, i in enumerate(kept_idx)}
        kept = [ops[i] for i in kept_idx]
        last_read = {}
        for i, op in enumerate(kept):
            for n in op.input_arg_names:
                last_read[n] = i
        keep = set(fetch_names)
        self.steps, self.live = [], []
        for k, op in enumerate(kept):
            touched = set(op.input_arg_names) | set(op.output_arg_names)
            drop = [n for n in touched
                    if n not in keep and last_read.get(n, -1) <= k]
            self.steps.append((op, drop))
            self.live.append(frozenset(
                slot for slot, names in op.outputs.items()
                if any(n in keep or persistable(n) or
                       last_read.get(n, -1) > k for n in names)))
        # step of a grad op -> step of its forward op; step of a taped
        # forward op -> the need_grad flags of its grad_of ({} for a paired
        # grad op, which reads the forward op's outputs and no gradient)
        self.grad_fwd = {pos[i]: pos[pairs[i]] for i in kept_idx
                         if i in pairs}
        self.taped = {pos[pairs[i]]: ops[i].attrs.get("need_grad", {})
                      for i in kept_idx if i in pairs}
        self.runs = _runs(kept, self.taped)
        self.in_run = {j for run in self.runs.values() for j in run[1:]}
        self.persistable = {n for op in kept for n in op.output_arg_names
                            if persistable(n)}
        self.host = {k for k, op in enumerate(kept) if is_host_op(op.type)}


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
        those of ``fetch_list``, as the JAX executor does."""
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
        ctx = LoweringContext(self.device, gen, is_test=is_test)
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
                    for n in plan.steps[j][0].input_arg_names:
                        if n not in env and n != "@EMPTY@":
                            env[n] = self._read_state(scope, n, block)
                ctx.live_outputs = plan.live[k]
                if len(run) > 1:
                    ctx.live_outputs = None
                    lower_group([plan.steps[j][0] for j in run], env, ctx)
                elif k in plan.taped:
                    tape[k] = record_forward(op, env, ctx, plan.taped[k])
                elif k in plan.grad_fwd:
                    ctx.record = tape.pop(plan.grad_fwd[k], None)
                    lower_op(op, env, ctx)
                    ctx.record = None
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
        executor's device."""
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
