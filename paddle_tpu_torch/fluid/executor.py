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
  forward with the real one; ops/grad_ops.py).

``run_steps`` runs a training program over stacked feeds, one eager step
after another.

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
from .ops.registry import LoweringContext, lower_op, is_host_op

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "as_numpy"]


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
    """{index of a grad_of op: index of its forward op}: the latest forward
    op before it, not yet paired, of the same type, attrs and inputs."""
    pairs, taken, keys = {}, set(), {}
    for i, op in enumerate(ops):
        if op.type != "grad_of":
            continue
        fwd_in = {k[len("FWD_IN:"):]: list(v) for k, v in op.inputs.items()
                  if k.startswith("FWD_IN:")}
        key = _attrs_key(op.attrs["fwd_attrs"])
        for j in range(i - 1, -1, -1):
            f = ops[j]
            if j in taken or f.type != op.attrs["fwd_type"] or \
                    dict(f.inputs) != fwd_in:
                continue
            if j not in keys:
                keys[j] = _attrs_key(f.attrs)
            if keys[j] == key:
                pairs[i] = j
                taken.add(j)
                break
    return pairs


class _Plan(object):
    """The ops a run must execute, for each op the output slots that a later
    op or a fetch reads or that are persistable (a lowering may skip the
    others), and after each op the names no later op or fetch reads. Each
    ``grad_of`` op is paired with its forward op, which the run tapes
    (ops/grad_ops.py): a kept grad op keeps its forward op."""

    def __init__(self, program, fetch_names):
        block = program.global_block()
        self.rng_fp = _program_rng_fp(program)

        def persistable(n):
            meta = block.vars.get(n)
            return meta is not None and meta.persistable

        ops = block.ops
        pairs = _pair_grad_ops(ops)
        needed = set(fetch_names)
        forced, kept_idx = set(), []
        for i in range(len(ops) - 1, -1, -1):
            op = ops[i]
            if i in forced or any(o in needed or persistable(o)
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
        # step of a grad_of -> step of its forward op; step of a taped
        # forward op -> the need_grad flags of its grad_of
        self.grad_fwd = {pos[i]: pos[pairs[i]] for i in kept_idx
                         if i in pairs}
        self.taped = {pos[pairs[i]]: ops[i].attrs["need_grad"]
                      for i in kept_idx if i in pairs}
        self.persistable = {n for op in kept for n in op.output_arg_names
                            if persistable(n)}
        self.host_ops = sorted({op.type for op in kept
                                if is_host_op(op.type)})


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

    def _plan(self, program, fetch_names):
        key = (program.id, program.version, tuple(fetch_names))
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = _Plan(program, fetch_names)
        return plan

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True):
        if program is None:
            program = default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = _fetch_names(fetch_list)
        block = program.global_block()
        plan = self._plan(program, fetch_names)
        env = {n: self._to_device(v, block.vars.get(n))
               for n, v in (feed or {}).items()}
        gen = self._generator(scope, program, plan.rng_fp)
        self._run_step(plan, env, scope, block, gen, program._is_test)
        results = [self._fetch(env, scope, n) for n in fetch_names]
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
        Host ops cannot run inside the loop: use run()."""
        if program is None:
            program = default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = _fetch_names(fetch_list)
        block = program.global_block()
        plan = self._plan(program, fetch_names)
        if plan.host_ops:
            raise NotImplementedError(
                "run_steps cannot cross host op(s) %s; use run()"
                % plan.host_ops)
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

    def _run_step(self, plan, env, scope, block, gen, is_test):
        """Run the plan once on env; taped forward ops keep their autograd
        record until their grad_of consumes it."""
        ctx = LoweringContext(self.device, gen, is_test=is_test)
        tape = {}
        with torch.no_grad():
            for k, (op, drop) in enumerate(plan.steps):
                for n in op.input_arg_names:
                    if n not in env and n != "@EMPTY@":
                        env[n] = self._read_state(scope, n, block)
                ctx.live_outputs = plan.live[k]
                if k in plan.taped:
                    tape[k] = record_forward(op, env, ctx, plan.taped[k])
                elif op.type == "grad_of":
                    ctx.record = tape.pop(plan.grad_fwd.get(k), None)
                    lower_op(op, env, ctx)
                    ctx.record = None
                else:
                    lower_op(op, env, ctx)
                for n in op.output_arg_names:
                    if n in env and (n in plan.persistable or scope.has(n)):
                        scope.set(n, env[n])
                for n in drop:
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
