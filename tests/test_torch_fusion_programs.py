"""The fused-op programs on the port against the JAX package, on the CPU:
tools/torch_fusion_programs.py's fused_stacked_lstm and its twin, fused_ctr
and its twin, fusion_chain, the stacked LSTM's folded request and
fused_resnet50's request.

- Each program gives the JAX package's op for op, main and startup, at the
  CPU tests' widths and at full widths.
- STEPS steps of each training program at narrow widths on both executors
  from the port's startup state, each step from the JAX executor's state
  before it: every op of the port's plan run on the JAX step's values of
  its inputs within 1e-4 of its largest JAX output, integers exactly
  (``torch_resnet_step.replay``); then the whole step, the loss within
  1e-5 relative and every gradient and persistable within 1e-4 of its
  largest JAX value; and STEPS free-running steps from the same start,
  each loss within 1e-5 relative.
- A fused program and its twin from one state (the twin's startup, the
  parameters carried by name): the same losses and parameters after each
  step, within 1e-6 (one product and the recurrences either way).
- The stacked LSTM's request with its first pair folded into
  fused_embedding_fc_lstm (W_emb · W_fc) gives the unfused request's
  probabilities within 1e-5, and the JAX package's folded request's.
- fused_resnet50: every conv of the narrow ResNet becomes a conv2d_fusion;
  the fused request gives the transpiled unfused one's probabilities
  within 1e-5, and the JAX package's fused request's from the same state
  within 1e-4.
"""
import functools
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.interop import tensor_from_numpy

import torch_resnet_step as step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = _load("torch_fusion_programs")

TOL = 1e-5
GRAD_TOL = 1e-4
TWIN_TOL = 1e-6
STEPS = 2
NAMES = sorted(tool.PROGRAMS)
TWINS = {"fused_stacked_lstm": "stacked_lstm", "fused_ctr": "ctr"}


def _build(fluid, name, widths="narrow"):
    build, _, narrow = tool.PROGRAMS[name]
    return build(fluid, **(narrow if widths == "narrow" else {}))


def _batch(name, k):
    _, batch, narrow = tool.PROGRAMS[name]
    return batch(k, **narrow)


@pytest.mark.parametrize("name,widths", [(n, w) for n in NAMES
                                         for w in ("narrow", "full")])
def test_program_is_op_for_op_the_jax_packages(name, widths):
    j, t = _build(jfluid, name, widths), _build(tfluid, name, widths)
    assert step.signature(j.main) == step.signature(t.main)
    assert step.signature(j.startup) == step.signature(t.startup)
    assert t.feeds == j.feeds
    types = {op.type for op in t.main.global_block().ops}
    fused = {"fused_stacked_lstm": {"fusion_lstm"},
             "fused_ctr": {"fused_embedding_seq_pool",
                           "fusion_seqpool_concat", "fusion_squared_mat_sub",
                           "fusion_repeated_fc_relu"},
             "fusion_chain": {"fused_elemwise_activation", "fusion_gru",
                              "fusion_seqconv_eltadd_relu",
                              "fusion_seqexpand_concat_fc",
                              "fusion_transpose_flatten_concat",
                              "conv2d_inception_fusion", "attention_lstm"}}
    assert fused.get(name, set()) <= types
    if name in TWINS.values():
        assert not any(t.startswith("fus") for t in types)


def _start_state(name):
    t = _build(tfluid, name)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(t.startup, scope=scope)
    return {v.name: tfluid.executor.as_numpy(scope.get(v.name))
            for v in t.main.global_block().vars.values()
            if v.persistable and scope.get(v.name) is not None}


def _inter(block):
    """The non-persistable outputs (a sequence_pool writes its MaxIndex
    only when it pools by MAX)."""
    return sorted({n for op in block.ops for slot, names in
                   op.outputs.items() for n in names
                   if n != "@EMPTY@" and not block.var(n).persistable and
                   not (op.type == "sequence_pool" and slot == "MaxIndex"
                        and op.attr("pooltype").upper() != "MAX")})


def _jax_scope(state):
    scope = jfluid.Scope()
    for n, v in state.items():
        scope.set(n, v.astype(np.int32) if v.dtype == np.int64 else v)
    return scope


@functools.lru_cache(maxsize=None)
def _jax_steps(name):
    """STEPS steps of the JAX executor from the port's start state: (that
    state, [(feed, the intermediates' values, the state after)])."""
    j = _build(jfluid, name)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    start = state = _start_state(name)
    jscope = _jax_scope(state)
    inter = _inter(j.main.global_block())
    steps = []
    for k in range(STEPS):
        feed = _batch(name, 10 + k)
        vals = dict(zip(inter, (np.asarray(v) for v in jexe.run(
            j.main, feed=feed, fetch_list=inter, scope=jscope))))
        state = {n: np.asarray(jscope.get(n)) for n in state}
        steps.append((feed, vals, state))
    return start, steps


def _within(got, want, tol):
    got, want = step.f64(got), step.f64(want)
    return np.abs(got - want.reshape(got.shape)).max() <= \
        tol * (np.abs(want).max() or 1.0)


@pytest.mark.parametrize("name", NAMES)
def test_ops_replay_on_the_jax_steps_values(name):
    t = _build(tfluid, name)
    state, steps = _jax_steps(name)
    block = t.main.global_block()
    for feed, vals, after in steps:
        errs = step.replay(t.main, [t.loss.name], feed, state, after, vals)
        assert {op.type for op in block.ops if op.type.startswith(
            "fus") or op.type == "attention_lstm"} <= \
            {ty for ty, _, _ in errs}
        for op_type, n, e in errs:
            if np.asarray(vals.get(n, after.get(n))).dtype.kind in "iub":
                assert e == 0.0, (op_type, n, e)
            else:
                assert e <= step.OP_TOL["float32"], (op_type, n, e)
        state = after


@pytest.mark.parametrize("name", NAMES)
def test_steps_in_lockstep_with_jax_executor(name):
    t = _build(tfluid, name)
    state, steps = _jax_steps(name)
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(t.startup, scope=tscope)
    params = [p.name for p in t.main.all_parameters() if p.trainable]
    grads = [n + "@GRAD" for n in params
             if t.main.global_block().has_var(n + "@GRAD")]
    assert grads
    for feed, vals, after in steps:
        tfluid.params_from_numpy(state, tscope, "cpu")
        got = texe.run(t.main, feed=feed, fetch_list=[t.loss.name] + grads,
                       scope=tscope)
        want = float(np.asarray(vals[t.loss.name]).reshape(-1)[0])
        assert abs(float(np.asarray(got[0]).reshape(-1)[0]) - want) <= \
            TOL * abs(want)
        for n, g in zip(grads, got[1:]):
            assert _within(g, vals[n], GRAD_TOL), n
        for n in state:
            assert _within(tfluid.executor.as_numpy(tscope.get(n)),
                           after[n], GRAD_TOL), n
        state = after


@pytest.mark.parametrize("name", NAMES)
def test_free_running_losses_match_the_jax_executor(name):
    t = _build(tfluid, name)
    state, steps = _jax_steps(name)
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(t.startup, scope=tscope)
    tfluid.params_from_numpy(state, tscope, "cpu")
    for feed, vals, _ in steps:
        want = float(np.asarray(vals[t.loss.name]).reshape(-1)[0])
        got = float(np.asarray(texe.run(t.main, feed=feed,
                                        fetch_list=[t.loss],
                                        scope=tscope)[0]).reshape(-1)[0])
        assert abs(got - want) <= TOL * abs(want)


@pytest.mark.parametrize("fused", sorted(TWINS))
def test_fused_program_trains_in_lockstep_with_its_twin(fused):
    """The twin's startup state runs both (the parameters share names):
    the same losses and parameters after each of 3 steps."""
    twin = TWINS[fused]
    f, u = _build(tfluid, fused), _build(tfluid, twin)
    assert sorted(p.name for p in f.main.all_parameters()) == \
        sorted(p.name for p in u.main.all_parameters())
    exe = tfluid.Executor(tfluid.CPUPlace())
    su, sf = tfluid.Scope(), tfluid.Scope()
    exe.run(u.startup, scope=su)
    exe.run(f.startup, scope=sf)
    for n in list(sf._vars):
        if su.get(n) is not None:
            sf.set(n, su.get(n).clone())
    for k in range(3):
        feed = _batch(fused, 20 + k)
        lu, = exe.run(u.main, feed=feed, fetch_list=[u.loss], scope=su)
        lf, = exe.run(f.main, feed=feed, fetch_list=[f.loss], scope=sf)
        assert abs(float(lf) - float(lu)) <= TWIN_TOL * abs(float(lu))
        for p in u.main.all_parameters():
            assert _within(tfluid.executor.as_numpy(sf.get(p.name)),
                           tfluid.executor.as_numpy(su.get(p.name)),
                           TWIN_TOL), p.name


def _request(fluid, fused, state):
    """The stacked LSTM's request from `state` (the folded one with
    FOLD computed in the scope): its probabilities."""
    w = tool.STACKED_NARROW
    r = tool.stacked_lstm_request(fluid, fused, **w)
    exe = fluid.Executor(fluid.CPUPlace())
    if fluid is tfluid:
        scope = tfluid.Scope()
        for n, v in state.items():
            scope.set(n, tensor_from_numpy(v))
    else:
        scope = _jax_scope(state)
    if fused:
        tool.fold_embedding_fc(scope)
    feed = tool.stacked_batch(40, **w)
    feed.pop("label")
    return np.asarray(exe.run(r.main, feed=feed, fetch_list=[r.out.name],
                              scope=scope)[0]), r


def test_folded_request_gives_the_unfused_requests_probabilities():
    state = _jax_steps("stacked_lstm")[1][-1][2]
    folded, r = _request(tfluid, True, state)
    types = [op.type for op in r.main.global_block().ops]
    assert types[0] == "fused_embedding_fc_lstm"
    assert types.count("fusion_lstm") == tool.STACKED_NARROW["layers"] - 1
    unfused, _ = _request(tfluid, False, state)
    assert _within(folded, unfused, TOL)
    jfolded, _ = _request(jfluid, True, state)
    assert _within(folded, jfolded, TOL)


def _resnet(fluid):
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    m = tool.fused_resnet50(fluid, exe, fluid.CPUPlace(), scope,
                            **tool.RESNET_NARROW)
    return m, exe, scope


def test_resnet_request_fuses_every_conv_and_keeps_its_values():
    m, exe, scope = _resnet(tfluid)
    block = m.main.global_block()
    unfused = m.extra["unfused"].global_block()
    convs = sum(op.type == "conv2d" for op in unfused.ops)
    assert m.extra["fused_ops"] == convs == \
        sum(op.type == "conv2d_fusion" for op in block.ops)
    acts = {op.attr("activation") for op in block.ops
            if op.type == "conv2d_fusion"}
    assert acts == {"relu", "identity"}
    assert any(op.input("ResidualData") for op in block.ops
               if op.type == "conv2d_fusion")
    assert "batch_norm" not in {op.type for op in block.ops}
    feed = tool.resnet_batch(3, **tool.RESNET_NARROW)
    got = exe.run(m.main, feed=feed, fetch_list=[m.out.name], scope=scope)[0]
    want = exe.run(m.extra["unfused"], feed=feed, fetch_list=[m.out.name],
                   scope=scope)[0]
    assert _within(got, want, TOL)
    jm, jexe, jscope = _resnet(jfluid)
    assert step.signature(jm.main) == step.signature(m.main)
    # the JAX package's fused request on the port's folded state
    for n, v in scope._vars.items():
        if v is not None and hasattr(v, "numpy"):
            jscope.set(n, tfluid.executor.as_numpy(v))
    jgot = jexe.run(jm.main, feed=feed, fetch_list=[m.out.name],
                    scope=jscope)[0]
    assert _within(got, np.asarray(jgot), GRAD_TOL)
