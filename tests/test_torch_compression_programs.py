"""The compression slice's programs on the port against the JAX package, on
the CPU: tools/torch_compression_programs.py's qat_resnet (with its frozen
request, the int8 Calibrator and the int8 model), slim_resnet (with the
Compressor's pruning), srl_chunk_eval (with the tagging requests scored by
both ChunkEvaluators) and compression_chain.

- Each program gives the JAX package's op for op, main and startup (and
  the frozen request, the teacher and the tagging program), at the CPU
  tests' widths and at full widths.
- STEPS steps of each at narrow widths on both executors from the port's
  startup state, each step from the JAX executor's state before it
  (``fluid.params_from_numpy``): every op of the port's plan run on the
  JAX step's values of its inputs within 1e-4 of its largest JAX output,
  and exactly for every integer output and every quantized value (the
  fake quantizers' and the channel-wise quantizer's Out, the pair counts;
  ``torch_resnet_step.replay``); the batch norms' scale and bias
  gradients, which cancel to rounding noise, to CANCEL times the JAX
  value's error against numpy's float64 sums (as in
  tests/test_torch_detection_programs.py). Then the whole step: the loss
  within 1e-5 relative, every gradient and persistable within 1e-5 of its
  largest JAX value or CANCEL times the JAX value's error against the JAX
  package's step in float64 (``torch_resnet_step.jax_float64_errors``),
  and STEPS free-running steps from the same start, each loss within 1e-5.
- 8-bit round trips are discontinuous: a value an ulp from a half step
  rounds apart in two runs that differ by rounding, and at these widths
  one such value moves a whole QAT step's gradients by up to 22%. So
  qat_resnet's whole runs (the step, the free-running losses, the frozen
  request, the calibration and the int8 model) are compared at FINE_BITS
  (24) round trips, where a value rounding apart moves by 2**-23 of its
  scale; the 8-bit program is held op by op.
- The int8 path at FINE_BITS from the JAX state after a step: the
  Calibrator's sampled names and ranges, the int8 weights exactly, the
  scales, the saved model read back by both packages, its request.
- slim_resnet: ``Compressor.run`` with ``PruneStrategy(0.5)`` over two
  batches from the same state: the masks, the pruned and trained weights
  and the sparsity as the JAX package's.
- srl_chunk_eval: four tagging requests from the JAX state after a step,
  scored by ``evaluator.ChunkEvaluator`` (states after each request,
  ``eval``) and by ``metrics.ChunkEvaluator`` fed the fetched counts: the
  JAX package's.
"""
import functools
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

import torch_resnet_step as step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tool = _load("torch_compression_programs")

TOL = 1e-5
STEPS = 2
CANCEL = 4.0
NAMES = sorted(tool.PROGRAMS)
# the outputs of these op types hold quantized values or counts
EXACT_OPS = {"fake_quantize_abs_max", "fake_channel_wise_quantize_abs_max",
             "positive_negative_pair", "chunk_eval", "hash", "quantize"}
# the programs that train batch norms
BATCH_NORMS = {"qat_resnet", "slim_resnet"}
FINE = dict(tool.QAT_NARROW, bits=tool.FINE_BITS)
REQUESTS = 4


def _widths(name, fine=False):
    narrow = tool.PROGRAMS[name][2]
    return FINE if fine and name == "qat_resnet" else narrow


def _build(fluid, name, widths="narrow", fine=False):
    build = tool.PROGRAMS[name][0]
    return build(fluid, **(_widths(name, fine) if widths == "narrow"
                           else {}))


def _batch(name, k):
    _, batch, narrow = tool.PROGRAMS[name]
    return batch(k, **narrow)


def _extra_programs(m, fluid):
    out = []
    if "teacher" in m.extra:
        out += [m.extra["teacher"].main, m.extra["teacher"].startup]
    if "tagger" in m.extra:
        out += [m.extra["tagger"].main, m.extra["tagger"].startup]
    if "transpiler" in m.extra:
        out.append(tool.infer_program(fluid, m))
    return out


@pytest.mark.parametrize("name,widths", [(n, w) for n in NAMES
                                         for w in ("narrow", "full")])
def test_program_is_op_for_op_the_jax_packages(name, widths):
    j, t = _build(jfluid, name, widths), _build(tfluid, name, widths)
    assert step.signature(j.main) == step.signature(t.main)
    assert step.signature(j.startup) == step.signature(t.startup)
    assert len(t.main.blocks) == 1
    assert t.feeds == j.feeds
    for jp, tp in zip(_extra_programs(j, jfluid),
                      _extra_programs(t, tfluid)):
        assert step.signature(jp) == step.signature(tp)


def test_qat_puts_one_round_trip_on_each_distinct_input_and_weight():
    """104 at ResNet-50 (54 weights, 50 inputs: a block's first conv and
    its shortcut share theirs), 18 at the narrow resnet_cifar10; every
    forward conv2d and mul reads a round trip's output."""
    for widths, want in (("full", 104), ("narrow", 18)):
        m = _build(tfluid, "qat_resnet", widths)
        assert m.extra["round_trips"] == want
        block = m.main.global_block()
        made = {op.output("Out")[0] for op in block.ops
                if op.type == "fake_quantize_dequantize_abs_max"}
        for op in block.ops:
            if op.type in ("conv2d", "mul") and op.attr("op_role") == 0:
                slots = ("Input", "Filter") if op.type == "conv2d" \
                    else ("X", "Y")
                assert all(op.input(s)[0] in made for s in slots)


def _start_state(name, fine=False):
    """The persistables after the port's startup on the CPU (with the
    teacher's under their merged names), as numpy."""
    t = _build(tfluid, name, fine=fine)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(t.startup, scope=scope)
    return {v.name: tfluid.executor.as_numpy(scope.get(v.name))
            for v in t.main.global_block().vars.values()
            if v.persistable and scope.get(v.name) is not None}


def _inter(block):
    return sorted({n for op in block.ops for n in op.output_arg_names
                   if n != "@EMPTY@" and not block.var(n).persistable})


def _jax_scope(state):
    scope = jfluid.Scope()
    for n, v in state.items():
        # int64 as the JAX executor keeps it (int32, x64 off)
        scope.set(n, v.astype(np.int32) if v.dtype == np.int64 else v)
    return scope


@functools.lru_cache(maxsize=None)
def _jax_steps(name, fine=False):
    """STEPS steps of the JAX executor from the start state: (that state,
    and for each step its feed, the intermediates' values and the state
    after)."""
    j = _build(jfluid, name, fine=fine)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    start = state = _start_state(name, fine)
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


@functools.lru_cache(maxsize=None)
def _noise(name, fine=False):
    start, steps = _jax_steps(name, fine)
    return step.jax_float64_errors(_build(jfluid, name, fine=fine), start,
                                   steps)


def _exact_outputs(program, vals):
    """The outputs held exactly: integers, and every output of EXACT_OPS."""
    block = program.global_block()
    return {n for op in block.ops for n in op.output_arg_names
            if n in vals and np.asarray(vals[n]).size and (
                np.asarray(vals[n]).dtype.kind in "iub" or
                op.type in EXACT_OPS)}


def _within(got, want, tol, noise=0.0):
    got, want = step.f64(got), step.f64(want)
    bound = max(tol, CANCEL * noise) * (np.abs(want).max() or 1.0)
    return np.abs(got - want).max() <= bound


@pytest.mark.parametrize("name", NAMES)
def test_ops_replay_on_the_jax_steps_values(name):
    t = _build(tfluid, name)
    state, steps = _jax_steps(name)
    cancelling = step.bn_gradients(t.main)
    assert bool(cancelling) == (name in BATCH_NORMS)
    for feed, vals, after in steps:
        exact = _exact_outputs(t.main, vals)
        assert bool(exact) == (name != "slim_resnet")
        bn_noise = step.bn_gradient_noise(t.main, vals)
        errs = step.replay(t.main, [t.loss.name] + sorted(exact), feed,
                           state, after, vals)
        assert exact <= {n for _, n, _ in errs}
        for op_type, n, e in errs:
            if n in exact:
                assert e == 0.0, (op_type, n, e)
            else:
                limit = CANCEL * bn_noise.get(n, 0.0)
                assert e <= max(step.OP_TOL["float32"], limit), (
                    op_type, n, e, limit)
        state = after


@pytest.mark.parametrize("name", NAMES)
def test_steps_in_lockstep_with_jax_executor(name):
    """The whole step from the JAX state before it (qat_resnet at
    FINE_BITS)."""
    fine = name == "qat_resnet"
    t = _build(tfluid, name, fine=fine)
    state, steps = _jax_steps(name, fine)
    noises = _noise(name, fine)[0] if name in BATCH_NORMS else \
        [{}] * STEPS
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(t.startup, scope=tscope)
    params = [p.name for p in t.main.all_parameters() if p.trainable]
    grads = [n + "@GRAD" for n in params
             if t.main.global_block().has_var(n + "@GRAD")]
    assert grads
    for (feed, vals, after), noise in zip(steps, noises):
        tfluid.params_from_numpy(state, tscope, "cpu")
        got = texe.run(t.main, feed=feed, fetch_list=[t.loss.name] + grads,
                       scope=tscope)
        want = float(np.asarray(vals[t.loss.name]).reshape(-1)[0])
        assert abs(float(np.asarray(got[0]).reshape(-1)[0]) - want) <= \
            TOL * abs(want)
        for n, g in zip(grads, got[1:]):
            assert _within(g, vals[n], TOL, noise.get(n, 0.0)), n
        for n in state:
            assert _within(tscope.get(n), after[n], TOL,
                           noise.get(n, 0.0)), n
        state = after


@pytest.mark.parametrize("name", NAMES)
def test_free_running_losses_match_the_jax_executor(name):
    fine = name == "qat_resnet"
    t = _build(tfluid, name, fine=fine)
    state, steps = _jax_steps(name, fine)
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(t.startup, scope=tscope)
    tfluid.params_from_numpy(state, tscope, "cpu")
    wides = _noise(name, fine)[1] if name in BATCH_NORMS else \
        [None] * STEPS
    for k, ((feed, vals, _), wide) in enumerate(zip(steps, wides)):
        want = float(np.asarray(vals[t.loss.name]).reshape(-1)[0])
        got = float(np.asarray(texe.run(t.main, feed=feed,
                                        fetch_list=[t.loss],
                                        scope=tscope)[0]).reshape(-1)[0])
        noise = abs(want - wide) / abs(want) if k and wide else 0.0
        assert abs(got - want) <= max(TOL, CANCEL * noise) * abs(want), (
            k, got, want, wide)


# ---- qat_resnet's request, calibration and int8 model ----------------------

def _trained(name, fine):
    """The JAX state after the first step."""
    return _jax_steps(name, fine)[1][0][2]


def test_frozen_8_bit_request_replays_on_the_jax_values():
    """The frozen 8-bit program (is_test: the batch norms' running
    statistics) replayed op by op on the JAX request's values."""
    j, t = _build(jfluid, "qat_resnet"), _build(tfluid, "qat_resnet")
    ji, ti = tool.infer_program(jfluid, j), tool.infer_program(tfluid, t)
    state = {n: v for n, v in _trained("qat_resnet", False).items()
             if ti.global_block().has_var(n)}
    feed = {"img": tool.qat_batch(30, **tool.QAT_NARROW)["img"]}
    inter = _inter(ji.global_block())
    vals = dict(zip(inter, (np.asarray(v) for v in jfluid.Executor(
        jfluid.CPUPlace()).run(ji, feed=feed, fetch_list=inter,
                               scope=_jax_scope(state)))))
    errs = step.replay(ti, [t.out.name], feed, state, state, vals)
    trips = {n for op in ti.global_block().ops for n in op.output_arg_names
             if op.type == "fake_quantize_dequantize_abs_max"}
    assert trips <= {n for _, n, _ in errs}
    worst = max(errs, key=lambda e: e[2])
    assert worst[2] <= step.OP_TOL["float32"], worst


def _calibrate(fluid, m, state, dirname):
    """Freeze, calibrate over the calibration batches, save the int8
    model into `dirname`, load it back: (the Calibrator, the converted
    program, the float request's logits, the loaded model's logits, the
    loaded int8 persistables)."""
    exe = fluid.Executor(fluid.CPUPlace())
    infer = tool.infer_program(fluid, m)
    scope = fluid.Scope()
    if fluid is tfluid:
        exe.run(m.startup, scope=scope)
        tfluid.params_from_numpy({n: v for n, v in state.items()
                                  if scope.get(n) is not None}, scope, "cpu")
    else:
        scope = _jax_scope(state)
    feed = {"img": tool.qat_batch(40, **FINE)["img"]}
    logits = np.asarray(exe.run(infer, feed=feed, fetch_list=[m.out.name],
                                scope=scope)[0])
    cal = fluid.contrib.Calibrator(
        program=infer, exe=exe, feed_var_names=["img"],
        fetch_list=[infer.global_block().var(m.out.name)], scope=scope)
    for k in range(FINE["calib_batches"]):
        cal.sample_data(tool.calib_batch(50 + k, **FINE))
    with fluid.scope_guard(scope):
        cal.save_int8_model(dirname)
    loaded = fluid.Scope()
    with fluid.scope_guard(loaded):
        prog, feeds, fetches = fluid.io.load_inference_model(dirname, exe)
        out = np.asarray(exe.run(prog, feed=feed, fetch_list=fetches,
                                 scope=loaded)[0])
    int8 = {n: np.asarray(fluid.executor.as_numpy(loaded.get(n))
                          if fluid is tfluid else loaded.get(n))
            for n in loaded._vars if n.endswith("@INT8")}
    return cal, infer, logits, out, int8, prog


def test_calibrated_int8_model_matches_jax(tmp_path):
    j, t = _build(jfluid, "qat_resnet", fine=True), \
        _build(tfluid, "qat_resnet", fine=True)
    state = _trained("qat_resnet", True)
    jcal, jprog, jlog, jout, jint8, jload = _calibrate(
        jfluid, j, state, str(tmp_path / "jax"))
    tcal, tprog, tlog, tout, tint8, tload = _calibrate(
        tfluid, t, state, str(tmp_path / "port"))
    assert list(tcal._ranges) == list(jcal._ranges)
    assert 0 < len(tcal._ranges) <= 256
    for n, v in jcal._ranges.items():
        assert abs(tcal._ranges[n] - v) <= TOL * v, n
    assert set(tprog._dist_attrs["int8_scales"]) == \
        set(jprog._dist_attrs["int8_scales"])
    assert step.signature(tprog) == step.signature(jprog)
    assert set(tint8) == set(jint8) and len(tint8) == 10
    for n in jint8:
        assert tint8[n].dtype == np.int8
        np.testing.assert_array_equal(tint8[n], jint8[n], n)
    assert step.signature(tload) == step.signature(jload)
    assert _within(tlog, jlog, TOL)
    assert _within(tout, jout, TOL)
    # the int8 model is the float model within its weights' rounding
    assert _within(tout, tlog, 0.05)


def test_each_package_serves_the_others_int8_model(tmp_path):
    """The int8 artifact is the JAX package's format: the port loads the
    JAX package's and gives the logits the JAX package gives of its own,
    and the other way round."""
    state = _trained("qat_resnet", True)
    j, t = _build(jfluid, "qat_resnet", fine=True), \
        _build(tfluid, "qat_resnet", fine=True)
    _, _, _, jout, _, _ = _calibrate(jfluid, j, state, str(tmp_path / "j"))
    _, _, _, tout, _, _ = _calibrate(tfluid, t, state, str(tmp_path / "t"))
    feed = {"img": tool.qat_batch(40, **FINE)["img"]}
    for fluid, dirname, want in ((tfluid, "j", jout), (jfluid, "t", tout)):
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            prog, _, fetches = fluid.io.load_inference_model(
                str(tmp_path / dirname), exe)
            got = exe.run(prog, feed=feed, fetch_list=fetches)[0]
        assert _within(got, want, TOL), dirname


# ---- slim_resnet's Compressor ----------------------------------------------

def _compress(fluid, m, state):
    exe = fluid.Executor(fluid.CPUPlace())
    if fluid is tfluid:
        scope = tfluid.Scope()
        exe.run(m.startup, scope=scope)
        tfluid.params_from_numpy(state, scope, "cpu")
    else:
        scope = _jax_scope(state)
    w = tool.SLIM_NARROW
    batches = [tool.slim_batch(60 + k, **w)
               for k in range(w["reader_batches"])]
    strat = fluid.contrib.slim.PruneStrategy(
        target_ratio=w["prune_ratio"], params=m.extra["student_params"])
    comp = fluid.contrib.Compressor(
        fluid.CPUPlace(), scope, m.main, train_reader=lambda: iter(batches),
        train_feed_list=["img"], train_fetch_list=[m.loss])
    comp.strategies = [strat]
    final = comp.run()
    weights = {n: np.asarray(fluid.executor.as_numpy(scope.get(n))
                             if fluid is tfluid else scope.get(n))
               for n in strat.masks}
    return strat, weights, fluid.contrib.slim.sparsity(scope, strat.masks), \
        final


def test_compressor_prunes_as_the_jax_package():
    state = _jax_steps("slim_resnet")[0]
    j, t = _build(jfluid, "slim_resnet"), _build(tfluid, "slim_resnet")
    jstrat, jw, jsp, jfinal = _compress(jfluid, j, state)
    tstrat, tw, tsp, tfinal = _compress(tfluid, t, state)
    assert set(tstrat.masks) == set(jstrat.masks) == \
        {n for n in t.extra["student_params"] if state[n].ndim >= 2}
    for n, mask in jstrat.masks.items():
        np.testing.assert_array_equal(tstrat.masks[n], mask, n)
        assert (tw[n][mask == 0] == 0).all()
        assert _within(tw[n], jw[n], TOL), n
    assert tsp == jsp
    assert abs(tsp - tool.SLIM_NARROW["prune_ratio"]) < 0.01
    assert step.signature(tfinal) == step.signature(jfinal)


# ---- srl_chunk_eval's tagging requests --------------------------------------

def test_tagging_requests_score_chunks_as_jax():
    j, t = _build(jfluid, "srl_chunk_eval"), _build(tfluid, "srl_chunk_eval")
    state = _trained("srl_chunk_eval", False)
    runs = {}
    for fluid, m in ((jfluid, j), (tfluid, t)):
        exe = fluid.Executor(fluid.CPUPlace())
        tagger, ev = m.extra["tagger"], m.extra["evaluator"]
        scope = fluid.Scope()
        if fluid is tfluid:
            exe.run(m.startup, scope=scope)
            tfluid.params_from_numpy(state, scope, "cpu")
        else:
            scope = _jax_scope(state)
        exe.run(tagger.startup, scope=scope)
        metric = fluid.metrics.ChunkEvaluator()
        out = []
        with fluid.scope_guard(scope):
            ev.reset(exe)
            for k in range(REQUESTS):
                f = tool.srl_batch(70 + k, **tool.SRL_NARROW)
                got = exe.run(tagger.main, feed=f, fetch_list=[
                    tagger.out] + ev.metrics + m.extra["counts"],
                    scope=scope)
                metric.update(*got[-3:])
                out.append(([np.asarray(v) for v in got],
                            [float(np.asarray(s).sum()) for s in (
                                scope.get(v.name) for v in ev.states)],
                            [float(v[0]) for v in ev.eval(exe)],
                            metric.eval()))
        runs[fluid] = out
    for (jv, js, je, jm), (tv, ts, te, tm) in zip(runs[jfluid],
                                                  runs[tfluid]):
        np.testing.assert_array_equal(tv[0], jv[0])
        for g, w in zip(tv[1:], jv[1:]):
            np.testing.assert_allclose(g, w, rtol=1e-6)
        assert ts == js and te == je and tm == jm
    assert 0 < runs[tfluid][-1][2][2] < 1
