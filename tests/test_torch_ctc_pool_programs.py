"""The CTC and index-pooling slice's programs on the port against the JAX
package, on the CPU: tools/torch_ctc_pool_programs.py's crnn_ctc (with
its decode program), segnet_basic, spp_net and ctc_pool_chain.

- Each program gives the JAX package's op for op, main and startup, at the
  CPU tests' widths and (building only, but the chain) at its full widths;
  so does the CRNN's ``clone(for_test=True)`` decode program.
- STEPS steps of each at narrow widths on both executors from the port's
  startup state, each step from the JAX executor's state before it
  (``fluid.params_from_numpy``): every op
  of the port's plan run on the JAX step's values of its inputs within
  1e-4 of its largest JAX output, and exactly for every integer output
  (Mask, ctc_align's, the arg_max, mean_iou's counts) and every edit
  distance (``torch_resnet_step.replay``); the loss within 1e-5 relative;
  every gradient within 1e-5 of its largest JAX value; every persistable
  after the step (Momentum's and SGD's updates, the batch norms'
  statistics, the evaluator's and precision_recall's states) within 1e-5
  of its largest JAX value. Every gradient and velocity is held to its
  own size, as tests/torch_resnet_step.py holds the Momentum models'.
  The one exception: a convolution's bias that a batch_norm follows has a
  gradient of 0 by construction, which both packages give as the
  rounding of a sum that cancels; it, its velocity and the bias after the
  update are held within GRAD_FLOOR of the step's largest gradient
  (times the learning rate for the bias) of the JAX value.
  Then
  STEPS free-running steps of the port from the same start: each loss
  within 1e-5 of the JAX executor's.
- A decode request of the CRNN from the JAX state after a step: the
  decoded ids and lengths equal the JAX package's.
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


tool = _load("torch_ctc_pool_programs")

TOL = 1e-5
STEPS = 3
NAMES = sorted(tool.PROGRAMS)
# the ops whose outputs are integers, or integers held in float32
EXACT = {"max_pool2d_with_index": ("Mask",),
         "max_pool3d_with_index": ("Mask",), "ctc_align": None,
         "arg_max": None, "top_k": ("Indices",),
         "mean_iou": ("OutWrong", "OutCorrect"), "edit_distance": None}


def _build(fluid, name, widths="narrow"):
    build, _, narrow = tool.PROGRAMS[name]
    return build(fluid, **(narrow if widths == "narrow" else {}))


def _batch(name, k):
    _, batch, narrow = tool.PROGRAMS[name]
    return batch(k, **narrow)


# the chain at full widths only scales its data (the JAX shape inference
# of its 690 adaptive bins alone takes seconds); its structure, the
# uneven adaptive bins too, is held at narrow widths
@pytest.mark.parametrize("name,widths", [(n, "narrow") for n in NAMES] + [
    (n, "full") for n in NAMES if n != "ctc_pool_chain"])
def test_program_is_op_for_op_the_jax_packages(name, widths):
    j, t = _build(jfluid, name, widths), _build(tfluid, name, widths)
    assert step.signature(j.main) == step.signature(t.main)
    assert step.signature(j.startup) == step.signature(t.startup)
    assert len(t.main.blocks) == 1
    assert t.feeds == j.feeds
    if name == "crnn_ctc":
        assert step.signature(tool.crnn_decoder(j)) == \
            step.signature(tool.crnn_decoder(t))


def _inter(block):
    return sorted({n for op in block.ops for n in op.output_arg_names
                   if n != "@EMPTY@" and not block.var(n).persistable})


def _start_state(name):
    """The persistables after the port's startup on the CPU, as numpy:
    both executors start from them (the JAX startup draws other numbers,
    and compiling it costs seconds)."""
    t = _build(tfluid, name)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(t.startup, scope=scope)
    return {v.name: tfluid.executor.as_numpy(scope.get(v.name))
            for v in t.main.global_block().vars.values()
            if v.persistable and scope.get(v.name) is not None}


@functools.lru_cache(maxsize=None)
def _jax_steps(name):
    """STEPS steps of the JAX executor from the start state: (that state,
    and for each step its feed, the intermediates' values and the state
    after)."""
    j = _build(jfluid, name)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    start = state = _start_state(name)
    for n, v in state.items():
        jscope.set(n, v)
    inter = _inter(j.main.global_block())
    steps = []
    for k in range(STEPS):
        feed = _batch(name, 10 + k)
        vals = dict(zip(inter, (np.asarray(v) for v in jexe.run(
            j.main, feed=feed, fetch_list=inter, scope=jscope))))
        state = {n: np.asarray(jscope.get(n)) for n in state}
        steps.append((feed, vals, state))
    return start, steps


def _rel_max(got, want):
    got, want = step.f64(got), step.f64(want)
    return np.abs(got - want).max() / (np.abs(want).max() or 1.0)


def _cancelling_floors(program, vals, state):
    """{name: floor} for each convolution bias that a batch_norm follows:
    its gradient and its velocity GRAD_FLOOR of the step's largest
    gradient, the bias that floor times its learning rate."""
    block = program.global_block()
    params = {p.name for p in program.all_parameters()}
    bn_inputs = {op.input("X")[0] for op in block.ops
                 if op.type == "batch_norm"}
    biases = {op.input("Y")[0] for op in block.ops
              if op.type == "elementwise_add" and op.output("Out")[0] in
              bn_inputs and op.input("Y")[0] in params}
    floor = step.GRAD_FLOOR * max(
        np.abs(step.f64(vals[p.name + "@GRAD"])).max()
        for p in program.all_parameters() if p.trainable)
    floors = {}
    for op in block.ops:
        if op.type == "momentum" and op.input("Param")[0] in biases:
            p = op.input("Param")[0]
            lr = op.input("LearningRate")[0]
            rate = np.abs(step.f64(vals[lr] if lr in vals else state[lr]))
            floors.update({p + "@GRAD": floor, op.input("Grad")[0]: floor,
                           op.input("Velocity")[0]: floor,
                           p: floor * float(rate.max())})
    return floors


def _within(got, want, tol, floor=None):
    """|got - want| within tol of want's size, or within `floor`."""
    got, want = step.f64(got), step.f64(want)
    if floor is not None:
        return np.abs(got - want).max() <= floor
    return np.abs(got - want).max() <= tol * (np.abs(want).max() or 1.0)


def _exact_outputs(program):
    block = program.global_block()
    return {n for op in block.ops if op.type in EXACT
            for slot, names in op.outputs.items()
            if EXACT[op.type] is None or slot in EXACT[op.type]
            for n in names}


@pytest.mark.parametrize("name", NAMES)
def test_steps_in_lockstep_with_jax_executor(name):
    t = _build(tfluid, name)
    state, steps = _jax_steps(name)
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(t.startup, scope=tscope)
    params = [p.name for p in t.main.all_parameters() if p.trainable]
    grads = [n + "@GRAD" for n in params]
    exact = _exact_outputs(t.main)
    for feed, vals, after in steps:
        floors = _cancelling_floors(t.main, vals, state)
        tfluid.params_from_numpy(state, tscope, "cpu")
        got = texe.run(t.main, feed=feed, fetch_list=[t.loss.name] + grads,
                       scope=tscope)
        errs = step.replay(t.main, [t.loss.name, t.out.name] +
                           sorted(exact), feed, state, after, vals)
        assert exact <= {n for _, n, _ in errs}
        for op_type, n, e in errs:
            if n in exact:
                assert e == 0.0, (op_type, n, e)
                continue
            want = np.abs(step.f64(after.get(n, vals.get(n)))).max()
            if n in floors:
                assert e * want <= floors[n], (op_type, n, e)
            else:
                assert e <= step.OP_TOL["float32"], (op_type, n, e)
        want = float(vals[t.loss.name])
        assert abs(float(got[0]) - want) <= TOL * abs(want)
        for n, g in zip(grads, got[1:]):
            assert _within(g, vals[n], TOL, floors.get(n)), n
        for n in state:
            assert _within(tscope.get(n), after[n], TOL, floors.get(n)), n
        state = after


@pytest.mark.parametrize("name", NAMES)
def test_free_running_losses_match_the_jax_executor(name):
    t = _build(tfluid, name)
    state, steps = _jax_steps(name)
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(t.startup, scope=tscope)
    tfluid.params_from_numpy(state, tscope, "cpu")
    for k, (feed, vals, _) in enumerate(steps):
        want = float(vals[t.loss.name])
        got = float(np.asarray(texe.run(t.main, feed=feed,
                                        fetch_list=[t.loss],
                                        scope=tscope)[0]))
        assert abs(got - want) <= TOL * abs(want), (k, got, want)


def test_crnn_decode_request_matches_jax():
    """The for_test program fed images alone, from the JAX state after a
    step: the decoded ids and lengths equal the JAX package's."""
    j = _build(jfluid, "crnn_ctc")
    t = _build(tfluid, "crnn_ctc")
    _, steps = _jax_steps("crnn_ctc")
    state = steps[0][2]
    feed = {"pixel": _batch("crnn_ctc", 30)["pixel"]}
    fetch = [j.out.name, j.extra["decoded_length"].name]
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    for n, v in state.items():
        jscope.set(n, v)
    want = jexe.run(tool.crnn_decoder(j), feed=feed, fetch_list=fetch,
                    scope=jscope)
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(t.startup, scope=tscope)
    tfluid.params_from_numpy(state, tscope, "cpu")
    got = texe.run(tool.crnn_decoder(t), feed=feed, fetch_list=fetch,
                   scope=tscope)
    b, frames = tool.CRNN_NARROW["batch"], tool.crnn_frames(
        tool.CRNN_NARROW)[0]
    assert got[0].shape == (b, frames) and got[1].shape == (b,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
