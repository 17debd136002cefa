"""The programs of tools/torch_tensor_programs.py on the port against the
JAX package, on the CPU.

- fc_gan (examples/fc_gan.py's D and G programs over one startup) and
  tensor_chain (at NARROW widths, float32 and bfloat16) are op for op the
  JAX package's, main and startup.
- Three steps of each in lockstep with the JAX executor, each from the
  JAX executor's state before it (``fluid.params_from_numpy``): every op
  of the port's plan on the JAX step's values of its inputs
  (tests/torch_resnet_step.py's ``replay``) within 1e-4 of its largest
  JAX output in float32 (the repo's op limit), exact for the ops that move
  or pick values, and the whole step's loss within 1e-5 relative, the
  Adam parameters off by no more than the two gradients' difference
  explains (``adam_param_misses``). In bfloat16, tensor_chain op by op
  within 2^-6 (the repo's bf16 op limit).
- parameter_list: the D step leaves G's four parameters bit for bit as
  they were and the G step D's; a D optimizer without parameter_list (the
  control) moves G's.
- tensor_chain's gradient through gather and scatter(overwrite=False) is
  the same bits in two runs.
"""
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid

import torch_resnet_step as step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_tensor_programs", os.path.join(ROOT, "tools",
                                          "torch_tensor_programs.py"))
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)

TOL = 1e-5
STEPS = 3
# the forward ops whose every output must equal the JAX value
EXACT_OPS = {"split", "stack", "unstack", "concat", "reverse", "pad", "crop",
             "squeeze2", "unsqueeze2", "expand", "reshape2", "multiplex",
             "gather", "pad2d", "shuffle_channel", "space_to_depth",
             "pad_constant_like", "fill_constant",
             "fill_constant_batch_size_like"}


def _state(jscope, program):
    return {v.name: np.asarray(jscope.get(v.name))
            for v in program.global_block().vars.values()
            if v.persistable and jscope.get(v.name) is not None}


def _startups(jstartup, tstartup):
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    texe.run(tstartup, scope=tscope)
    return (jexe, jscope), (texe, tscope)


def _lockstep(jmain, tmain, jloss, tloss, jscope, tscope, jexe, texe, feed,
              op_tol, exact=True):
    """One step of both executors from the JAX executor's state: the ops
    replayed on the JAX values, the port's whole step; returns the op
    errors."""
    block = tmain.global_block()
    state = _state(jscope, jmain)
    tfluid.params_from_numpy(state, tscope, "cpu")
    inter = sorted({n for op in block.ops for n in op.output_arg_names
                    if n != "@EMPTY@" and not block.var(n).persistable})
    params = [p.name for p in tmain.all_parameters() if p.trainable
              and any(op.type == "adam" and op.input("Param")[0] == p.name
                      for op in block.ops)]
    grads = [p + "@GRAD" for p in params]
    vals = dict(zip(inter, (np.asarray(v) for v in jexe.run(
        jmain, feed=feed, fetch_list=inter, scope=jscope))))
    after = _state(jscope, jmain)
    errs = step.replay(tmain, [tloss.name], feed, state, after, vals)
    worst = max(errs, key=lambda e: e[2])
    assert worst[2] <= op_tol, worst
    if exact:
        types = {n: op.type for op in block.ops
                 for n in op.output_arg_names}
        checked = 0
        for t, n, e in errs:
            if t in EXACT_OPS and types.get(n) == t:
                assert e == 0.0, (t, n, e)
                checked += 1
        assert checked
    got = texe.run(tmain, feed=feed, fetch_list=[tloss.name] + grads,
                   scope=tscope)
    want = float(vals[tloss.name])
    assert abs(float(got[0]) - want) <= TOL * abs(want)
    got_after = {n: tscope.get(n) for n in after}
    misses = step.adam_param_misses(
        tmain, state, got_after, after, dict(zip(grads, got[1:])),
        {g: vals[g] for g in grads})
    assert sorted(misses) == sorted(params)
    assert sum(misses.values()) == 0, misses
    return errs


# --------------------------------------------------------------------------
# fc_gan
# --------------------------------------------------------------------------

def test_fc_gan_is_op_for_op_the_jax_packages():
    jg, tg = tool.fc_gan(jfluid), tool.fc_gan(tfluid)
    for j, t in [(jg.startup, tg.startup), (jg.d_main, tg.d_main),
                 (jg.g_main, tg.g_main)]:
        assert step.signature(j) == step.signature(t)
    types = [op.type for op in tg.d_main.global_block().ops]
    assert types.count("fill_constant_batch_size_like") == 2
    assert types.count("adam") == 4
    g_adam = [op.input("Param")[0] for op in tg.g_main.global_block().ops
              if op.type == "adam"]
    assert sorted(g_adam) == sorted(tool.G_PARAMS)


def test_fc_gan_steps_in_lockstep_with_jax_executor():
    jg, tg = tool.fc_gan(jfluid), tool.fc_gan(tfluid)
    (jexe, jscope), (texe, tscope) = _startups(jg.startup, tg.startup)
    for k in range(STEPS):
        d_feed, g_feed = tool.gan_batch(10 + k)
        for jmain, tmain, jl, tl, feed in [
                (jg.d_main, tg.d_main, jg.d_loss, tg.d_loss, d_feed),
                (jg.g_main, tg.g_main, jg.g_loss, tg.g_loss, g_feed)]:
            _lockstep(jmain, tmain, jl, tl, jscope, tscope, jexe, texe,
                      feed, step.OP_TOL["float32"])


def _moved(gan, main, loss, feed):
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(gan.startup, scope=scope)
    before = {n: scope.get(n).clone() for n in tool.D_PARAMS +
              tool.G_PARAMS}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return {n: not np.array_equal(scope.get(n).numpy(), before[n].numpy())
            for n in before}


def test_fc_gan_steps_keep_off_the_other_nets_parameters():
    gan = tool.fc_gan(tfluid)
    d_feed, g_feed = tool.gan_batch(1)
    moved = _moved(gan, gan.d_main, gan.d_loss, d_feed)
    assert all(moved[n] for n in tool.D_PARAMS)
    assert not any(moved[n] for n in tool.G_PARAMS)
    moved = _moved(gan, gan.g_main, gan.g_loss, g_feed)
    assert all(moved[n] for n in tool.G_PARAMS)
    assert not any(moved[n] for n in tool.D_PARAMS)
    control = tool.fc_gan(tfluid, d_parameter_list=None)
    moved = _moved(control, control.d_main, control.d_loss, d_feed)
    assert all(moved[n] for n in tool.G_PARAMS)


# --------------------------------------------------------------------------
# tensor_chain
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_chain_is_op_for_op_the_jax_packages(dtype):
    j = tool.tensor_chain(jfluid, dtype=dtype, **tool.NARROW)
    t = tool.tensor_chain(tfluid, dtype=dtype, **tool.NARROW)
    assert step.signature(j.main) == step.signature(t.main)
    assert step.signature(j.startup) == step.signature(t.startup)
    types = {op.type for op in t.main.global_block().ops}
    assert {"split", "stack", "unstack", "reverse", "pad", "crop",
            "unsqueeze2", "squeeze2", "expand", "multiplex", "gather",
            "scatter", "pad2d", "conv2d", "shuffle_channel",
            "space_to_depth", "pad_constant_like", "adam"} <= types
    fwd = {op.attrs["fwd_type"] for op in t.main.global_block().ops
           if op.type == "grad_of"}
    assert {"split", "stack", "unstack", "reverse", "pad", "crop",
            "expand", "multiplex", "gather", "scatter", "pad2d",
            "shuffle_channel", "space_to_depth",
            "pad_constant_like"} <= fwd


def test_tensor_chain_at_its_widths():
    """The full-width program: its op count, and the three fc weights (the
    [512, 512] head and the two [768, 768]) among the Adam kernel's 2-D
    parameters."""
    t = tool.tensor_chain(tfluid)
    block = t.main.global_block()
    assert len(block.ops) == 103
    params = {p.name: p.shape for p in t.main.all_parameters()}
    assert sorted(s for s in params.values() if len(s) == 2) == \
        [(512, 512), (768, 768), (768, 768)]
    assert block.var("maps_scale").shape == (256,)
    assert (64, 1024, 28, 28) in {block.var(op.output("Out")[0]).shape
                                  for op in block.ops
                                  if op.type == "space_to_depth"}


def test_tensor_chain_steps_in_lockstep_with_jax_executor():
    j = tool.tensor_chain(jfluid, dtype="float32", **tool.NARROW)
    t = tool.tensor_chain(tfluid, dtype="float32", **tool.NARROW)
    (jexe, jscope), (texe, tscope) = _startups(j.startup, t.startup)
    for k in range(STEPS):
        errs = _lockstep(j.main, t.main, j.loss, t.loss, jscope, tscope,
                         jexe, texe, tool.chain_batch(k, **tool.NARROW),
                         step.OP_TOL["float32"])
    assert {"gather", "scatter", "multiplex"} <= {e[0] for e in errs}


def test_bf16_tensor_chain_op_by_op_matches_jax_executor():
    j = tool.tensor_chain(jfluid, **tool.NARROW)
    t = tool.tensor_chain(tfluid, **tool.NARROW)
    (jexe, jscope), _ = _startups(j.startup, t.startup)
    feed = tool.chain_batch(0, **tool.NARROW)
    block = t.main.global_block()
    inter = sorted({n for op in block.ops for n in op.output_arg_names
                    if n != "@EMPTY@" and not block.var(n).persistable})
    state = _state(jscope, j.main)
    vals = dict(zip(inter, (np.asarray(v) for v in jexe.run(
        j.main, feed=feed, fetch_list=inter, scope=jscope))))
    errs = step.replay(t.main, [t.loss.name], feed, state,
                       _state(jscope, j.main), vals)
    worst = max(errs, key=lambda e: e[2])
    assert worst[2] <= step.OP_TOL["bfloat16"], worst


def test_gather_and_scatter_add_gradients_are_the_same_bits_twice():
    t = tool.tensor_chain(tfluid, dtype="float32", **tool.NARROW)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(t.startup, scope=scope)
    state = {n: scope.get(n).clone() for n in scope._vars
             if scope.get(n) is not None}
    block = t.main.global_block()
    gather, = [op for op in block.ops if op.type == "gather"]
    scatter_add, = [op for op in block.ops if op.type == "scatter"
                    and not op.attrs["overwrite"]]
    names = [gather.input("X")[0] + "@GRAD",
             scatter_add.input("Updates")[0] + "@GRAD"]
    feed = tool.chain_batch(4, **tool.NARROW)
    runs = []
    for _ in range(2):
        run = tfluid.Scope()
        for n, v in state.items():
            run.set(n, v.clone())
        runs.append(exe.run(t.main, feed=feed, fetch_list=names, scope=run))
    for a, b in zip(*runs):
        assert np.abs(a).max() > 0
        np.testing.assert_array_equal(a, b)
