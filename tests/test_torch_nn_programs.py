"""The programs of tools/torch_nn_programs.py on the port against the JAX
package, on the CPU.

- dcgan (D and G over one startup), stn_digits, word2vec_hsigmoid and
  nn_chain (every part, the drawing heads too) at their NARROW widths are
  op for op the JAX package's, main and startup.
- Three steps of each in lockstep with the JAX executor, each from the
  JAX executor's state before it (``fluid.params_from_numpy``): every op
  of the port's plan on the JAX step's values of its inputs
  (tests/torch_resnet_step.py's ``replay``) within 1e-4 of its largest
  JAX output (the repo's float32 op limit), the whole step's loss within
  1e-5 relative, the Adam parameters off by no more than the two
  gradients' difference explains (``adam_param_misses``), SGD's and the
  other persistables (batch norms' running statistics, spectral_norm's U
  and V) within 1e-5 of their largest value. nn_chain runs without its
  drawing heads here (their samples differ between the packages).
- parameter_list: DCGAN's D step leaves G's parameters bit for bit as
  they were and the G step D's.
- word2vec_hsigmoid's W and Bias gradients are the same bits in two runs.
- The full-width programs: their op counts and the parameters the fused
  Adam kernel's gate takes (none of them).
"""
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import adam_kernel

import torch_resnet_step as step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_nn_programs", os.path.join(ROOT, "tools", "torch_nn_programs.py"))
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)

TOL = 1e-5
STEPS = 3
DETERMINISTIC = tuple(p for p in tool.PARTS if p not in tool.RANDOM_PARTS)


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


def _lockstep(jmain, tmain, jloss, tloss, jscope, tscope, jexe, texe,
              feed):
    """One step of both executors from the JAX executor's state: every op
    replayed on the JAX values within the float32 op limit, the port's
    whole step's loss and persistables. Returns the op errors."""
    block = tmain.global_block()
    state = _state(jscope, jmain)
    tfluid.params_from_numpy(state, tscope, "cpu")
    inter = sorted({n for op in block.ops for n in op.output_arg_names
                    if n != "@EMPTY@" and not block.var(n).persistable})
    adam = {op.input("Param")[0] for op in block.ops if op.type == "adam"}
    grads = [p + "@GRAD" for p in sorted(adam)]
    vals = dict(zip(inter, (np.asarray(v) for v in jexe.run(
        jmain, feed=feed, fetch_list=inter, scope=jscope))))
    after = _state(jscope, jmain)
    errs = step.replay(tmain, [tloss.name], feed, state, after, vals)
    worst = max(errs, key=lambda e: e[2])
    assert worst[2] <= step.OP_TOL["float32"], worst
    got = texe.run(tmain, feed=feed, fetch_list=[tloss.name] + grads,
                   scope=tscope)
    want = float(vals[tloss.name])
    assert abs(float(got[0]) - want) <= TOL * abs(want)
    got_after = {n: tscope.get(n).numpy() for n in after}
    misses = step.adam_param_misses(
        tmain, state, got_after, after, dict(zip(grads, got[1:])),
        {g: vals[g] for g in grads})
    assert sum(misses.values()) == 0, misses
    for n in set(after) - adam:
        w = after[n].astype(np.float64)
        if w.dtype.kind == "f" and w.size:
            d = np.abs(got_after[n] - w).max()
            assert d <= TOL * (np.abs(w).max() or 1.0), n
    return errs


# --------------------------------------------------------------------------
# op for op
# --------------------------------------------------------------------------

def _pairs(name):
    if name == "dcgan":
        j, t = (tool.dcgan(fl, **tool.DCGAN_NARROW)
                for fl in (jfluid, tfluid))
        return [(j.startup, t.startup), (j.d_main, t.d_main),
                (j.g_main, t.g_main)]
    fn, widths = {"stn_digits": (tool.stn_digits, tool.STN_NARROW),
                  "word2vec_hsigmoid": (tool.word2vec_hsigmoid,
                                        tool.W2V_NARROW),
                  "nn_chain": (tool.nn_chain, tool.CHAIN_NARROW)}[name]
    j, t = (fn(fl, **widths) for fl in (jfluid, tfluid))
    return [(j.startup, t.startup), (j.main, t.main)]


SLICE_OPS = {
    "dcgan": {"conv2d_transpose", "conv2d", "batch_norm", "leaky_relu"},
    "stn_digits": {"affine_grid", "grid_sampler"},
    "word2vec_hsigmoid": {"hierarchical_sigmoid"},
    "nn_chain": {"group_norm", "affine_channel", "lrn", "fsp",
                 "conv2d_transpose", "bilinear_interp", "nearest_interp",
                 "pool2d", "depthwise_conv2d_transpose", "conv3d", "pool3d",
                 "conv3d_transpose", "row_conv", "im2sequence",
                 "bilinear_tensor_product", "conv_shift", "data_norm",
                 "tree_conv", "similarity_focus",
                 "sampled_softmax_with_cross_entropy", "sample_logits",
                 "spectral_norm"},
}


@pytest.mark.parametrize("name", sorted(SLICE_OPS))
def test_program_is_op_for_op_the_jax_packages(name):
    pairs = _pairs(name)
    for j, t in pairs:
        assert step.signature(j) == step.signature(t)
    types = {op.type for _, t in pairs for op in t.global_block().ops}
    assert SLICE_OPS[name] <= types
    fwd = {op.attrs["fwd_type"] for _, t in pairs
           for op in t.global_block().ops if op.type == "grad_of"}
    assert SLICE_OPS[name] - {"batch_norm", "similarity_focus",
                              "sample_logits"} <= fwd | {"conv2d"}


# --------------------------------------------------------------------------
# three steps in lockstep
# --------------------------------------------------------------------------

def test_dcgan_steps_in_lockstep_with_jax_executor():
    jg = tool.dcgan(jfluid, **tool.DCGAN_NARROW)
    tg = tool.dcgan(tfluid, **tool.DCGAN_NARROW)
    (jexe, jscope), (texe, tscope) = _startups(jg.startup, tg.startup)
    for k in range(STEPS):
        d_feed, g_feed = tool.dcgan_batch(10 + k, **tool.DCGAN_NARROW)
        for jmain, tmain, jl, tl, feed, other in [
                (jg.d_main, tg.d_main, jg.d_loss, tg.d_loss, d_feed,
                 tg.g_params),
                (jg.g_main, tg.g_main, jg.g_loss, tg.g_loss, g_feed,
                 tg.d_params)]:
            before = {n: np.asarray(jscope.get(n)) for n in other}
            errs = _lockstep(jmain, tmain, jl, tl, jscope, tscope, jexe,
                             texe, feed)
            # the step leaves the other net's parameters as they were
            for n in other:
                np.testing.assert_array_equal(tscope.get(n).numpy(),
                                              before[n], err_msg=n)
    assert {"conv2d_transpose", "batch_norm"} <= {e[0] for e in errs}


def test_stn_digits_steps_in_lockstep_with_jax_executor():
    j = tool.stn_digits(jfluid, **tool.STN_NARROW)
    t = tool.stn_digits(tfluid, **tool.STN_NARROW)
    (jexe, jscope), (texe, tscope) = _startups(j.startup, t.startup)
    for k in range(STEPS):
        errs = _lockstep(j.main, t.main, j.loss, t.loss, jscope, tscope,
                         jexe, texe,
                         tool.stn_batch(k, tool.STN_NARROW["batch"]))
    assert {"affine_grid", "grid_sampler"} <= {e[0] for e in errs}


def test_stn_starts_at_the_identity_transform():
    """The localisation net's last fc starts at weight 0 and bias [1, 0, 0,
    0, 1, 0]: the first step's sampled image is the image itself."""
    t = tool.stn_digits(tfluid, **tool.STN_NARROW)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(t.startup, scope=scope)
    block = t.main.global_block()
    sampler, = [op for op in block.ops if op.type == "grid_sampler"]
    feed = tool.stn_batch(0, tool.STN_NARROW["batch"])
    out, = exe.run(t.main, feed=feed, fetch_list=[sampler.output(
        "Output")[0]], scope=scope)
    np.testing.assert_allclose(out, feed["img"], atol=1e-5)


def test_word2vec_hsigmoid_steps_in_lockstep_with_jax_executor():
    w = tool.W2V_NARROW
    j = tool.word2vec_hsigmoid(jfluid, **w)
    t = tool.word2vec_hsigmoid(tfluid, **w)
    (jexe, jscope), (texe, tscope) = _startups(j.startup, t.startup)
    for k in range(STEPS):
        errs = _lockstep(j.main, t.main, j.loss, t.loss, jscope, tscope,
                         jexe, texe,
                         tool.w2v_batch(k, w["batch"], w["dict_size"]))
    assert "hierarchical_sigmoid" in {e[0] for e in errs}


def test_nn_chain_steps_in_lockstep_with_jax_executor():
    j = tool.nn_chain(jfluid, parts=DETERMINISTIC, **tool.CHAIN_NARROW)
    t = tool.nn_chain(tfluid, parts=DETERMINISTIC, **tool.CHAIN_NARROW)
    (jexe, jscope), (texe, tscope) = _startups(j.startup, t.startup)
    for k in range(STEPS):
        errs = _lockstep(j.main, t.main, j.loss, t.loss, jscope, tscope,
                         jexe, texe, tool.chain_batch(
                             k, parts=DETERMINISTIC, **tool.CHAIN_NARROW))
    assert SLICE_OPS["nn_chain"] - {"sample_logits"} <= \
        {e[0] for e in errs} | {"sampled_softmax_with_cross_entropy"}


def test_nn_chain_drawing_heads_run_and_train():
    """The heads that draw, on the port alone: finite losses that move
    the LM head's fc."""
    t = tool.nn_chain(tfluid, parts=("sampled",), **tool.CHAIN_NARROW)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(t.startup, scope=scope)
    types = {op.type for op in t.main.global_block().ops}
    assert {"sample_logits", "sampled_softmax_with_cross_entropy"} <= types
    before = scope.get("fc_0.w_0").clone()
    for k in range(2):
        loss, = exe.run(t.main, feed=tool.chain_batch(
            k, parts=("sampled",), **tool.CHAIN_NARROW), fetch_list=[t.loss],
            scope=scope)
        assert np.isfinite(loss).all()
    assert not np.array_equal(scope.get("fc_0.w_0").numpy(),
                              before.numpy())


def test_hsigmoid_gradients_are_the_same_bits_twice():
    w = tool.W2V_NARROW
    t = tool.word2vec_hsigmoid(tfluid, **w)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(t.startup, scope=scope)
    state = {n: scope.get(n).clone() for n in scope._vars
             if scope.get(n) is not None}
    feed = tool.w2v_batch(4, w["batch"], w["dict_size"])
    runs = []
    for _ in range(2):
        run = tfluid.Scope()
        for n, v in state.items():
            run.set(n, v.clone())
        runs.append(exe.run(t.main, feed=feed,
                            fetch_list=["hs.w@GRAD", "hs.b@GRAD"],
                            scope=run))
    for a, b in zip(*runs):
        assert np.abs(a).max() > 0
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the full-width programs
# --------------------------------------------------------------------------

def _adam_takes(program):
    """The parameters of the program's adam ops that the fused kernel's
    gate admits."""
    block = program.global_block()
    return sorted(op.input("Param")[0] for op in block.ops
                  if op.type == "adam" and adam_kernel.adam_ok(
                      tuple(block.var(op.input("Param")[0]).shape)))


def test_full_width_programs():
    """The full-width programs: op counts, DCGAN's filters, nn_chain's maps
    and outputs at their widths, and the one parameter of the four
    programs the fused Adam kernel's gate admits (nn_chain's LM head
    [512, 8192]; DCGAN's filters are 4-D, the others' 2-D weights narrow
    or of rows not a multiple of 8)."""
    g = tool.dcgan(tfluid)
    assert [len(p.global_block().ops) for p in (g.startup, g.d_main,
                                                g.g_main)] == [174, 116, 74]
    assert sorted(tuple(p.shape) for p in g.g_main.all_parameters()
                  if p.name.startswith("g_ct")) == \
        [(64, 3, 4, 4), (100, 512, 4, 4), (128, 64, 4, 4), (256, 128, 4, 4),
         (512, 256, 4, 4)]
    s = tool.stn_digits(tfluid)
    w = tool.word2vec_hsigmoid(tfluid)
    c = tool.nn_chain(tfluid)
    assert [len(p.global_block().ops) for p in (s.main, w.main, c.main)] == \
        [77, 27, 210]
    block = c.main.global_block()
    shapes = {op.type: block.var(op.output(
        "Out" if "Out" in op.outputs else "Output")[0]).shape
        for op in block.ops if op.type in ("pool2d", "conv3d_transpose",
                                           "im2sequence", "fsp")}
    assert shapes == {"pool2d": (64, 256, 7, 7),
                      "conv3d_transpose": (8, 64, 16, 56, 56),
                      "im2sequence": (6400, 768), "fsp": (64, 256, 256)}
    for program in (g.d_main, g.g_main, s.main, w.main):
        assert _adam_takes(program) == []
    assert _adam_takes(c.main) == ["fc_3.w_0"]
    assert block.var("fc_3.w_0").shape == (512, 8192)
