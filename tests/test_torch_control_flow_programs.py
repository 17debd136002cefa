"""The programs of tools/torch_control_flow_programs.py on the port against
the JAX package, on the CPU.

- Each builder at its NARROW widths gives the JAX package's program op for
  op, in every block, main and startup: rnn_encoder_decoder, while_loop
  (served, trained, trained under a bound two below its trips), the
  dropout body, the three Switch programs, the IfElse regressor and the
  tensor arrays.
- One run of each on both executors from the JAX startup state: every
  fetched value and every gradient within 1e-5 of its largest JAX
  magnitude plus 1e-7 (float32); the tensor arrays (gathers, selects and
  masks) equal. The bounded control's gradients are NaN in both; the
  dropout body keeps one mask on every trip in both.
- The full-width programs: op counts, and the parameters the fused Adam
  kernel's gate takes in the encoder-decoder at the WMT-14 widths (the two
  [30000, 512] tables and the four [512, 512] step weights; the [512,
  30000] head fails columns % 128).
"""
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import adam_kernel

from test_torch_control_flow import signature, assert_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_control_flow_programs",
    os.path.join(ROOT, "tools", "torch_control_flow_programs.py"))
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)

NARROW = {
    "rnn_encoder_decoder": (
        lambda fl: tool.rnn_encoder_decoder(fl, **tool.ENC_DEC_NARROW),
        tool.enc_dec_batch(0, **tool.ENC_DEC_NARROW)),
    "while_serve": (lambda fl: tool.while_loop(fl, **tool.WHILE_NARROW),
                    tool.while_batch(0, **tool.WHILE_NARROW)),
    "while_train": (
        lambda fl: tool.while_loop(fl, train=True, **tool.WHILE_NARROW),
        tool.while_batch(0, **tool.WHILE_NARROW)),
    "while_bound_too_small": (
        lambda fl: tool.while_loop(
            fl, train=True, max_trip_count=tool.WHILE_NARROW["trips"] - 2,
            **tool.WHILE_NARROW),
        tool.while_batch(0, **tool.WHILE_NARROW)),
    "while_dropout": (lambda fl: tool.while_dropout(fl, **tool.WHILE_NARROW),
                      {}),
    "switch_taken": (lambda fl: tool.switch(fl, "taken",
                                            **tool.BRANCHY_NARROW),
                     tool.branchy_batch(0, **tool.BRANCHY_NARROW)),
    "switch_untaken": (lambda fl: tool.switch(fl, "untaken",
                                              **tool.BRANCHY_NARROW),
                       tool.branchy_batch(0, **tool.BRANCHY_NARROW)),
    "switch_default": (lambda fl: tool.switch(fl, "default",
                                              **tool.BRANCHY_NARROW),
                       tool.branchy_batch(0, **tool.BRANCHY_NARROW)),
    "ifelse": (lambda fl: tool.ifelse(fl, **tool.BRANCHY_NARROW),
               tool.branchy_batch(0, **tool.BRANCHY_NARROW)),
    "tensor_arrays": (lambda fl: tool.tensor_arrays(fl, **tool.ARRAYS_NARROW),
                      tool.arrays_batch(0, **tool.ARRAYS_NARROW)),
}
SLICE_OPS = {
    "rnn_encoder_decoder": {"recurrent"},
    "while_serve": {"while"}, "while_train": {"while", "while_grad"},
    "while_bound_too_small": {"while_grad"}, "while_dropout": {"while"},
    "switch_taken": {"conditional_block", "conditional_block_grad"},
    "switch_untaken": {"conditional_block", "conditional_block_grad"},
    "switch_default": {"conditional_block", "conditional_block_grad"},
    "ifelse": {"cast", "elementwise_mul", "elementwise_sub"},
    "tensor_arrays": {"lod_rank_table", "max_sequence_len",
                      "lod_tensor_to_array", "array_to_lod_tensor",
                      "read_from_array", "write_to_array",
                      "lod_array_length", "shrink_rnn_memory",
                      "reorder_lod_tensor_by_rank", "split_lod_tensor",
                      "merge_lod_tensor", "tensor_array_to_tensor",
                      "lod_reset"},
}


def _fetch(m):
    block = m.main.global_block()
    out = list(m.out.values()) if isinstance(m.out, dict) else [m.out]
    names = [v.name for v in out] + ([m.loss.name] if m.loss else [])
    written = {n for op in block.ops for n in op.output_arg_names}
    return names + sorted(n for n in written if "@GRAD" in n and
                          block.has_var(n))


def _run(fluid, m, feed, state=None):
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(m.startup, scope=scope)
    if state is not None:
        tfluid.params_from_numpy(state, scope, "cpu")
    before = {v.name: np.asarray(scope.get(v.name))
              for v in m.main.global_block().vars.values()
              if v.persistable and scope.get(v.name) is not None}
    got = exe.run(m.main, feed=feed, fetch_list=_fetch(m), scope=scope)
    return before, [np.asarray(g) for g in got]


@pytest.mark.parametrize("name", sorted(NARROW))
def test_program_is_op_for_op_the_jax_packages_and_runs_alike(name):
    build, feed = NARROW[name]
    j, t = build(jfluid), build(tfluid)
    assert signature(j.main) == signature(t.main)
    assert signature(j.startup) == signature(t.startup)
    types = {op.type for b in t.main.blocks for op in b.ops}
    assert SLICE_OPS[name] <= types
    state, want = _run(jfluid, j, feed)
    _, got = _run(tfluid, t, feed, state)
    assert len(got) == len(want) == len(_fetch(t))
    for n, g, w in zip(_fetch(t), got, want):
        if name == "tensor_arrays":
            np.testing.assert_array_equal(g, w.astype(g.dtype), n)
        elif name != "while_dropout":    # the generators differ
            assert_close(g, w, n)
    params = {p.name + "@GRAD" for p in t.main.all_parameters()}
    grads = [g for n, g in zip(_fetch(t), got) if n in params]
    if name == "while_bound_too_small":
        # every parameter's gradient passes through the loop
        assert len(grads) == 4 and all(np.isnan(g).all() for g in grads)
    else:
        assert all(np.isfinite(g).all() for g in grads)
    if name == "while_dropout":
        for acc in (want[0], got[0]):
            np.testing.assert_array_equal(
                np.unique(acc), [0.0, tool.WHILE_NARROW["trips"]])


def _adam_takes(program):
    block = program.global_block()
    return sorted(op.input("Param")[0] for op in block.ops
                  if op.type == "adam" and adam_kernel.adam_ok(
                      tuple(block.var(op.input("Param")[0]).shape)))


def test_full_width_programs():
    m = tool.rnn_encoder_decoder(tfluid)
    block = m.main.global_block()
    assert len(block.ops) == 30
    assert [op.type for op in block.ops].count("adam") == 10
    takes = _adam_takes(m.main)
    assert sorted(tuple(block.var(p).shape) for p in takes) == \
        [(512, 512)] * 4 + [(30000, 512)] * 2
    head = [op for op in block.ops if op.type == "mul"][-1]
    assert block.var(head.input("Y")[0]).shape == (512, 30000)
    w = tool.while_loop(tfluid, train=True, **tool.WHILE_TRAIN)
    assert [len(b.ops) for b in w.main.blocks] == [23, 7]
    assert _adam_takes(w.main) == []
    a = tool.tensor_arrays(tfluid)
    assert a.main.global_block().var("hidden").dtype == "bfloat16"
    assert len(a.main.global_block().ops) == 16


def _tree(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            with open(os.path.join(root, n), "rb") as f:
                out[os.path.relpath(os.path.join(root, n), d)] = f.read()
    return out


def _serve(fluid, dirname, feed):
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        prog, feeds, _ = fluid.io.load_inference_model(dirname, exe)
        assert feeds == ["x"]
        assert [op.type for op in prog.global_block().ops].count(
            "while") == 1
        return np.asarray(exe.run(prog, feed=feed, scope=scope)[0])


def test_while_model_artifact_is_the_jax_packages_and_each_serves_the_others(
        tmp_path):
    """benchmark/predictor_bench.py's While model saved (without
    aot_example_inputs) by each package: the same bytes, file for file;
    each package serves the other's artifact within 1e-5."""
    dirs, outs = {}, {}
    state = None
    for fluid in (jfluid, tfluid):
        m = tool.while_loop(fluid, **tool.WHILE_NARROW)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(m.startup, scope=scope)
        if state is None:
            state = {p.name: np.asarray(scope.get(p.name))
                     for p in m.main.all_parameters()}
        else:
            tfluid.params_from_numpy(state, scope, "cpu")
        dirs[fluid] = str(tmp_path / fluid.__name__)
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(dirs[fluid], m.feeds, [m.out], exe,
                                          main_program=m.main)
    jtree, ttree = _tree(dirs[jfluid]), _tree(dirs[tfluid])
    assert sorted(jtree) == sorted(ttree) and "__model__" in ttree
    for rel in jtree:
        assert ttree[rel] == jtree[rel], rel
    feed = {"x": tool.while_batch(1, **tool.WHILE_NARROW)["x"]}
    want = _serve(jfluid, dirs[jfluid], feed)
    assert want.shape == (tool.WHILE_NARROW["batch"],
                          tool.WHILE_NARROW["width"])
    assert_close(_serve(tfluid, dirs[jfluid], feed), want)
    assert_close(_serve(jfluid, dirs[tfluid], feed), want)
