"""The fake-quantization lowerings (``paddle_tpu_torch/fluid/ops/
quantize_ops.py``'s 8) against the JAX package's on the same seeded numpy
inputs, on the CPU.

- Forwards: every output of every case. The quantized integers (Out of
  fake_quantize_abs_max, the int8 of quantize) exactly, with their
  dtypes; every float output within 1e-6 of its largest JAX magnitude
  (a dequantized value is a quantized integer times a scale, so the two
  packages may differ by an ulp of it).
- Rounding: inputs on the .5 boundaries round half to even, as
  ``jnp.round``; inputs where dividing by the scale and multiplying by its
  reciprocal round apart give the division's integers, as the JAX
  lowering's; a zero input takes each op's own epsilon.
- Test mode: the moving-average and range ops use InScale whether the op's
  ``is_test`` or the context's says so.
- The straight-through gradient of the five fake-quantize types, through
  each package's ``fluid.gradients``: X@GRAD is Out@GRAD unchanged, also
  where the range op clips, equal to the JAX package's.
- Build-time shape inference gives the real run's shapes and dtypes.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.fluid.ops import registry as jreg
from paddle_tpu_torch.fluid.ops import quantize_ops
from paddle_tpu_torch.fluid.ops import registry as treg

TOL = 1e-6
QUANTIZE_OPS = {"fake_quantize_abs_max", "fake_dequantize_max_abs",
                "fake_quantize_dequantize_abs_max",
                "fake_quantize_moving_average_abs_max",
                "fake_quantize_range_abs_max", "ste_identity_grad",
                "quantize", "dequantize"}
# the outputs that hold quantized integers
EXACT = {"fake_quantize_abs_max": {"Out"}, "quantize": {"Output"}}


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# values whose x / max|x| * 1 lands on .5 boundaries at bit_length 2
# (bnt 1): round half to even gives 0, -0, 2 -> clipped 1, ...
HALVES = np.array([[1.0, 0.5, -0.5, 0.25], [-1.0, 0.75, -0.75, 0.0]],
                  np.float32)


def _in_scale(v):
    return np.array([v], np.float32)


def _load_tool():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_compression_programs",
        os.path.join(root, "tools", "torch_compression_programs.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _boundaries():
    """ReLU'd normals, 64 of them where x / max|x| * 127 and x * (1 /
    max|x|) * 127 round apart (tools/torch_compression_programs.py)."""
    x = np.maximum(_randn(8, 256, seed=13), 0)
    flat = x.reshape(-1)
    flat[:64] = _load_tool().boundary_values(flat.max(), 64)
    return x


CASES = {
    "fake_quantize_abs_max": ({"X": [_randn(4, 3, 5, 5, seed=1)]},
                              {"bit_length": 8}),
    "fake_quantize_abs_max__bits4": ({"X": [_randn(16, 8, seed=2)]},
                                     {"bit_length": 4}),
    "fake_quantize_abs_max__halves": ({"X": [HALVES]}, {"bit_length": 2}),
    "fake_quantize_abs_max__boundaries": ({"X": [_boundaries()]},
                                          {"bit_length": 8}),
    "fake_quantize_abs_max__zero": ({"X": [np.zeros((3, 4), np.float32)]},
                                    {"bit_length": 8}),
    "fake_dequantize_max_abs": ({"X": [np.round(_randn(6, 7, seed=3) * 40)],
                                 "Scale": [_in_scale(2.75)]},
                                {"bit_length": 8}),
    "fake_quantize_dequantize_abs_max": ({"X": [_randn(8, 64, seed=4)]},
                                         {"bit_length": 8}),
    "fake_quantize_dequantize_abs_max__halves": ({"X": [HALVES]},
                                                 {"bit_length": 2}),
    "fake_quantize_dequantize_abs_max__zero": (
        {"X": [np.zeros((2, 3), np.float32)]}, {"bit_length": 8}),
    "fake_quantize_moving_average_abs_max": (
        {"X": [_randn(8, 32, seed=5)], "InScale": [_in_scale(1.5)]},
        {"bit_length": 8, "moving_rate": 0.9}),
    "fake_quantize_moving_average_abs_max__is_test": (
        {"X": [_randn(8, 32, seed=6, scale=3.0)],
         "InScale": [_in_scale(1.5)]},
        {"bit_length": 8, "moving_rate": 0.9, "is_test": True}),
    "fake_quantize_range_abs_max": (
        {"X": [_randn(8, 32, seed=7)], "InScale": [_in_scale(0.5)]},
        {"bit_length": 8}),
    "fake_quantize_range_abs_max__is_test": (
        {"X": [_randn(8, 32, seed=8, scale=3.0)],
         "InScale": [_in_scale(2.0)]},
        {"bit_length": 8, "is_test": True}),
    "ste_identity_grad": ({"Out@GRAD": [_randn(5, 6, seed=9)]}, {}),
    "quantize": ({"Input": [_randn(4, 64, 7, 7, seed=10, scale=2.0)]},
                 {"Scale": 40.0}),
    "quantize__halves": ({"Input": [np.array([0.5, 1.5, 2.5, -0.5, -1.5,
                                              200.0, -200.0], np.float32)]},
                         {"Scale": 1.0}),
    "dequantize": ({"Input": [np.random.RandomState(11).randint(
        -128, 128, (4, 64)).astype(np.int8)]}, {"Scale": 40.0}),
}


def _op(case):
    return case.split("__")[0]


def _j(arrays):
    return {k: [jnp.asarray(a) for a in v] for k, v in arrays.items()}


def _t(arrays):
    return {k: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
            for k, v in arrays.items()}


def _jax(op, arrays, attrs, is_test=False):
    return jax.jit(lambda ins: jreg.get_lowering(op)(
        jreg.LoweringContext(is_test=is_test), ins, attrs))(_j(arrays))


def _port(op, arrays, attrs, is_test=False):
    return treg.get_lowering(op)(treg.LoweringContext("cpu", is_test=is_test),
                                 _t(arrays), attrs)


def _check(got, want, msg, exact=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    assert got.dtype == want.dtype, (got.dtype, want.dtype, msg)
    if exact or want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, msg)
        return
    bound = TOL * (np.abs(want).max() or 1.0)
    assert np.abs(got.astype(np.float64) - want).max() <= bound, msg


def test_the_cases_cover_the_slice():
    """The 8 lowerings of the JAX quantize_ops.py, each with a case,
    registered in the port's quantize_ops.py with the same no-grad flags
    and the straight-through grad maker on the same five types; the port
    holds 297 (278 before this slice, 11 more with parity_ops.py), none
    the JAX package lacks."""
    assert {_op(c) for c in CASES} == QUANTIZE_OPS
    assert {op for op in jreg._LOWERINGS if jreg._LOWERINGS[op].__module__
            .endswith("quantize_ops")} == QUANTIZE_OPS
    assert all(treg._LOWERINGS[op].__module__.endswith("quantize_ops")
               for op in QUANTIZE_OPS)
    for op in QUANTIZE_OPS:
        assert jreg.is_no_grad(op) == treg.is_no_grad(op), op
    ste = {op for op in jreg._GRAD_MAKERS
           if jreg._GRAD_MAKERS[op].__module__.endswith("quantize_ops")}
    assert ste == set(quantize_ops.STE_TYPES)
    assert all(treg.has_grad_maker(op) for op in ste)
    assert len(treg._LOWERINGS) == 297
    assert set(treg._LOWERINGS) <= set(jreg._LOWERINGS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    arrays, attrs = CASES[case]
    want = _jax(_op(case), arrays, attrs)
    got = _port(_op(case), arrays, attrs)
    assert set(got) == set(want)
    for slot, w in want.items():
        for g, v in zip(got[slot], w):
            _check(g, v, (case, slot), slot in EXACT.get(_op(case), ()))


def test_halves_round_to_even():
    """The .5 boundaries: 0.5 -> 0, -0.5 -> -0, 0.75 -> 1 at bnt 1; 2.5
    -> 2 and 1.5 -> 2 in quantize; the clip at +-1 and at int8's range."""
    out = _port("fake_quantize_abs_max", {"X": [HALVES]},
                {"bit_length": 2})["Out"][0].numpy()
    np.testing.assert_array_equal(out, [[1, 0, -0, 0], [-1, 1, -1, 0]])
    q = _port("quantize", *CASES["quantize__halves"])["Output"][0].numpy()
    np.testing.assert_array_equal(q, [0, 2, 2, 0, -2, 127, -128])


@pytest.mark.parametrize("op", ["fake_quantize_moving_average_abs_max",
                                "fake_quantize_range_abs_max"])
def test_context_is_test_uses_in_scale(op):
    """The program's test mode (the context's is_test) as the op's own:
    the scale is InScale, not a new running value."""
    arrays, attrs = CASES[op + "__is_test"]
    attrs = dict(attrs, is_test=False)
    want = _jax(op, arrays, attrs, is_test=True)
    got = _port(op, arrays, attrs, is_test=True)
    np.testing.assert_array_equal(got["OutScale"][0].numpy(),
                                  arrays["InScale"][0])
    for slot in want:
        _check(got[slot][0], want[slot][0], slot)
    train = _port(op, arrays, attrs)["OutScale"][0].numpy()
    assert not np.array_equal(train, arrays["InScale"][0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_shape_inference_gives_the_forwards_shapes(case):
    arrays, attrs = CASES[case]
    meta = treg.infer_outputs(_op(case), {k: [t.to("meta") for t in v]
                                          for k, v in _t(arrays).items()},
                              attrs)
    got = _port(_op(case), arrays, attrs)
    for slot in got:
        for m, g in zip(meta[slot], got[slot]):
            assert (m.shape, m.dtype) == (g.shape, g.dtype), slot


def _ste_program(fluid, op_type):
    """x (a gradient input) -> `op_type` -> sum(out * w) with a fixed w:
    (main, the x@GRAD var, feed)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        x.stop_gradient = False
        w = fluid.layers.data(name="w", shape=[6], dtype="float32")
        helper = fluid.layer_helper.LayerHelper(op_type)
        out = helper.create_variable_for_type_inference("float32")
        inputs = {"X": [x]}
        outputs = {"Out": [out]}
        if op_type == "fake_dequantize_max_abs":
            inputs["Scale"] = [fluid.layers.fill_constant([1], "float32",
                                                          3.0)]
        else:
            outputs["OutScale"] = [
                helper.create_variable_for_type_inference("float32")]
        if op_type in ("fake_quantize_moving_average_abs_max",
                       "fake_quantize_range_abs_max"):
            inputs["InScale"] = [fluid.layers.fill_constant([1], "float32",
                                                            0.5)]
        helper.append_op(type=op_type, inputs=inputs, outputs=outputs,
                         attrs={"bit_length": 8})
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out, w))
        dx, = fluid.gradients(loss, x)
    r = np.random.RandomState(12)
    feed = {"x": (r.randn(4, 6) * 2).astype(np.float32),
            "w": r.randn(4, 6).astype(np.float32)}
    return main, dx, feed


@pytest.mark.parametrize("op_type", quantize_ops.STE_TYPES)
def test_straight_through_gradient_matches_jax(op_type):
    """X@GRAD = Out@GRAD (w), also where the range op clips x to its
    InScale of 0.5."""
    jmain, jdx, feed = _ste_program(jfluid, op_type)
    tmain, tdx, _ = _ste_program(tfluid, op_type)
    assert [op.type for op in jmain.global_block().ops] == \
        [op.type for op in tmain.global_block().ops]
    assert "ste_identity_grad" in [op.type for op in
                                   tmain.global_block().ops]
    want, = jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed=feed, fetch_list=[jdx], scope=jfluid.Scope())
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[tdx], scope=tfluid.Scope())
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, feed["w"])


def test_boundary_inputs_round_as_a_division():
    """On the boundary inputs the port's integers are the JAX lowering's
    (a true division), and a multiply by the reciprocal would give other
    integers at each of the 64."""
    x = CASES["fake_quantize_abs_max__boundaries"][0]["X"][0]
    got = _port("fake_quantize_abs_max", {"X": [x]},
                {"bit_length": 8})["Out"][0].numpy()
    s = np.float32(np.abs(x).max())
    recip = np.round(np.clip(x * (np.float32(1) / s), -1, 1) * 127)
    np.testing.assert_array_equal(got, np.round(np.clip(x / s, -1, 1) * 127))
    assert (got != recip).sum() >= 64
