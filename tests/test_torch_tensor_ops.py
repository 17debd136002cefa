"""The tensor lowerings (``paddle_tpu_torch/fluid/ops/tensor_ops.py``: the
fills, assign_value, the ranges and shape; the reshapes; split, stack,
unstack, expand, reverse; the pads, crop, space_to_depth and
shuffle_channel; gather, scatter, multiplex, the arg ops, argsort, isinf,
isnan and the selected-rows identities; the random ops), each against the
JAX package's lowering of the same op on the same seeded inputs, on the
CPU.

Tolerance: ops that move or pick values (every op here but scatter with
overwrite=False) give the JAX values exactly, NaNs in the same places, in
float32 and in bfloat16; scatter's adds within 1e-5 (float32) or 2^-7
(bfloat16) of the largest JAX magnitude. Integer outputs are equal (the
JAX package's int32 where the port's are int64, x64 being off).
Gradients: ``jax.vjp`` of the JAX lowering (one jitted function for each
dtype) against autograd through the port's lowering, within 1e-5 (float32)
or 2^-7 (bfloat16) of the largest JAX magnitude.

The random ops draw from other generators in the two packages, so they are
held by invariants: shapes and dtypes, bounds, moments within 5 standard
errors, a chi-square test on sampling_id's draws (p > 1e-4, and a shifted
distribution must fail it), random_crop's one window for the whole batch.

Besides, each trap of the JAX semantics has a case or a test: gather's
out-of-range and negative indices (NaN, or the least integer; no
gradient) and its gradient through scatter_rows_; scatter's wrapped and
dropped ids, the last of repeated updates landing with overwrite=True and
only it taking the gradient; multiplex's ids (a negative one wraps once,
then clamped; out of range after the wrap, no gradient); argsort's
stability, NaNs and -0.0; the arg ops' ties and NaNs; pad2d's reflect and
edge pads as wide as the axis or wider, in NCHW and NHWC; the float32
ranges' lengths; bfloat16 outputs and pad values.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.fluid.ops import registry as jreg
from paddle_tpu_torch.fluid.ops import registry as treg
from paddle_tpu_torch.fluid.ops import tensor_ops

F32_TOL, BF16_TOL = 1e-5, 2.0 ** -7


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        x = x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    if x.dtype.kind in "iu":
        return x.astype(np.int64)
    return x if x.dtype == bool else x.astype(np.float64)


def _rng(seed):
    return np.random.RandomState(seed)


def _randn(*shape, seed=0):
    return _rng(seed).randn(*shape).astype(np.float32)


def _ids(*values):
    return np.array(values, np.int64).reshape(-1, 1)


def _inputs(arrays, bf16=False):
    def j(a):
        a = jnp.asarray(a)
        return a.astype(jnp.bfloat16) if bf16 and a.dtype == jnp.float32 \
            else a

    def t(a):
        a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(torch.bfloat16) if bf16 and a.dtype == torch.float32 \
            else a
    return ({k: [j(a) for a in v] for k, v in arrays.items()},
            {k: [t(a) for a in v] for k, v in arrays.items()})


def _run(op, arrays, attrs, bf16=False):
    jin, tin = _inputs(arrays, bf16)
    want = jreg.get_lowering(op)(jreg.LoweringContext(), jin, attrs)
    got = treg.get_lowering(op)(treg.LoweringContext("cpu"), tin, attrs)
    return want, got


def _check(got, want, tol=0.0, err_msg=""):
    """Equal shapes and NaNs; elsewhere |got - want| <= tol * max |want|
    (exact at tol 0)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    if want.dtype == bool or want.dtype.kind == "i":
        np.testing.assert_array_equal(got, want, err_msg=err_msg)
        return
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=err_msg)
    got, want = got[~nan], want[~nan]
    if not want.size:
        return
    if tol == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=err_msg)
    else:
        bound = tol * np.abs(want).max()
        assert np.abs(got - want).max() <= bound, (err_msg, np.abs(
            got - want).max(), bound)


# case -> (op, inputs, attrs). The op is the case's name up to "__".
CASES = {
    # values and shapes
    "fill_zeros_like": ({"X": [_randn(3, 4)]}, {}),
    "fill_constant_batch_size_like": (
        {"Input": [_randn(5, 3)]},
        {"shape": [-1, 7], "dtype": "float32", "value": 2.5}),
    "fill_constant_batch_size_like__dims": (
        {"Input": [_randn(2, 4, 3)]},
        {"shape": [3, -1], "dtype": "int64", "value": 7.0,
         "input_dim_idx": 1, "output_dim_idx": 1}),
    "fill": ({}, {"shape": [2, 3], "dtype": "float32",
                  "value": [0.1, -2.5, 1e-8, 3.3, 7.0, 1.0 / 3]}),
    "fill__int": ({}, {"shape": [4], "dtype": "int32",
                       "value": [1.7, -2.2, 3.0, 0.0]}),
    "assign_value": ({}, {"shape": [3, 4], "dtype": "float32",
                          "values": _rng(1).randn(12).tolist()}),
    "assign_value__fp32": ({}, {"shape": [2, 2], "dtype": "float32",
                                "fp32_values": [0.5, 1.1, -3.0, 2.2]}),
    "assign_value__int32": ({}, {"shape": [5], "dtype": "int32",
                                 "int32_values": [3, -1, 0, 7, 2 ** 30]}),
    "assign_value__int64": ({}, {"shape": [2, 3], "dtype": "int64",
                                 "values": [0.0, 5.0, -9.0, 1.0, 2.0, 3.0]}),
    "range_static": ({}, {"start": 0.0, "end": 1.0, "step": 0.1,
                          "dtype": "float32"}),
    "range_static__odd_step": ({}, {"start": 1.5, "end": 7.3, "step": 0.37,
                                    "dtype": "float32"}),
    "range_static__down": ({}, {"start": 10.0, "end": 0.0, "step": -1.5,
                                "dtype": "float32"}),
    "range_static__int": ({}, {"start": 0.0, "end": 100.0, "step": 7.0,
                               "dtype": "int64"}),
    "range_static__fine": ({}, {"start": -3.0, "end": 3.0, "step": 0.01,
                                "dtype": "float32"}),
    "range": ({"Start": [np.array(0.0, np.float32)],
               "End": [np.array(1.0, np.float32)],
               "Step": [np.array(0.1, np.float32)]}, {}),
    "shape": ({"Input": [_randn(2, 3, 5)]}, {}),
    # reshapes
    "reshape": ({"X": [_randn(2, 3, 4)]}, {"shape": [0, -1]}),
    "transpose": ({"X": [_randn(2, 3, 4)]}, {"axis": [2, 0, 1]}),
    "flatten": ({"X": [_randn(2, 3, 4, 5)]}, {"axis": 2}),
    "flatten__axis0": ({"X": [_randn(2, 3, 4)]}, {"axis": 0}),
    "squeeze": ({"X": [_randn(2, 1, 3, 1)]}, {"axes": [1]}),
    "squeeze__all": ({"X": [_randn(1, 3, 1, 4)]}, {"axes": []}),
    "squeeze2": ({"X": [_randn(2, 1, 3, 1)]}, {"axes": [-1, 1]}),
    "unsqueeze": ({"X": [_randn(2, 3)]}, {"axes": [0, 2]}),
    "unsqueeze2": ({"X": [_randn(2, 3)]}, {"axes": [-1]}),
    # split and join
    "split": ({"X": [_randn(2, 6, 3)]}, {"axis": 1, "num": 3,
                                         "sections": []}),
    "split__sections": ({"X": [_randn(2, 3, 7)]},
                        {"axis": 2, "num": 0, "sections": [2, 4, 1]}),
    "stack": ({"X": [_randn(2, 3), _randn(2, 3, seed=1),
                     _randn(2, 3, seed=2)]}, {"axis": 1}),
    "stack__last": ({"X": [_randn(4), _randn(4, seed=1)]}, {"axis": -1}),
    "unstack": ({"X": [_randn(2, 3, 4)]}, {"axis": 1, "num": 3}),
    "expand": ({"X": [_randn(2, 1, 3)]}, {"expand_times": [2, 4, 1]}),
    "expand__fewer_times": ({"X": [_randn(2, 3)]}, {"expand_times": [3]}),
    "reverse": ({"X": [_randn(3, 4, 5)]}, {"axis": [0, 2]}),
    "reverse__twice": ({"X": [_randn(3, 4)]}, {"axis": [1, -1, 0]}),
    # pads, crops, channel moves
    "pad": ({"X": [_randn(2, 3, 4)]}, {"paddings": [1, 2, 0, 0, 3, 1],
                                       "pad_value": 0.3}),
    "pad2d": ({"X": [_randn(2, 3, 4, 5)]},
              {"paddings": [1, 2, 0, 3], "mode": "constant",
               "pad_value": -1.5}),
    "pad2d__reflect": ({"X": [_randn(2, 3, 4, 5)]},
                       {"paddings": [1, 1, 2, 1], "mode": "reflect"}),
    "pad2d__reflect_wide": ({"X": [_randn(1, 2, 3, 4)]},
                            {"paddings": [4, 5, 3, 7], "mode": "reflect"}),
    "pad2d__edge_wide": ({"X": [_randn(1, 2, 3, 4)]},
                         {"paddings": [4, 0, 2, 6], "mode": "edge"}),
    "pad2d__reflect_nhwc": ({"X": [_randn(2, 4, 5, 3)]},
                            {"paddings": [2, 1, 4, 5], "mode": "reflect",
                             "data_format": "NHWC"}),
    "pad2d__edge_nhwc": ({"X": [_randn(2, 4, 5, 3)]},
                         {"paddings": [0, 2, 1, 1], "mode": "edge",
                          "data_format": "NHWC"}),
    "pad2d__constant_nhwc": ({"X": [_randn(2, 4, 5, 3)]},
                             {"paddings": [1, 0, 0, 2], "mode": "constant",
                              "pad_value": 2.0, "data_format": "NHWC"}),
    "pad_constant_like": ({"X": [_randn(4, 5, 6)], "Y": [_randn(2, 5, 3)]},
                          {"pad_value": 0.7}),
    "crop": ({"X": [_randn(4, 5, 6)]}, {"shape": [2, 3, 4],
                                        "offsets": [1, 2, 0]}),
    "space_to_depth": ({"X": [_randn(2, 3, 4, 6)]}, {"blocksize": 2}),
    "shuffle_channel": ({"X": [_randn(2, 6, 3, 2)]}, {"group": 3}),
    # indexing
    "gather": ({"X": [_randn(6, 4)], "Index": [_ids(5, 0, 2, 2, 5, 1)]},
               {}),
    # wrapping negatives; out of range (NaN, no gradient)
    "gather__odd": ({"X": [_randn(5, 3)],
                     "Index": [_ids(-1, 4, 5, -5, -6, 9, 0, 4)]}, {}),
    "gather__3d": ({"X": [_randn(5, 2, 3)], "Index": [_ids(4, -2, 4, 7)]},
                   {}),
    "gather__int": ({"X": [np.arange(15, dtype=np.int32).reshape(5, 3)],
                     "Index": [_ids(2, -1, 7, 0)]}, {}),
    "scatter": ({"X": [_randn(6, 3)], "Ids": [_ids(4, 0, 2)],
                 "Updates": [_randn(3, 3, seed=1)]}, {"overwrite": True}),
    # repeated ids: the last update lands; -1 wraps onto 5; 9 dropped
    "scatter__repeats": ({"X": [_randn(6, 3)],
                          "Ids": [_ids(1, 1, 5, -1, 9, 1, 3)],
                          "Updates": [_randn(7, 3, seed=1)]},
                         {"overwrite": True}),
    "scatter__add": ({"X": [_randn(6, 3)],
                      "Ids": [_ids(1, 1, 5, -1, 9, 1, 3, -7)],
                      "Updates": [_randn(8, 3, seed=1)]},
                     {"overwrite": False}),
    "scatter__add_3d": ({"X": [_randn(4, 2, 3)],
                         "Ids": [_ids(3, 3, -4, 0, 4, 3)],
                         "Updates": [_randn(6, 2, 3, seed=1)]},
                        {"overwrite": False}),
    "scatter__repeats_3d": ({"X": [_randn(4, 2, 3)],
                             "Ids": [_ids(3, 3, -4, 0, 4, 3)],
                             "Updates": [_randn(6, 2, 3, seed=1)]},
                            {"overwrite": True}),
    "multiplex": ({"X": [_randn(6, 4), _randn(6, 4, seed=1),
                         _randn(6, 4, seed=2)],
                   "Ids": [np.array([[0], [2], [1], [5], [-1], [-7]],
                                    np.int32)]}, {}),
    "arg_max": ({"X": [_randn(4, 5)]}, {"axis": 1}),
    "arg_max__ties_nan": ({"X": [np.array([[1, 3, 3, 0], [2, np.nan, 5,
                                                           np.nan],
                                           [-0.0, 0.0, -1, 0.0]],
                                          np.float32)]}, {"axis": -1}),
    "arg_min": ({"X": [_randn(4, 5)]}, {"axis": 0}),
    "arg_min__ties_nan": ({"X": [np.array([[1, 0, 3, 0], [2, np.nan, -5,
                                                           np.nan],
                                           [0.0, -0.0, 1, -0.0]],
                                          np.float32)]}, {"axis": 1}),
    "argsort": ({"X": [_randn(3, 7)]}, {"axis": -1}),
    "argsort__axis0": ({"X": [_randn(5, 3)]}, {"axis": 0}),
    # ties (stable), -0.0 with 0.0, NaN and -NaN last, infinities
    "argsort__ties_nan": ({"X": [np.array(
        [[0.0, -0.0, np.nan, 1.0, -np.nan, -np.inf, np.inf, 1.0, 0.0],
         [2.0, 2.0, 2.0, -1.0, 2.0, np.nan, -1.0, 0.0, 2.0]],
        np.float32)]}, {"axis": -1}),
    "isinf": ({"X": [np.array([1.0, np.inf, 2.0], np.float32)]}, {}),
    "isinf__none": ({"X": [np.array([1.0, np.nan], np.float32)]}, {}),
    "isnan": ({"X": [np.array([[1.0, np.nan], [0.0, 2.0]], np.float32)]},
              {}),
    "isnan__none": ({"X": [np.array([1.0, -np.inf], np.float32)]}, {}),
    "merge_selected_rows": ({"X": [_randn(5, 3)]}, {}),
    "get_tensor_from_selected_rows": ({"X": [_randn(5, 3)]}, {}),
}

RANDOM_OPS = ["uniform_random_batch_size_like",
              "gaussian_random_batch_size_like", "truncated_gaussian_random",
              "sampling_id", "random_crop"]
# the one op whose forward adds
ADDS = {"scatter__add", "scatter__add_3d"}
# the differentiable cases: (case, the output slot)
GRAD_SLOT = {"stack": "Y", "stack__last": "Y", "unstack": "Y"}
NO_GRAD_OPS = {c for c in CASES if jreg.is_no_grad(c.split("__")[0])} | \
    {"gather__int"}
GRAD_CASES = sorted(c for c in CASES if c not in NO_GRAD_OPS)


def _op(case):
    return case.split("__")[0]


def test_the_cases_cover_the_slice():
    """Each of the 40 lowerings has a case here or a random-op test, in
    both packages; the port holds 311 with fusion_ops.py's 14, 297 before them
    (with test_torch_nn_ops.py's 24,
    test_torch_array_ops.py's 14, test_torch_sequence_ops.py's 15,
    sequence_mask among them, test_torch_rnn_ops.py's 8,
    test_torch_decode_ops.py's 6, test_torch_ctc_pool_ops.py's 9 and
    test_torch_detection_ops.py's 23, test_torch_quantize_ops.py's 8 and
    test_torch_parity_ops.py's 11, test_torch_fusion_ops.py's 14), and
    the JAX package's 6 others are what ROADMAP.md lists as still to
    port."""
    ops = {_op(c) for c in CASES} | set(RANDOM_OPS)
    assert len(ops) == 40
    assert all(treg.has_lowering(op) and jreg.has_lowering(op)
               for op in ops)
    assert len(treg._LOWERINGS) == 311
    assert set(treg._LOWERINGS) <= set(jreg._LOWERINGS)
    assert len(set(jreg._LOWERINGS) - set(treg._LOWERINGS)) == 6
    assert {op for op in jreg._LOWERINGS if op not in treg._LOWERINGS and
            jreg._LOWERINGS[op].__module__.endswith("tensor_ops")} == \
        {"with_sharding"}
    assert {op for op in ops if jreg.is_no_grad(op)} == \
        {op for op in ops if treg.is_no_grad(op)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    arrays, attrs = CASES[case]
    want, got = _run(_op(case), arrays, attrs)
    assert set(got) == set(want), (sorted(got), sorted(want))
    tol = F32_TOL if case in ADDS else 0.0
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for i, (g, w) in enumerate(zip(got[slot], want[slot])):
            _check(g, w, tol, err_msg="%s[%d]" % (slot, i))


BF16_CASES = sorted(c for c, (arrays, _) in CASES.items()
                    if any(a.dtype == np.float32 for v in arrays.values()
                           for a in v))


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_forward_matches_jax(case):
    """bfloat16 inputs: every output in the JAX lowering's dtype (none of
    these lowerings promotes; a pad value is rounded to bfloat16), equal
    to the JAX values but scatter's adds (2^-7 of the largest)."""
    arrays, attrs = CASES[case]
    want, got = _run(_op(case), arrays, attrs, bf16=True)
    tol = BF16_TOL if case in ADDS else 0.0
    for slot in want:
        for i, (g, w) in enumerate(zip(got[slot], want[slot])):
            assert str(g.dtype).replace("torch.", "") == str(w.dtype) or \
                (str(w.dtype) == "int32" and g.dtype == torch.int64), \
                (slot, g.dtype, w.dtype)
            _check(g, w, tol, err_msg="%s[%d]" % (slot, i))


def _float_keys(arrays):
    return [(k, i) for k, v in arrays.items() for i, a in enumerate(v)
            if a.dtype == np.float32]


def _cots(case, outs):
    return [_rng(9 + i).randn(*o.shape).astype(np.float32)
            for i, o in enumerate(outs)]


def _jax_vjps(cases, bf16):
    """{case: (cotangents, the JAX gradients)} in one jitted function."""
    fns, args, cots = [], [], []
    for case in cases:
        arrays, attrs = CASES[case]
        jin, _ = _inputs(arrays, bf16)
        keys = _float_keys(arrays)
        slot = GRAD_SLOT.get(case, "Out")

        def fn(*xs, jin=jin, keys=keys, attrs=attrs, case=case, slot=slot):
            ins = {k: list(v) for k, v in jin.items()}
            for (k, i), x in zip(keys, xs):
                ins[k][i] = x
            return tuple(jreg.get_lowering(_op(case))(
                jreg.LoweringContext(), ins, attrs)[slot])
        xs = [jin[k][i] for k, i in keys]
        fns.append(fn)
        args.append(xs)
        cots.append(_cots(case, jax.eval_shape(fn, *xs)))

    dtype = jnp.bfloat16 if bf16 else jnp.float32

    @jax.jit
    def all_vjps(args, cots):
        return [jax.vjp(fn, *xs)[1](tuple(c.astype(dtype) for c in cs))
                for fn, xs, cs in zip(fns, args, cots)]
    grads = all_vjps(args, [[jnp.asarray(c) for c in cs] for cs in cots])
    return {c: (cs, g) for c, cs, g in zip(cases, cots, grads)}


def _port_grads(case, cots, bf16):
    arrays, attrs = CASES[case]
    _, tin = _inputs(arrays, bf16)
    leaves = []
    for k, i in _float_keys(arrays):
        tin[k][i] = tin[k][i].clone().requires_grad_(True)
        leaves.append(tin[k][i])
    outs = treg.get_lowering(_op(case))(treg.LoweringContext("cpu"), tin,
                                        attrs)[GRAD_SLOT.get(case, "Out")]
    got = torch.autograd.grad(
        outs, leaves, [torch.from_numpy(c).to(o.dtype)
                       for c, o in zip(cots, outs)], allow_unused=True)
    return [torch.zeros_like(leaf) if g is None else g
            for leaf, g in zip(leaves, got)]


@pytest.fixture(scope="module")
def jax_vjps():
    return _jax_vjps(GRAD_CASES, bf16=False)


@pytest.fixture(scope="module")
def jax_vjps_bf16():
    return _jax_vjps(GRAD_CASES, bf16=True)


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gradient_matches_jax_vjp(case, jax_vjps):
    cots, want = jax_vjps[case]
    got = _port_grads(case, cots, bf16=False)
    assert len(got) == len(want)
    for key, g, w in zip(_float_keys(CASES[case][0]), got, want):
        _check(g, w, F32_TOL, err_msg="%s[%d]" % key)


@pytest.mark.parametrize("case", GRAD_CASES)
def test_bf16_gradient_matches_jax_vjp(case, jax_vjps_bf16):
    cots, want = jax_vjps_bf16[case]
    got = _port_grads(case, cots, bf16=True)
    for key, g, w in zip(_float_keys(CASES[case][0]), got, want):
        assert g.dtype == torch.bfloat16
        _check(g, w, BF16_TOL, err_msg="%s[%d]" % key)


# --------------------------------------------------------------------------
# the traps, pinned without the JAX package
# --------------------------------------------------------------------------

def _lower(op, inputs, attrs, gen=None):
    ctx = treg.LoweringContext("cpu", gen)
    return treg.get_lowering(op)(ctx, inputs, attrs)


def test_gather_gradient_sums_rows_through_scatter_rows(monkeypatch):
    """gather's gradient adds the output rows into X's rows through
    scatter_rows_ (the card's in-order route), not through index_select's
    autograd, and the same bits come out every run."""
    calls = []
    real = tensor_ops.scatter_rows_

    def counted(dst, rows, vals):
        calls.append(rows.clone())
        return real(dst, rows, vals)
    monkeypatch.setattr(tensor_ops, "scatter_rows_", counted)
    rng = _rng(3)
    x = torch.from_numpy(_randn(50, 8)).requires_grad_(True)
    idx = torch.from_numpy(rng.randint(-50, 60, (400, 1)))
    g = torch.from_numpy(_randn(400, 8, seed=4))
    runs = []
    for _ in range(2):
        out, = _lower("gather", {"X": [x], "Index": [idx]}, {})["Out"]
        runs.append(torch.autograd.grad(out, x, g)[0])
    assert len(calls) == 2 and torch.equal(calls[0], idx.reshape(-1))
    assert torch.equal(runs[0], runs[1])
    valid = (idx.reshape(-1) >= -50) & (idx.reshape(-1) < 50)
    want = torch.zeros(50, 8, dtype=torch.float64).index_add_(
        0, (idx.reshape(-1)[valid] + 50) % 50, g[valid].double())
    assert (runs[0].double() - want).abs().max() <= 1e-5


def test_scatter_overwrite_keeps_the_last_update_and_its_gradient():
    x = torch.zeros(4, 2, requires_grad=True)
    upd = torch.arange(10.0).reshape(5, 2).requires_grad_(True)
    ids = torch.tensor([[1], [3], [1], [-1], [4]])
    out, = _lower("scatter", {"X": [x], "Ids": [ids], "Updates": [upd]},
                  {"overwrite": True})["Out"]
    assert out.tolist() == [[0, 0], [4, 5], [0, 0], [6, 7]]
    gx, gu = torch.autograd.grad(out, [x, upd],
                                 torch.arange(1.0, 9.0).reshape(4, 2))
    assert gx.tolist() == [[1, 2], [0, 0], [5, 6], [0, 0]]
    assert gu.tolist() == [[0, 0], [0, 0], [3, 4], [7, 8], [0, 0]]


def test_scatter_overwrite_on_many_repeats_matches_jax():
    rng = _rng(5)
    ids = rng.randint(-40, 45, (3000, 1)).astype(np.int64)
    arrays = {"X": [_randn(40, 3)], "Ids": [ids],
              "Updates": [_randn(3000, 3, seed=6)]}
    want, got = _run("scatter", arrays, {"overwrite": True})
    _check(got["Out"][0], want["Out"][0])


def test_scatter_add_wraps_once_and_drops_out_of_range():
    x = torch.zeros(3, 1)
    ids = torch.tensor([[0], [-1], [-3], [-4], [3], [2]])
    upd = torch.tensor([[1.0], [2.0], [4.0], [8.0], [16.0], [32.0]])
    out, = _lower("scatter", {"X": [x], "Ids": [ids], "Updates": [upd]},
                  {"overwrite": False})["Out"]
    assert out.reshape(-1).tolist() == [5.0, 0.0, 34.0]


def test_argsort_is_stable_with_nans_last_in_bf16():
    x = torch.tensor([[1.0, float("nan"), 1.0, -0.0, 0.0, 1.0,
                       float("-inf")]], dtype=torch.bfloat16)
    out = _lower("argsort", {"X": [x]}, {"axis": -1})
    assert out["Indices"][0].tolist() == [[6, 3, 4, 0, 2, 5, 1]]
    assert out["Indices"][0].dtype == torch.int64
    assert out["Out"][0].dtype == torch.bfloat16


@pytest.mark.parametrize("op,want", [("arg_max", [1, 1, 0]),
                                     ("arg_min", [2, 1, 0])])
def test_arg_ops_take_the_first_tie_and_the_first_nan(op, want):
    x = torch.tensor([[1.0, 3.0, 0.0, 3.0], [0.0, float("nan"), 9.0,
                                              float("nan")],
                      [0.0, -0.0, 0.0, 0.0]])
    out, = _lower(op, {"X": [x]}, {"axis": 1})["Out"]
    assert out.dtype == torch.int64 and out.tolist() == want


def test_pad2d_pads_wider_than_the_axis_where_f_pad_refuses():
    x = torch.from_numpy(_randn(1, 1, 3, 2))
    with pytest.raises(RuntimeError):
        torch.nn.functional.pad(x, [3, 3, 0, 0], mode="reflect")
    out, = _lower("pad2d", {"X": [x]}, {"paddings": [0, 0, 3, 3],
                                        "mode": "reflect"})["Out"]
    np.testing.assert_array_equal(
        out.numpy(), np.pad(x.numpy(), [(0, 0), (0, 0), (0, 0), (3, 3)],
                            mode="reflect"))


@pytest.mark.parametrize("start,end,step,length", [
    (0.0, 1.0, 0.1, 10), (0.0, 1.0, 0.3, 4), (1.0, 2.0, 0.2, 5),
    (0.0, 0.9, 0.3, 3), (5.0, 1.0, -0.5, 8)])
def test_range_static_lengths_match_jnp_arange(start, end, step, length):
    out, = _lower("range_static", {}, {"start": start, "end": end,
                                       "step": step,
                                       "dtype": "float32"})["Out"]
    want = np.asarray(jnp.arange(start, end, step))
    assert out.shape == (length,) == want.shape
    np.testing.assert_array_equal(out.numpy(), want)


def test_shape_isinf_isnan_outputs():
    x = torch.zeros(2, 3, 4, dtype=torch.bfloat16)
    shape, = _lower("shape", {"Input": [x]}, {})["Out"]
    assert shape.dtype == torch.int32 and shape.tolist() == [2, 3, 4]
    for op in ("isinf", "isnan"):
        out, = _lower(op, {"X": [x]}, {})["Out"]
        assert out.dtype == torch.bool and out.tolist() == [False]


def test_bf16_pad_value_rounds_to_bf16():
    x = torch.zeros(2, 2, dtype=torch.bfloat16)
    for op, inputs, attrs in [
            ("pad", {"X": [x]}, {"paddings": [0, 1, 0, 0],
                                 "pad_value": 0.1}),
            ("pad2d", {"X": [x[None, None]]}, {"paddings": [0, 1, 0, 0],
                                               "pad_value": 0.1}),
            ("pad_constant_like", {"X": [torch.zeros(3, 2)], "Y": [x]},
             {"pad_value": 0.1})]:
        out, = _lower(op, inputs, attrs)["Out"]
        assert out.dtype == torch.bfloat16, op
        assert out.reshape(-1)[-1].item() == \
            torch.tensor(0.1, dtype=torch.bfloat16).item(), op


def test_split_refuses_an_axis_num_does_not_divide():
    with pytest.raises(ValueError):
        _lower("split", {"X": [torch.zeros(2, 5)]}, {"axis": 1, "num": 2})


# --------------------------------------------------------------------------
# the random ops, by invariants
# --------------------------------------------------------------------------

def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _moments_within(x, mean, var, fourth, n_se=5.0):
    """The sample mean and variance of x within n_se standard errors of
    the distribution's (fourth: its fourth central moment)."""
    x = x.double()
    n = x.numel()
    m = float(x.mean())
    v = float(((x - m) ** 2).mean())
    assert abs(m - mean) <= n_se * math.sqrt(var / n), (m, mean)
    assert abs(v - var) <= n_se * math.sqrt((fourth - var ** 2) / n), \
        (v, var)


def _trunc_moments():
    """Variance and fourth moment of a standard normal truncated to
    [-2, 2]."""
    pdf = math.exp(-2.0) / math.sqrt(2 * math.pi)
    z = math.erf(2 / math.sqrt(2))
    var = 1 - 4 * pdf / z
    return var, 3 - 2 * 2 * (4 + 3) * pdf / z


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_size_like_random_ops(dtype):
    ref = torch.zeros(7, 3)
    attrs = {"shape": [-1, 2000], "dtype": dtype, "seed": 0}
    u, = _lower("uniform_random_batch_size_like", {"Input": [ref]},
                dict(attrs, min=-2.0, max=3.0), _gen())["Out"]
    g, = _lower("gaussian_random_batch_size_like", {"Input": [ref]},
                dict(attrs, mean=1.0, std=0.5), _gen(1))["Out"]
    for out in (u, g):
        assert tuple(out.shape) == (7, 2000)
        assert str(out.dtype) == "torch." + dtype
    assert float(u.min()) >= -2.0 and float(u.max()) <= 3.0
    if dtype == "float32":
        _moments_within(u, 0.5, 25.0 / 12, 625.0 / 80)
        _moments_within(g, 1.0, 0.25, 3 * 0.25 ** 2)
    jin, _ = _inputs({"Input": [np.zeros((7, 3), np.float32)]})
    want = jreg.get_lowering("uniform_random_batch_size_like")(
        jreg.LoweringContext(), jin, dict(attrs, min=-2.0, max=3.0))
    assert want["Out"][0].shape == tuple(u.shape)


def test_truncated_gaussian_is_cut_at_two_std_and_not_rescaled():
    out, = _lower("truncated_gaussian_random", {},
                  {"shape": [400, 500], "mean": 0.5, "std": 0.02,
                   "dtype": "float32"}, _gen())["Out"]
    assert float((out - 0.5).abs().max()) <= 2 * 0.02 * (1 + 1e-6)
    var, fourth = _trunc_moments()
    assert abs(var - 0.7737) < 1e-4
    _moments_within((out - 0.5) / 0.02, 0.0, var, fourth)


def _chi_square_p(ids, probs):
    """p-value of the chi-square test of `ids`' counts against `probs`."""
    from scipy import stats
    counts = np.bincount(ids, minlength=len(probs))
    expected = probs * len(ids)
    return stats.chi2.sf(((counts - expected) ** 2 / expected).sum(),
                         len(probs) - 1)


def test_sampling_id_draws_each_rows_distribution():
    """65,536 rows of one 16-class distribution: the draws pass a
    chi-square test against it (p > 1e-4) and fail it against the
    distribution shifted by one class; min, max and dtype do nothing."""
    probs = np.linspace(1.0, 4.0, 16)
    probs /= probs.sum()
    x = torch.from_numpy(np.tile(probs, (65536, 1)).astype(np.float32))
    attrs = {"seed": 0, "min": 0.3, "max": 0.4, "dtype": "int32"}
    ids, = _lower("sampling_id", {"X": [x]}, attrs, _gen())["Out"]
    assert ids.dtype == torch.int64 and tuple(ids.shape) == (65536,)
    assert int(ids.min()) >= 0 and int(ids.max()) < 16
    assert _chi_square_p(ids.numpy(), probs) > 1e-4
    assert _chi_square_p(ids.numpy(), np.roll(probs, 1)) < 1e-4
    # a zero probability is never drawn
    x[:, 5] = 0.0
    ids, = _lower("sampling_id", {"X": [x]}, attrs, _gen(1))["Out"]
    assert not bool((ids == 5).any())


def test_random_crop_cuts_one_window_for_the_batch():
    x = torch.arange(4 * 3 * 9 * 8, dtype=torch.float32).reshape(4, 3, 9, 8)
    starts = set()
    for seed in range(20):
        out = _lower("random_crop", {"X": [x]}, {"shape": [5, 4], "seed": 0},
                     _gen(seed))
        crop = out["Out"][0]
        assert tuple(crop.shape) == (4, 3, 5, 4)
        assert out["SeedOut"][0].dtype == torch.int64 and \
            out["SeedOut"][0].tolist() == [0]
        r0, c0 = divmod(int(crop[0, 0, 0, 0]), 8)
        assert torch.equal(crop, x[:, :, r0:r0 + 5, c0:c0 + 4])
        starts.add((r0, c0))
    assert len(starts) > 5 and all(r <= 4 and c <= 4 for r, c in starts)
    jin, _ = _inputs({"X": [x.numpy()]})
    want = jreg.get_lowering("random_crop")(jreg.LoweringContext(), jin,
                                            {"shape": [5, 4], "seed": 0})
    assert want["Out"][0].shape == tuple(crop.shape)
