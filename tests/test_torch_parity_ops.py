"""The remaining parity lowerings (``paddle_tpu_torch/fluid/ops/
parity_ops.py``'s 11) against the JAX package's on the same seeded numpy
inputs, on the CPU.

- Forwards: every output of every case. Integers exactly, with their
  dtypes (chunk counts, pair counts held in float32, quantized values,
  hash buckets, looked-up ids); floats within 1e-6 of the largest JAX
  magnitude. The JAX lowerings' int64 outputs come as int32 (x64 off),
  the port's as int64.
- chunk_eval: every scheme, excluded types, with and without Length, a
  3-D input, and inferences that agree with the labels but for a few
  positions, so that matches open, stay open, break and close; the
  closed form of the matching recurrence against a Python loop of the
  JAX scan's step.
- hash over ids past 2**31 and negative ids: the buckets equal the JAX
  package's; without its position salt a reordered row would hash alike.
- The channel-wise quantize on a conv filter with a zero channel (its own
  1e-12 epsilon); ref_by_trainer_id and lookup_sparse_table at ids past
  their ends.
- Gradients of the two channel-wise ops (the only ones with one):
  ``jax.vjp`` against autograd, within 1e-5 of the largest JAX gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid  # noqa: F401  (registers the JAX lowerings)
import paddle_tpu_torch.fluid  # noqa: F401
from paddle_tpu.fluid.ops import registry as jreg
from paddle_tpu_torch.fluid.ops import parity_ops
from paddle_tpu_torch.fluid.ops import registry as treg

TOL = 1e-6
GRAD_TOL = 1e-5
PARITY_OPS = {"chunk_eval", "positive_negative_pair",
              "fake_channel_wise_quantize_abs_max",
              "fake_channel_wise_dequantize_max_abs", "requantize", "hash",
              "split_selected_rows", "split_byref", "alloc_continuous_space",
              "ref_by_trainer_id", "lookup_sparse_table"}
# float input -> output slot whose gradient is taken
GRAD_SLOTS = {"fake_channel_wise_quantize_abs_max": ("X", "OutScale"),
              "fake_channel_wise_dequantize_max_abs": ("X", "Out")}
# output slots that hold integers in float32
EXACT = {"positive_negative_pair": {"PositivePair", "NegativePair",
                                    "NeutralPair"},
         "fake_channel_wise_quantize_abs_max": {"Out"}}


def _rng(seed):
    return np.random.RandomState(seed)


def _randn(*shape, seed=0):
    return _rng(seed).randn(*shape).astype(np.float32)


def _tags(b, t, high, seed, agree=None):
    """Label ids [B, T] uniform in [0, high); with `agree` (a label
    array), that array with about one position in five redrawn."""
    r = _rng(seed)
    if agree is None:
        return r.randint(0, high, (b, t)).astype(np.int64)
    out = agree.copy()
    flip = r.rand(*agree.shape) < 0.2
    out[flip] = r.randint(0, high, int(flip.sum()))
    return out


def _chunk_in(scheme, num_types, b=6, t=20, seed=0, length=True,
              excluded=None, three_d=False):
    ntag = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    high = num_types * ntag + 1          # the "other" id included
    lab = _tags(b, t, high, seed)
    inf = _tags(b, t, high, seed + 1, agree=lab)
    d = {"Inference": [inf], "Label": [lab]}
    if three_d:
        d = {k: [v[0][..., None]] for k, v in d.items()}
    if length:
        d["Length"] = [_rng(seed + 2).randint(1, t + 1, b).astype(np.int64)]
    return d, {"chunk_scheme": scheme, "num_chunk_types": num_types,
               "excluded_chunk_types": excluded or []}


def _pair_in(acc, seed=20):
    r = _rng(seed)
    n = 40
    d = {"Score": [np.round(r.rand(n, 1) * 4).astype(np.float32) / 4],
         "Label": [r.randint(0, 3, (n, 1)).astype(np.float32)],
         "QueryID": [r.randint(0, 5, (n, 1)).astype(np.int64)]}
    if acc:
        for k in ("Positive", "Negative", "Neutral"):
            d["Accumulate%sPair" % k] = [np.array([r.randint(0, 50)],
                                                  np.float32)]
    return d, {}


def _filter(seed=30):
    w = _randn(16, 8, 3, 3, seed=seed) * 0.1
    w[3] = 0.0                            # a zero channel
    return w


def _ids(b, f, seed, big=False):
    r = _rng(seed)
    ids = r.randint(0, 100000, (b, f)).astype(np.int64)
    if big:
        ids[0, :3] = [2 ** 31 - 1, -5, 123456789]
    return ids


CASES = {
    "chunk_eval__iob": _chunk_in("IOB", 3),
    "chunk_eval__iob_no_length": _chunk_in("IOB", 4, seed=3, length=False),
    "chunk_eval__ioe": _chunk_in("IOE", 3, seed=4),
    "chunk_eval__iobes": _chunk_in("IOBES", 2, seed=5),
    "chunk_eval__plain": _chunk_in("plain", 5, seed=6),
    "chunk_eval__excluded": _chunk_in("IOB", 4, seed=7, excluded=[1, 3]),
    "chunk_eval__3d": _chunk_in("IOB", 29, b=10, t=64, seed=8,
                                length=False, three_d=True),
    "chunk_eval__equal": ({"Inference": [_tags(4, 30, 7, 9)],
                           "Label": [_tags(4, 30, 7, 9)]},
                          {"chunk_scheme": "IOB", "num_chunk_types": 3}),
    "positive_negative_pair": _pair_in(False),
    "positive_negative_pair__accumulate": _pair_in(True, seed=21),
    "fake_channel_wise_quantize_abs_max": ({"X": [_filter()]},
                                           {"bit_length": 8}),
    "fake_channel_wise_quantize_abs_max__bits4": (
        {"X": [_randn(12, 20, seed=31)]}, {"bit_length": 4}),
    "fake_channel_wise_dequantize_max_abs": (
        {"X": [np.round(_randn(16, 8, 3, 3, seed=32) * 40)],
         "Scales": [np.abs(_randn(16, seed=33))]}, {"quant_bits": [8]}),
    "fake_channel_wise_dequantize_max_abs__two_scales": (
        {"X": [np.round(_randn(16, 24, seed=34) * 40)],
         "Scales": [np.abs(_randn(16, seed=35)),
                    np.array([3.5], np.float32)]},
        {"quant_bits": [8, 8]}),
    "requantize": ({"Input": [_rng(36).randint(-128, 128, (4, 64, 7, 7))
                              .astype(np.int8)]},
                   {"Scale_in": 40.0, "Scale_out": 25.0}),
    "hash": ({"X": [_ids(64, 26, 40, big=True)]},
             {"num_hash": 2, "mod_by": 100000}),
    "hash__one_column": ({"X": [_ids(32, 1, 41)]},
                         {"num_hash": 4, "mod_by": 1000}),
    "split_selected_rows": ({"X": [_randn(10, 4, seed=50)]},
                            {"height_sections": [3, 5, 2]}),
    "split_byref": ({"X": [_randn(12, 4, seed=51)]},
                    {"sections": [4, 8], "axis": 0}),
    "split_byref__num": ({"X": [_randn(12, 6, seed=52)]},
                         {"num": 3, "axis": 1}),
    "alloc_continuous_space": ({"Input": [_randn(3, 4, seed=53),
                                          _randn(5, seed=54)]}, {}),
    "alloc_continuous_space__constant": (
        {"Input": [_randn(3, 4, seed=55), _randn(2, 2, 2, seed=56)]},
        {"set_constant": True, "constant": 0.5}),
    "ref_by_trainer_id": ({"X": [_randn(4, 3, seed=60 + k)
                                 for k in range(3)],
                           "TrainerId": [np.array([2], np.int64)]}, {}),
    "ref_by_trainer_id__negative": ({"X": [_randn(4, 3, seed=63 + k)
                                           for k in range(3)],
                                     "TrainerId": [np.array([-1],
                                                            np.int64)]}, {}),
    "ref_by_trainer_id__past_the_end": (
        {"X": [_randn(4, 3, seed=66 + k) for k in range(3)],
         "TrainerId": [np.array([5], np.int64)]}, {}),
    "lookup_sparse_table": ({"W": [_randn(1000, 10, seed=70)],
                             "Ids": [_rng(71).randint(0, 1000, (64, 1))
                                     .astype(np.int64)]}, {}),
    "lookup_sparse_table__out_of_range": (
        {"W": [_randn(50, 10, seed=72)],
         "Ids": [np.array([[0], [49], [50], [1000], [-3]], np.int64)]}, {}),
}


def _op(case):
    return case.split("__")[0]


def _j(arrays):
    return {k: [jnp.asarray(a) for a in v] for k, v in arrays.items()}


def _t(arrays):
    return {k: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
            for k, v in arrays.items()}


def _jax(op, arrays, attrs):
    return jax.jit(lambda ins: jreg.get_lowering(op)(
        jreg.LoweringContext(), ins, attrs))(_j(arrays))


def _port(op, arrays, attrs):
    return treg.get_lowering(op)(treg.LoweringContext("cpu"), _t(arrays),
                                 attrs)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().numpy()
    return np.asarray(x)


def _check(got, want, msg, tol=TOL, exact=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    if want.dtype.kind in "iub":
        want_dtype = np.int64 if want.dtype == np.int32 else want.dtype
        assert got.dtype == want_dtype, (got.dtype, want.dtype, msg)
        np.testing.assert_array_equal(got, want, msg)
        return
    assert got.dtype == want.dtype, (got.dtype, want.dtype, msg)
    if exact:
        np.testing.assert_array_equal(got, want, msg)
        return
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, msg)
    got, want = got[~nan].astype(np.float64), want[~nan].astype(np.float64)
    if got.size:
        bound = tol * (np.abs(want).max() or 1.0)
        assert np.abs(got - want).max() <= bound, (
            msg, np.abs(got - want).max(), bound)


def test_the_cases_cover_the_slice():
    """The 11 lowerings of the JAX parity_ops.py, each with a case,
    registered in the port's parity_ops.py with the same no-grad flags;
    the port holds 311 with fusion_ops.py's 14, 297 before them (278 before
    this slice, 8 more with
    quantize_ops.py), none the JAX package lacks."""
    assert {_op(c) for c in CASES} == PARITY_OPS
    assert {op for op in jreg._LOWERINGS if jreg._LOWERINGS[op].__module__
            .endswith("parity_ops")} == PARITY_OPS
    assert all(treg._LOWERINGS[op].__module__.endswith("parity_ops")
               for op in PARITY_OPS)
    for op in PARITY_OPS:
        assert jreg.is_no_grad(op) == treg.is_no_grad(op), op
    assert {op for op in PARITY_OPS if not treg.is_no_grad(op)} == \
        set(GRAD_SLOTS)
    assert len(treg._LOWERINGS) == 311
    assert set(treg._LOWERINGS) <= set(jreg._LOWERINGS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    arrays, attrs = CASES[case]
    want = _jax(_op(case), arrays, attrs)
    got = _port(_op(case), arrays, attrs)
    assert set(got) == set(want)
    for slot, w in want.items():
        assert len(got[slot]) == len(w), slot
        for k, (g, v) in enumerate(zip(got[slot], w)):
            _check(g, v, "%s %s[%d]" % (case, slot, k),
                   exact=slot in EXACT.get(_op(case), ()))


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


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if _op(c) in GRAD_SLOTS))
def test_gradient_matches_jax_vjp(case):
    op = _op(case)
    arrays, attrs = CASES[case]
    x_slot, out_slot = GRAD_SLOTS[op]

    def jfn(x):
        ins = _j(arrays)
        ins[x_slot] = [x]
        return jreg.get_lowering(op)(jreg.LoweringContext(), ins,
                                     attrs)[out_slot][0]
    x = jnp.asarray(arrays[x_slot][0])
    cot = _randn(*jax.eval_shape(jfn, x).shape, seed=99)
    want = jax.jit(lambda x, c: jax.vjp(jfn, x)[1](c)[0])(
        x, jnp.asarray(cot))
    ins = _t(arrays)
    leaf = ins[x_slot][0].clone().requires_grad_(True)
    ins[x_slot] = [leaf]
    out = treg.get_lowering(op)(treg.LoweringContext("cpu"), ins,
                                attrs)[out_slot][0]
    got, = torch.autograd.grad(out, leaf, torch.from_numpy(cot))
    _check(got, want, case, GRAD_TOL)
    assert np.abs(_np(want)).max() > 0


def _scan_matches(ib, ie, ity, lb, le, lty):
    """The JAX lowering's scan step, a Python loop over T per row."""
    out = np.zeros(ib.shape, bool)
    for r in range(ib.shape[0]):
        matching = False
        for t in range(ib.shape[1]):
            both = ib[r, t] and lb[r, t] and ity[r, t] == lty[r, t] and \
                ity[r, t] >= 0
            same = ib[r, t] == lb[r, t] and ie[r, t] == le[r, t] and \
                ity[r, t] == lty[r, t]
            matching = True if both else (matching and same)
            out[r, t] = matching and ie[r, t] and le[r, t]
            matching = matching and not (ie[r, t] or le[r, t])
    return out


@pytest.mark.parametrize("seed", range(6))
def test_matching_in_closed_form_is_the_scan(seed):
    r = _rng(seed)
    shape = (8, 40)

    def near(a, p):
        """a with about a fraction p of its positions redrawn."""
        flip = r.rand(*shape) < p
        return np.where(flip, r.randint(0, 2, shape).astype(a.dtype), a)
    ib, ie = r.rand(*shape) < 0.3, r.rand(*shape) < 0.35
    ity = r.randint(-1, 2, shape)
    lb, le = near(ib, 0.1), near(ie, 0.1)
    lty = np.where(r.rand(*shape) < 0.1, r.randint(-1, 2, shape), ity)
    want = _scan_matches(ib, ie, ity, lb, le, lty)
    got = parity_ops.matched_chunks(*(torch.from_numpy(a) for a in (
        ib, ie, ity, lb, le, lty))).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any()


def test_chunk_eval_scores_some_chunks_right():
    """The agreeing cases score between 0 and 1 (not a degenerate 0 or
    1), and equal inputs score 1."""
    for case in ("chunk_eval__iob", "chunk_eval__3d"):
        out = _port("chunk_eval", *CASES[case])
        assert 0 < float(out["F1-Score"][0]) < 1, case
    out = _port("chunk_eval", *CASES["chunk_eval__equal"])
    assert float(out["F1-Score"][0]) == 1.0
    assert int(out["NumCorrectChunks"][0]) > 0


def test_hash_salt_orders_a_row():
    """[a, b] and [b, a] hash apart (the position salt), in both
    packages alike."""
    x = np.array([[11, 22], [22, 11]], np.int64)
    attrs = {"num_hash": 2, "mod_by": 1 << 30}
    got = _port("hash", {"X": [x]}, attrs)["Out"][0].numpy()
    assert (got[0] != got[1]).all()
    np.testing.assert_array_equal(
        got, _np(_jax("hash", {"X": [x]}, attrs)["Out"][0]))


def test_mul32_wraps_as_uint32():
    r = _rng(80)
    a = r.randint(0, 2 ** 32, 1000, dtype=np.uint64)
    b = r.randint(0, 2 ** 32, 1000, dtype=np.uint64)
    want = (a.astype(np.uint32) * b.astype(np.uint32)).astype(np.int64)
    got = parity_ops.mul32(torch.from_numpy(a.astype(np.int64)),
                           torch.from_numpy(b.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
