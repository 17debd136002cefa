"""The sequence lowerings (``paddle_tpu_torch/fluid/ops/sequence_ops.py``'s
14 and ``sequence_mask`` in ``tensor_ops.py``), each against the JAX
package's lowering of the same op on the same seeded numpy inputs, on the
CPU.

The inputs: a padded batch [B 4, T 5, D 3] whose rows have lengths 0, 1,
T and a mixed one (and no Length input, where the op takes none), in
float32 and in bfloat16; every pool type, ties under MAX (integer-valued
inputs); ids with repeats, negative and out-of-range entries for
sequence_scatter.

Tolerance: ops that move, pick or mask values (reverse, expand, concat,
pad, unpad, slice, enumerate, reshape, erase, mask, the MAX, LAST and
FIRST pools) give the JAX values exactly, -inf and NaN in the same
places, in float32 and in bfloat16; ops that add (the SUM, AVERAGE and
SQRT pools, softmax, sequence_conv's product, scatter) within 1e-5
(float32) or 2^-7 (bfloat16) of the largest JAX magnitude. Integer
outputs are equal (the JAX package's int32 where the port's are int64, x64
being off). Gradients: ``jax.vjp`` of the JAX lowering (one jitted function
for each dtype) against autograd through the port's lowering, within 1e-5
(float32) or 2^-7 (bfloat16) of the largest JAX magnitude; a tie under
MAX splits its gradient evenly in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.fluid.ops import registry as jreg
from paddle_tpu_torch.fluid.ops import registry as treg

F32_TOL, BF16_TOL = 1e-5, 2.0 ** -7
B, T, D = 4, 5, 3
LENS = np.array([0, 1, T, 3], np.int64)


def _rng(seed):
    return np.random.RandomState(seed)


def _randn(*shape, seed=0):
    return _rng(seed).randn(*shape).astype(np.float32)


def _ties(*shape, seed=0):
    """Integer values in [-2, 2] as float32: ties in every row."""
    return _rng(seed).randint(-2, 3, shape).astype(np.float32)


def _ids(*shape, seed=0, high=7):
    return _rng(seed).randint(0, high, shape).astype(np.int64)


POOLS = ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST")

# case -> (op, inputs, attrs). The op is the case's name up to "__".
CASES = {}
for _p in POOLS:
    CASES["sequence_pool__" + _p.lower()] = (
        {"X": [_randn(B, T, D, seed=1)], "Length": [LENS]},
        {"pooltype": _p})
    CASES["sequence_pool__" + _p.lower() + "_no_length"] = (
        {"X": [_randn(B, T, D, seed=2)]}, {"pooltype": _p})
CASES.update({
    "sequence_pool__max_ties": (
        {"X": [_ties(B, T, D, seed=3)], "Length": [LENS]},
        {"pooltype": "MAX"}),
    "sequence_pool__2d_average": (
        {"X": [_randn(B, T, seed=4)], "Length": [LENS]},
        {"pooltype": "AVERAGE"}),
    "sequence_pool__long_rows_sqrt": (
        # lengths past 256: AVERAGE and SQRT divide by the length in x's
        # dtype (bfloat16 rounds 300 to 300 and 299 to 300)
        {"X": [_randn(2, 300, 2, seed=5)],
         "Length": [np.array([299, 300], np.int64)]},
        {"pooltype": "SQRT"}),
    "sequence_softmax": ({"X": [_randn(B, T, seed=6)], "Length": [LENS]},
                         {}),
    "sequence_softmax__no_length": ({"X": [_randn(B, T, seed=7)]}, {}),
    "sequence_reverse": ({"X": [_randn(B, T, D, seed=8)],
                          "Length": [LENS]}, {}),
    "sequence_reverse__2d": ({"X": [_randn(B, T, seed=9)],
                              "Length": [LENS]}, {}),
    "sequence_reverse__no_length": ({"X": [_randn(B, T, D, seed=10)]}, {}),
    "sequence_expand": ({"X": [_randn(B, D, seed=11)],
                         "Y": [_randn(B, T, D, seed=12)]}, {}),
    "sequence_expand__time_one": ({"X": [_randn(B, 1, D, seed=13)],
                                   "Y": [_randn(B, T, D, seed=14)]}, {}),
    "sequence_expand__same_length": ({"X": [_randn(B, T, D, seed=15)],
                                      "Y": [_randn(B, T, D, seed=16)]}, {}),
    "sequence_expand_as": ({"X": [_randn(B, D, seed=17)],
                            "Y": [_randn(B, T, D, seed=18)]}, {}),
    "sequence_concat": (
        {"X": [_randn(B, T, D, seed=19), _randn(B, 3, D, seed=20)],
         "Length": [LENS, np.array([2, 0, 3, 1], np.int64)]}, {}),
    "sequence_concat__no_length": (
        {"X": [_randn(B, T, D, seed=21), _randn(B, 2, D, seed=22)]}, {}),
    "sequence_conv": (
        {"X": [_randn(B, T, D, seed=23)], "Filter": [_randn(3 * D, 4,
                                                            seed=24)],
         "Length": [LENS]}, {"contextLength": 3, "contextStart": -1}),
    "sequence_conv__window_4": (
        {"X": [_randn(B, T, D, seed=25)], "Filter": [_randn(4 * D, 2,
                                                            seed=26)],
         "Length": [LENS]}, {"contextLength": 4, "contextStart": -2}),
    "sequence_conv__no_length": (
        {"X": [_randn(B, T, D, seed=27)], "Filter": [_randn(3 * D, 4,
                                                            seed=28)]},
        {"contextLength": 3, "contextStart": -1}),
    "sequence_pad": (
        {"X": [_randn(B, T, D, seed=29)], "Length": [LENS],
         "PadValue": [np.array([0.75], np.float32)]},
        {"padded_length": 7}),
    "sequence_pad__cut": (
        {"X": [_randn(B, T, D, seed=30)], "Length": [LENS],
         "PadValue": [np.array([0.0], np.float32)]}, {"padded_length": 3}),
    "sequence_pad__no_length": (
        {"X": [_randn(B, T, D, seed=31)],
         "PadValue": [np.array([1.5], np.float32)]}, {"padded_length": -1}),
    "sequence_unpad": ({"X": [_randn(B, T, D, seed=32)],
                        "Length": [LENS]}, {}),
    "sequence_slice": (
        {"X": [_randn(B, T, D, seed=33)],
         # row 2's slice runs past T: its source clamps to T - 1
         "Offset": [np.array([[0], [1], [3], [2]], np.int64)],
         "Length": [np.array([[2], [1], [4], [0]], np.int64)]}, {}),
    "sequence_enumerate": (
        {"X": [_ids(B, T, seed=34)], "Length": [LENS]},
        {"win_size": 3, "pad_value": 0}),
    "sequence_enumerate__no_length": (
        {"X": [_ids(B, T, seed=35)]}, {"win_size": 2, "pad_value": 9}),
    "sequence_reshape": ({"X": [_randn(B, T, 4, seed=36)]}, {"new_dim": 2}),
    "sequence_erase": (
        {"X": [_ids(B, T, seed=37)], "Length": [LENS]},
        {"tokens": [2, 5]}),
    "sequence_erase__no_length": (
        {"X": [_ids(B, T, seed=38)]}, {"tokens": [0]}),
    "sequence_scatter": (
        {"X": [_randn(B, 6, seed=39)],
         # repeats, a negative id (wraps once) and one past the end
         "Ids": [np.array([[0, 0, 5], [1, -1, 6], [2, 2, 2], [-7, 3, 4]],
                          np.int64)],
         "Updates": [_randn(B, 3, seed=40)]}, {}),
    "sequence_mask": ({"X": [LENS]}, {"maxlen": 6, "out_dtype": "int64"}),
    "sequence_mask__float": ({"X": [LENS.reshape(-1, 1)]},
                             {"maxlen": 4, "out_dtype": "float32"}),
})
# cases whose outputs add (tolerance); the rest move or pick values (exact)
ADDS = {c for c in CASES if c.startswith(("sequence_softmax",
                                          "sequence_conv",
                                          "sequence_scatter"))} | \
    {c for c in CASES if c.startswith("sequence_pool") and
     any(p in c for p in ("_sum", "_average", "_sqrt"))}
GRAD_SLOT = {c: "Y" for c in CASES if c.startswith("sequence_reverse")}
GRAD_CASES = sorted(c for c in CASES
                    if not jreg.is_no_grad(c.split("__")[0]))


def _op(case):
    return case.split("__")[0]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        x = x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    if x.dtype.kind in "iu":
        return x.astype(np.int64)
    return x if x.dtype == bool else x.astype(np.float64)


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
    """Equal shapes, NaNs and infinities; elsewhere |got - want| <= tol *
    max |want| (exact at tol 0)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    if want.dtype == bool or want.dtype.kind == "i":
        np.testing.assert_array_equal(got, want, err_msg=err_msg)
        return
    odd = ~np.isfinite(want)
    np.testing.assert_array_equal(got[odd], want[odd], err_msg=err_msg)
    np.testing.assert_array_equal(np.isfinite(got), ~odd, err_msg=err_msg)
    got, want = got[~odd], want[~odd]
    if not want.size:
        return
    if tol == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=err_msg)
    else:
        bound = tol * np.abs(want).max()
        assert np.abs(got - want).max() <= bound, (err_msg, np.abs(
            got - want).max(), bound)


SEQ_OPS = {"sequence_pool", "sequence_softmax", "sequence_reverse",
           "sequence_expand", "sequence_expand_as", "sequence_concat",
           "sequence_conv", "sequence_pad", "sequence_unpad",
           "sequence_slice", "sequence_enumerate", "sequence_reshape",
           "sequence_erase", "sequence_scatter"}


def test_the_cases_cover_the_slice():
    """The 15 lowerings (sequence_ops.py's 14 and sequence_mask), each with
    a case, in both packages, with the same no-grad ones (enumerate, erase,
    mask); every pool type; the port holds 297 (with the recurrent,
    decoding and CTC slices' 8, 6 and 9), none the JAX package lacks."""
    ops = {_op(c) for c in CASES}
    assert ops == SEQ_OPS | {"sequence_mask"} and len(ops) == 15
    assert {op for op in jreg._LOWERINGS if jreg._LOWERINGS[op].__module__
            .endswith("sequence_ops")} == SEQ_OPS
    assert all(treg.has_lowering(op) for op in ops)
    assert {op for op in ops if jreg.is_no_grad(op)} == \
        {op for op in ops if treg.is_no_grad(op)} == \
        {"sequence_enumerate", "sequence_erase", "sequence_mask"}
    assert {CASES[c][1]["pooltype"] for c in CASES
            if _op(c) == "sequence_pool"} == set(POOLS)
    assert len(treg._LOWERINGS) == 297
    assert set(treg._LOWERINGS) <= set(jreg._LOWERINGS)


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
    """bfloat16 inputs: every output in the JAX lowering's dtype (int32
    there, int64 here), equal to the JAX values but the adding ops' (2^-7
    of the largest)."""
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
            if a.dtype == np.float32 and k != "PadValue"]


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
        cots.append([_rng(9 + i).randn(*o.shape).astype(np.float32)
                     for i, o in enumerate(jax.eval_shape(fn, *xs))])

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
    assert len(got) == len(want) == len(_float_keys(CASES[case][0]))
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

def _lower(op, inputs, attrs):
    return treg.get_lowering(op)(treg.LoweringContext("cpu"), inputs, attrs)


def test_max_pool_splits_a_tie_evenly_and_indexes_the_first():
    """Row [1, 3, 3, 0] of length 4: MaxIndex 1 (int32), and each of the
    two 3s takes half the gradient; a length-0 row pools to -inf with no
    gradient."""
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0], [5.0, 6.0, 7.0, 8.0]],
                     requires_grad=True)
    out = _lower("sequence_pool", {"X": [x], "Length": [torch.tensor(
        [4, 0])]}, {"pooltype": "MAX"})
    assert out["MaxIndex"][0].dtype == torch.int32
    assert out["MaxIndex"][0].tolist() == [1, 0]
    assert out["Out"][0][0].item() == 3.0
    assert out["Out"][0][1].item() == float("-inf")
    g, = torch.autograd.grad(out["Out"][0], x, torch.tensor([1.0, 1.0]))
    assert g.tolist() == [[0.0, 0.5, 0.5, 0.0], [0.0] * 4]


def test_pad_positions_do_not_reach_any_output():
    """Rewriting the pad positions of x leaves every masked op's output
    unchanged bit for bit (the SUM pool, sequence_conv, reverse, unpad,
    softmax)."""
    lens = torch.tensor(LENS)
    x = torch.from_numpy(_randn(B, T, D, seed=50))
    y = x.clone()
    pad = torch.arange(T)[None, :] >= lens[:, None]
    y[pad] = 1e6
    w = torch.from_numpy(_randn(3 * D, 2, seed=51))
    for op, ins, attrs, slot in [
            ("sequence_pool", {}, {"pooltype": "SUM"}, "Out"),
            ("sequence_pool", {}, {"pooltype": "MAX"}, "Out"),
            ("sequence_conv", {"Filter": [w]}, {"contextLength": 3},
             "Out"),
            ("sequence_reverse", {}, {}, "Y"),
            ("sequence_unpad", {}, {}, "Out")]:
        a = _lower(op, dict(ins, X=[x], Length=[lens]), attrs)[slot][0]
        b = _lower(op, dict(ins, X=[y], Length=[lens]), attrs)[slot][0]
        if op == "sequence_reverse":      # the padding stays in place
            a, b = a[~pad], b[~pad]
        assert torch.equal(a, b), op
    s = _lower("sequence_softmax", {"X": [x[..., 0]], "Length": [lens]},
               {})["Out"][0]
    t = _lower("sequence_softmax", {"X": [y[..., 0]], "Length": [lens]},
               {})["Out"][0]
    assert torch.equal(s, t)


def test_concat_and_erase_drop_without_an_out_of_range_index():
    """The dropped steps go to a spare column that is cut off: outputs of
    T and sum-of-T columns, zeros after each row's length."""
    x = torch.arange(2 * 3, dtype=torch.int64).reshape(2, 3) + 1
    out = _lower("sequence_erase", {"X": [x], "Length": [torch.tensor(
        [3, 2])]}, {"tokens": [2]})
    assert out["Out"][0].tolist() == [[1, 3, 0], [4, 5, 0]]
    assert out["LengthOut"][0].tolist() == [2, 2]
    a, b = torch.ones(2, 2, 1), 2 * torch.ones(2, 3, 1)
    out = _lower("sequence_concat", {"X": [a, b], "Length": [
        torch.tensor([1, 2]), torch.tensor([3, 0])]}, {})
    assert out["Out"][0][..., 0].tolist() == [[1, 2, 2, 2, 0],
                                              [1, 1, 0, 0, 0]]
    assert out["LengthOut"][0].dtype == torch.int64
    assert out["LengthOut"][0].tolist() == [4, 2]


def test_concat_length_dtype_differs_from_the_jax_package():
    """A shared difference, pinned (ROADMAP Queue 3): the layer declares
    sequence_concat's LengthOut int64; the JAX lowering computes int32
    (its offsets start as int32 zeros), the port keeps the declared
    int64."""
    arrays, attrs = CASES["sequence_concat"]
    want, got = _run("sequence_concat", arrays, attrs)
    assert str(want["LengthOut"][0].dtype) == "int32"
    assert got["LengthOut"][0].dtype == torch.int64
    np.testing.assert_array_equal(_np(got["LengthOut"][0]),
                                  _np(want["LengthOut"][0]))


def test_sequence_mask_needs_maxlen_in_both():
    for reg, ctx in ((jreg, jreg.LoweringContext()),
                     (treg, treg.LoweringContext("cpu"))):
        with pytest.raises(NotImplementedError, match="maxlen"):
            reg.get_lowering("sequence_mask")(
                ctx, {"X": [np.array([1, 2])]}, {"maxlen": -1})


def test_scatter_adds_repeats_in_batch_order():
    """Repeated ids add in batch order (scatter_rows_), a negative id wraps
    once, an id past the row is dropped and takes no gradient."""
    x = torch.zeros(1, 4, requires_grad=True)
    upd = torch.tensor([[1e8, 1.0, -1e8, 2.0, 3.0]], requires_grad=True)
    ids = torch.tensor([[0, 0, 0, -1, 4]])
    out = _lower("sequence_scatter", {"X": [x], "Ids": [ids],
                                      "Updates": [upd]}, {})["Out"][0]
    # (1e8 + 1) - 1e8 in float32 order: 1e8 + 1 rounds to 1e8
    assert out.tolist() == [[0.0, 0.0, 0.0, 2.0]]
    gx, gu = torch.autograd.grad(out, [x, upd], torch.ones(1, 4))
    assert gx.tolist() == [[1.0] * 4]
    assert gu.tolist() == [[1.0, 1.0, 1.0, 1.0, 0.0]]


def test_ops_infer_shapes_on_meta_tensors():
    """Shape inference runs the lowerings on meta tensors: each gives its
    output shapes without data, but sequence_pad past T, which reads its
    pad value on the host in both packages."""
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype,
                                                       device="meta")
    lens = meta(B, dtype=torch.int64)
    ctx = treg.LoweringContext("meta")
    out = treg.get_lowering("sequence_conv")(
        ctx, {"X": [meta(B, T, D)], "Filter": [meta(3 * D, 8)],
              "Length": [lens]}, {"contextLength": 3})
    assert tuple(out["Out"][0].shape) == (B, T, 8)
    for p in POOLS:
        out = treg.get_lowering("sequence_pool")(
            ctx, {"X": [meta(B, T, D)], "Length": [lens]}, {"pooltype": p})
        assert tuple(out["Out"][0].shape) == (B, D)
    with pytest.raises(Exception):
        treg.get_lowering("sequence_pad")(
            ctx, {"X": [meta(B, T, D)], "Length": [lens],
                  "PadValue": [meta(1)]}, {"padded_length": T + 2})
