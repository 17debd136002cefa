"""The loss lowerings of the Fluid book and of ``fluid.layers`` (the
cross-entropy over probabilities and its cross_entropy2 form, bpr, log,
Huber, smooth L1, hinge, rank, margin-rank, modified Huber,
teacher-student, KL and n-pair losses) and depthwise_conv2d, each against
the JAX package's lowering of the same op on the same seeded inputs, on
the CPU.

Tolerance (tests/test_torch_math_ops.py's float32 one): |got - want| <=
1e-6 * |want| + 1e-6 * max |want|; NaN where the JAX lowering gives NaN
and nowhere else. Gradients: ``jax.vjp`` of the JAX lowering (all cases in
one jitted function) against autograd through the port's lowering, at the
same tolerance.

Besides: the labels the JAX gather takes in its default mode (the
ignore_index, a negative label that wraps once, a label past the classes
that picks NaN and passes no gradient), the ties of the three clipped
losses and of sigmoid_cross_entropy_with_logits at 0 (split as
``jnp.maximum`` and ``jnp.clip`` split them; ``jnp.abs``'s slope 1 at
0, where ``torch.abs`` gives 0), kldiv_loss's
four reductions, and depthwise_conv2d at channel multipliers 1 and 2.
In bfloat16 (the float inputs rounded in both packages): the JAX
lowering's output dtypes, within one bf16 ulp of the largest value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.fluid.ops import registry as jreg
from paddle_tpu_torch.fluid.ops import registry as treg


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy() if x.is_floating_point() else \
            x.detach().numpy()
    x = np.asarray(x)
    return x.astype(np.int64 if x.dtype.kind in "iu" else np.float64)


def _rng(seed):
    return np.random.RandomState(seed)


def _randn(*shape, seed=0, scale=1.0):
    return (_rng(seed).randn(*shape) * scale).astype(np.float32)


def _probs(n, v, seed=0):
    e = np.exp(_randn(n, v, seed=seed))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _bits(n, seed=0):
    return _rng(seed).randint(0, 2, (n, 1)).astype(np.float32)


def _unit(*shape, seed=0):
    return _rng(seed).uniform(0.05, 0.95, shape).astype(np.float32)


def _inputs(arrays):
    return ({k: [jnp.asarray(a) for a in v] for k, v in arrays.items()},
            {k: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
             for k, v in arrays.items()})


def _run(op, arrays, attrs):
    jin, tin = _inputs(arrays)
    want = jreg.get_lowering(op)(jreg.LoweringContext(), jin, attrs)
    got = treg.get_lowering(op)(treg.LoweringContext("cpu"), tin, attrs)
    return want, got


def _close(got, want, err_msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=err_msg)
    got, want = got[~nan], want[~nan]
    if not want.size:
        return
    bound = 1e-6 * np.abs(want) + 1e-6 * np.abs(want).max()
    err = np.abs(got - want)
    assert (err <= bound).all(), (err_msg, err.max(), (err - bound).max())


# op -> (inputs, attrs, the output slot checked and taken the gradient of)
CASES = {
    "cross_entropy": ({"X": [_probs(6, 5)], "Label": [
        _rng(1).randint(0, 5, (6, 1))]}, {}, "Y"),
    "cross_entropy_soft": ({"X": [_probs(6, 5)], "Label": [
        _probs(6, 5, seed=1)]}, {"soft_label": True}, "Y"),
    "cross_entropy2": ({"X": [_probs(6, 5)], "Label": [
        _rng(1).randint(0, 5, (6, 1))]}, {}, "Y"),
    "bpr_loss": ({"X": [_randn(6, 5)], "Label": [
        _rng(1).randint(0, 5, (6, 1))]}, {}, "Y"),
    "log_loss": ({"Predicted": [_unit(6, 1)], "Labels": [_bits(6, 1)]},
                 {"epsilon": 1e-4}, "Loss"),
    "huber_loss": ({"X": [_randn(8, 1, scale=2.0)],
                    "Y": [_randn(8, 1, seed=1)]}, {"delta": 1.0}, "Out"),
    "smooth_l1_loss": ({"X": [_randn(4, 6)], "Y": [_randn(4, 6, seed=1)],
                        "InsideWeight": [_unit(4, 6, seed=2)],
                        "OutsideWeight": [_unit(4, 6, seed=3)]},
                       {"sigma": 2.0}, "Out"),
    "smooth_l1_loss_unweighted": ({"X": [_randn(4, 6)],
                                   "Y": [_randn(4, 6, seed=1)]},
                                  {"sigma": 1.0}, "Out"),
    "hinge_loss": ({"Logits": [_randn(8, 1)], "Labels": [_bits(8, 1)]}, {},
                   "Loss"),
    "rank_loss": ({"Label": [_bits(6, 1)], "Left": [_randn(6, 1, seed=1)],
                   "Right": [_randn(6, 1, seed=2)]}, {}, "Out"),
    "margin_rank_loss": ({"Label": [2 * _bits(8, 1) - 1],
                          "X1": [_randn(8, 1, seed=1)],
                          "X2": [_randn(8, 1, seed=2)]}, {"margin": 0.1},
                         "Out"),
    "modified_huber_loss": ({"X": [_randn(10, 1, scale=1.5)],
                             "Y": [_bits(10, 1)]}, {}, "Out"),
    "teacher_student_sigmoid_loss": (
        {"X": [_randn(10, 1, scale=3.0)], "Label": [_unit(10, 1, seed=1)]},
        {"soft_max_up_bound": 2.0, "soft_max_lower_bound": -2.0}, "Y"),
    "kldiv_loss": ({"X": [np.log(_probs(4, 5))],
                    "Target": [_probs(4, 5, seed=1)]},
                   {"reduction": "mean"}, "Loss"),
    "npair_loss": ({"Anchor": [_randn(6, 4)],
                    "Positive": [_randn(6, 4, seed=1)],
                    "Labels": [np.array([0, 1, 0, 2, 1, 3], np.int64)]},
                   {"l2_reg": 0.002}, "Out"),
    "depthwise_conv2d": ({"Input": [_randn(2, 3, 8, 8)],
                          "Filter": [_randn(3, 1, 3, 3, seed=1)]},
                         {"strides": [1, 1], "paddings": [1, 1],
                          "dilations": [1, 1], "groups": 3}, "Output"),
    "depthwise_conv2d_x2": ({"Input": [_randn(2, 3, 9, 9)],
                             "Filter": [_randn(6, 1, 3, 3, seed=1)]},
                            {"strides": [2, 2], "paddings": [0, 0],
                             "dilations": [1, 1], "groups": 3}, "Output"),
}
LOSS_OPS = ["cross_entropy", "cross_entropy2", "bpr_loss", "log_loss",
            "huber_loss", "smooth_l1_loss", "hinge_loss", "rank_loss",
            "margin_rank_loss", "modified_huber_loss",
            "teacher_student_sigmoid_loss", "kldiv_loss", "npair_loss"]


def _op(case):
    """The op a case runs: its name up to a variant's suffix."""
    for suffix in ("_soft", "_unweighted", "_x2"):
        if case.endswith(suffix):
            return case[:-len(suffix)]
    return case


def test_the_cases_cover_the_slice():
    """The 13 loss lowerings and depthwise_conv2d, in both packages; the
    port holds 311 with fusion_ops.py's 14, 297 before them (with
    test_torch_tensor_ops.py's 40,
    test_torch_nn_ops.py's 24, test_torch_array_ops.py's 14,
    test_torch_sequence_ops.py's 15, test_torch_rnn_ops.py's 8,
    test_torch_decode_ops.py's 6 and test_torch_ctc_pool_ops.py's 9)."""
    assert sorted({_op(c) for c in CASES}) == sorted(
        LOSS_OPS + ["depthwise_conv2d"])
    assert all(treg.has_lowering(op) and jreg.has_lowering(op)
               for op in LOSS_OPS + ["depthwise_conv2d"])
    assert len(treg._LOWERINGS) == 311


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    arrays, attrs, slot = CASES[case]
    want, got = _run(_op(case), arrays, attrs)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for s in want:
        _close(got[s][0], want[s][0], err_msg=s)


def _bf16_inputs(arrays):
    """The float32 inputs as bfloat16 in both packages."""
    jin, tin = _inputs(arrays)
    return ({k: [a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a
                 for a in v] for k, v in jin.items()},
            {k: [a.to(torch.bfloat16) if a.dtype == torch.float32 else a
                 for a in v] for k, v in tin.items()})


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_forward_matches_jax(case):
    """bfloat16 inputs: every output in the JAX lowering's dtype, within
    one bf16 ulp (2^-7) of its largest JAX value (the reductions of
    bpr_loss and npair_loss add in another order; the rest read equal)."""
    arrays, attrs, _ = CASES[case]
    jin, tin = _bf16_inputs(arrays)
    want = jreg.get_lowering(_op(case))(jreg.LoweringContext(), jin, attrs)
    got = treg.get_lowering(_op(case))(treg.LoweringContext("cpu"), tin,
                                       attrs)
    for s in want:
        assert str(got[s][0].dtype) == "torch." + str(want[s][0].dtype), s
        g, w = _np(got[s][0]), _np(want[s][0])
        assert g.shape == w.shape
        if w.size:
            assert np.abs(g - w).max() <= 2.0 ** -7 * np.abs(w).max(), s


def _float_keys(arrays):
    return [(k, i) for k, v in arrays.items() for i, a in enumerate(v)
            if a.dtype == np.float32]


def _jax_fn(op, arrays, attrs, slot):
    jin, _ = _inputs(arrays)
    keys = _float_keys(arrays)

    def fn(*xs):
        ins = {k: list(v) for k, v in jin.items()}
        for (k, i), x in zip(keys, xs):
            ins[k][i] = x
        return jreg.get_lowering(op)(jreg.LoweringContext(), ins,
                                     attrs)[slot][0]
    return fn, [jin[k][i] for k, i in keys]


def _cot(shape, seed=9):
    return np.asarray(_rng(seed).randn(*shape), np.float32)


def _port_grads(op, arrays, attrs, slot, cot):
    _, tin = _inputs(arrays)
    leaves = []
    for k, i in _float_keys(arrays):
        tin[k][i] = tin[k][i].clone().requires_grad_(True)
        leaves.append(tin[k][i])
    out = treg.get_lowering(op)(treg.LoweringContext("cpu"), tin,
                                attrs)[slot][0]
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot),
                              allow_unused=True)
    return [torch.zeros_like(leaf) if g is None else g
            for leaf, g in zip(leaves, got)]


def _jax_vjps(cases):
    """{case: (cotangent, the JAX gradients)} for (name, op, arrays,
    attrs, slot) cases, in one jitted function."""
    fns, args, cots = [], [], []
    for _, op, arrays, attrs, slot in cases:
        fn, xs = _jax_fn(op, arrays, attrs, slot)
        fns.append(fn)
        args.append(xs)
        cots.append(_cot(jax.eval_shape(fn, *xs).shape))

    @jax.jit
    def all_vjps(args, cots):
        return [jax.vjp(fn, *xs)[1](c) for fn, xs, c in zip(fns, args, cots)]
    grads = all_vjps(args, [jnp.asarray(c) for c in cots])
    return {c[0]: (cot, g) for c, cot, g in zip(cases, cots, grads)}


def _check_grads(name, op, arrays, attrs, slot, vjps):
    cot, want = vjps[name]
    got = _port_grads(op, arrays, attrs, slot, cot)
    assert len(got) == len(want)
    for key, g, w in zip(_float_keys(arrays), got, want):
        _close(g, w, err_msg="%s[%d]" % key)


@pytest.fixture(scope="module")
def jax_vjps():
    return _jax_vjps([(c, _op(c)) + CASES[c] for c in sorted(CASES)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradient_matches_jax_vjp(case, jax_vjps):
    _check_grads(case, _op(case), *CASES[case], jax_vjps)


# --------------------------------------------------------------------------
# labels outside the classes, ties and reductions
# --------------------------------------------------------------------------

# [ignore_index, in range, past the classes, wrapping negative, past the
# classes after wrapping]
ODD_LABELS = np.array([[-100], [1], [7], [-1], [-6]], np.int64)
LABEL_CASES = {
    "cross_entropy": ({"X": [_probs(5, 5)], "Label": [ODD_LABELS]}, {},
                      "Y"),
    "cross_entropy2": ({"X": [_probs(5, 5)], "Label": [ODD_LABELS]}, {},
                       "Y"),
    "cross_entropy_ignore_1": ({"X": [_probs(5, 5)], "Label": [ODD_LABELS]},
                               {"ignore_index": 1}, "Y"),
    "bpr_loss": ({"X": [_randn(5, 5)], "Label": [ODD_LABELS]}, {}, "Y"),
}
TIE_CASES = {
    # z = 1 - (2 label - 1) * logits at 0 in rows 0 and 1
    "hinge_loss": ({"Logits": [np.array([[1.0], [-1.0], [0.5], [-2.0]],
                                        np.float32)],
                    "Labels": [np.array([[1.0], [0.0], [1.0], [1.0]],
                                        np.float32)]}, {}, "Loss"),
    # -label * (x1 - x2) + margin at 0 in rows 0 and 1
    "margin_rank_loss": ({"Label": [np.array([[1.0], [-1.0], [1.0]],
                                             np.float32)],
                          "X1": [np.array([[0.75], [0.25], [2.0]],
                                          np.float32)],
                          "X2": [np.array([[0.25], [0.75], [0.0]],
                                          np.float32)]}, {"margin": 0.5},
                         "Out"),
    # x at 0 (the maximum's tie, and where jnp.abs's gradient is 1)
    "sigmoid_cross_entropy_with_logits": (
        {"X": [np.array([[0.0], [1.5], [-0.5], [0.0]], np.float32)],
         "Label": [np.array([[0.3], [1.0], [0.0], [1.0]], np.float32)]},
        {}, "Out"),
    # x at both clip bounds and at 0 (the maximum's tie, and where
    # jnp.abs's gradient is 1)
    "teacher_student_sigmoid_loss": (
        {"X": [np.array([[2.0], [-2.0], [0.0], [1.0], [3.0]], np.float32)],
         "Label": [_unit(5, 1, seed=1)]},
        {"soft_max_up_bound": 2.0, "soft_max_lower_bound": -2.0}, "Y"),
}
KLDIV_CASES = {
    "kldiv_loss_" + red: ({"X": [np.log(_probs(4, 5))],
                           "Target": [_probs(4, 5, seed=1)]},
                          {"reduction": red}, "Loss")
    for red in ("none", "mean", "sum", "batchmean")}
EXTRA = dict(LABEL_CASES, **TIE_CASES, **KLDIV_CASES)


def _extra_op(case):
    return {"cross_entropy_ignore_1": "cross_entropy"}.get(
        case, "kldiv_loss" if case.startswith("kldiv") else case)


@pytest.fixture(scope="module")
def extra_vjps():
    return _jax_vjps([(c, _extra_op(c)) + EXTRA[c] for c in sorted(EXTRA)])


@pytest.mark.parametrize("case", sorted(EXTRA))
def test_edge_cases_match_jax(case, extra_vjps):
    arrays, attrs, slot = EXTRA[case]
    want, got = _run(_extra_op(case), arrays, attrs)
    for s in want:
        _close(got[s][0], want[s][0], err_msg=s)
    _check_grads(case, _extra_op(case), arrays, attrs, slot, extra_vjps)


def test_cross_entropy_label_semantics():
    """As the JAX lowering gives them: the ignore_index row loss 0, label
    -1 the last class, a label past the classes (7, or -6 after its one
    wrap) NaN; and no gradient on any row but the in-range ones."""
    x = _probs(5, 5)
    _, got = _run("cross_entropy", {"X": [x], "Label": [ODD_LABELS]}, {})
    loss = _np(got["Y"][0])[:, 0]
    assert loss[0] == 0.0
    np.testing.assert_allclose(loss[1], -np.log(x[1, 1] + 1e-12), 1e-6)
    np.testing.assert_allclose(loss[3], -np.log(x[3, 4] + 1e-12), 1e-6)
    assert np.isnan(loss[2]) and np.isnan(loss[4])
    grad, = _port_grads("cross_entropy",
                        {"X": [x], "Label": [ODD_LABELS]}, {}, "Y",
                        np.ones((5, 1), np.float32))
    grad = _np(grad)
    assert not grad[[0, 2, 4]].any() and np.isfinite(grad).all()
    assert grad[1, 1] != 0 and grad[3, 4] != 0


@pytest.mark.parametrize("op", sorted(TIE_CASES))
def test_ties_split_the_gradient(op):
    """At a tie the gradient is halved: the port's autograd, with a
    cotangent of ones, gives 0.5 (of the slope) where the JAX vjp does."""
    arrays, attrs, slot = TIE_CASES[op]
    n = next(iter(arrays.values()))[0].shape[0]
    grads = _port_grads(op, arrays, attrs, slot, np.ones((n, 1), np.float32))
    # d/d logits, d/d X1 and d/d X
    first = _np(grads[1 if op == "margin_rank_loss" else 0])[:, 0]
    if op == "hinge_loss":
        np.testing.assert_array_equal(first[:2], [-0.5, 0.5])
    elif op == "sigmoid_cross_entropy_with_logits":
        # 0.5 - label - 0.5 at x = 0
        np.testing.assert_allclose(first[[0, 3]], [-0.3, -1.0], rtol=1e-6)
    elif op == "margin_rank_loss":
        np.testing.assert_array_equal(first[:2], [-0.5, 0.5])
    else:
        # d/dx at a clip bound: half of the loss's slope there
        lab = arrays["Label"][0][:2, 0].astype(np.float64)
        z = np.array([2.0, -2.0])
        slope = 1.0 / (1.0 + np.exp(-z)) - lab
        np.testing.assert_allclose(first[:2], 0.5 * slope, rtol=1e-6)


def test_kldiv_reductions_shapes():
    arrays = KLDIV_CASES["kldiv_loss_none"][0]
    shapes = {}
    for red in ("none", "mean", "sum", "batchmean"):
        _, got = _run("kldiv_loss", arrays, {"reduction": red})
        shapes[red] = tuple(got["Loss"][0].shape)
    assert shapes == {"none": (4, 5), "mean": (), "sum": (),
                      "batchmean": ()}
    _, s = _run("kldiv_loss", arrays, {"reduction": "sum"})
    _, b = _run("kldiv_loss", arrays, {"reduction": "batchmean"})
    assert float(b["Loss"][0]) == float(s["Loss"][0]) / 4


def test_cross_entropy2_outputs():
    arrays, attrs, _ = CASES["cross_entropy2"]
    _, got = _run("cross_entropy2", arrays, attrs)
    assert tuple(got["XShape"][0].shape) == (0, 6, 5)
    np.testing.assert_array_equal(_np(got["MatchX"][0]),
                                  _np(torch.exp(-got["Y"][0])))


@pytest.mark.parametrize("multiplier", [1, 2])
def test_depthwise_conv2d_is_a_grouped_conv2d(multiplier):
    """depthwise_conv2d takes groups from the input's channels, whatever
    the attr says, and equals the port's conv2d at those groups."""
    x = torch.from_numpy(_randn(2, 4, 7, 7))
    w = torch.from_numpy(_randn(4 * multiplier, 1, 3, 3, seed=1))
    attrs = {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1]}
    ctx = treg.LoweringContext("cpu")
    got = treg.get_lowering("depthwise_conv2d")(
        ctx, {"Input": [x], "Filter": [w]}, dict(attrs, groups=1))
    want = treg.get_lowering("conv2d")(
        ctx, {"Input": [x], "Filter": [w]}, dict(attrs, groups=4))
    assert tuple(got["Output"][0].shape) == (2, 4 * multiplier, 7, 7)
    assert torch.equal(got["Output"][0], want["Output"][0])
