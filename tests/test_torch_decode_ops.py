"""The decoding lowerings (``paddle_tpu_torch/fluid/ops/decode_ops.py``'s
6: beam_search, beam_search_decode, linear_chain_crf with
linear_chain_crf_grad, crf_decoding, nce) against the JAX package's on
the same seeded numpy inputs, on the CPU.

- Forwards: every output of beam_search (also on tied scores: lower index
  first, as ``jax.lax.top_k``), beam_search_decode, the CRF (with and
  without Length, a row of length 0 and 1 among them) and Viterbi (with
  and without Length and Label). Integer outputs equal, float outputs
  within 1e-5 of the largest JAX magnitude.
- linear_chain_crf_grad's lowering against the JAX one (``jax.vjp``), both
  gradients within 1e-5 of the largest.
- nce by its invariants in both packages (the two draw from different
  generators): SampleLabels' first column the label and the rest in [0,
  V), the same draw on every call, a new draw for another seed, Cost the
  NCE formula over SampleLogits, SampleLogits the picked rows' products
  and biases. On the JAX draw, the port's ``nce_forward`` gives the JAX
  outputs and (autograd against ``jax.vjp``) gradients.
- The differences from the Paddle reference that both packages share
  (ROADMAP Queue 3), each asserted as both compute it.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.fluid.ops import registry as jreg
from paddle_tpu_torch.fluid.ops import decode_ops
from paddle_tpu_torch.fluid.ops import registry as treg

TOL = 1e-5
B, T, N = 4, 6, 5
LENS = np.array([T, 3, 1, 0], np.int64)
DECODE_OPS = {"beam_search", "beam_search_decode", "linear_chain_crf",
              "linear_chain_crf_grad", "crf_decoding", "nce"}


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _labels(seed, n=N):
    return np.random.RandomState(seed).randint(0, n, (B, T, 1)).astype(
        np.int64)


def _beam_in(seed, beam=2, sources=3, v=7):
    bw = beam * sources
    return {"pre_ids": [np.random.RandomState(seed).randint(
        0, v, (bw, 1)).astype(np.int64)],
            "pre_scores": [_randn(bw, 1, seed=seed + 1)],
            "scores": [_randn(bw, v, seed=seed + 2)]}, \
        {"beam_size": beam, "end_id": 0}


def _tied_beam_in():
    """Scores with ties inside each group and across its rows."""
    scores = np.array([[0.5, 0.25, 0.5, 0.25], [0.5, 0.5, 0.0, 0.25],
                       [1.0, 1.0, 1.0, 1.0], [1.0, 0.0, 1.0, 0.0],
                       [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]],
                      np.float32)
    return {"pre_ids": [np.zeros((6, 1), np.int64)],
            "pre_scores": [np.array([[0.0], [0.0], [0.0], [0.0], [0.0],
                                     [0.0]], np.float32)],
            "scores": [scores]}, {"beam_size": 2, "end_id": 0}


def _decode_in(seed, t=5, bw=6):
    rng = np.random.RandomState(seed)
    return {"Ids": [rng.randint(0, 50, (t, bw, 1)).astype(np.int64)],
            "ParentIdx": [rng.randint(0, bw, (t, bw)).astype(np.int64)],
            "Scores": [_randn(bw, 1, seed=seed + 1)]}, {"beam_size": 2}


def _crf_in(seed, length=True, label=True):
    d = {"Emission": [_randn(B, T, N, seed=seed)],
         "Transition": [_randn(N + 2, N, seed=seed + 1, scale=0.5)]}
    if label:
        d["Label"] = [_labels(seed + 2)]
    if length:
        d["Length"] = [LENS]
    return d, {}


def _nce_in(seed, bias=True, v=23, d=6, b=5):
    ins = {"Input": [_randn(b, d, seed=seed)],
           "Label": [np.random.RandomState(seed + 1).randint(
               0, v, (b, 1)).astype(np.int64)],
           "Weight": [_randn(v, d, seed=seed + 2, scale=0.3)]}
    if bias:
        ins["Bias"] = [_randn(v, seed=seed + 3, scale=0.3)]
    return ins, {"num_neg_samples": 4, "seed": 7, "num_total_classes": v}


# case -> (inputs, attrs). The op is the case's name up to "__".
CASES = {
    "beam_search": _beam_in(1),
    "beam_search__beam_3": _beam_in(4, beam=3, sources=2, v=11),
    "beam_search__ties": _tied_beam_in(),
    "beam_search_decode": _decode_in(7),
    "beam_search_decode__one_step": _decode_in(9, t=1),
    "linear_chain_crf": _crf_in(11),
    "linear_chain_crf__no_length": _crf_in(14, length=False),
    "crf_decoding": _crf_in(17, label=False),
    "crf_decoding__label": _crf_in(20),
    "crf_decoding__no_length": _crf_in(23, length=False, label=False),
}
GRAD_CASES = ("linear_chain_crf", "linear_chain_crf__no_length")


def _op(case):
    return case.split("__")[0]


def _j(arrays):
    return {k: [jnp.asarray(a) for a in v] for k, v in arrays.items()}


def _t(arrays):
    return {k: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
            for k, v in arrays.items()}


def _jax(op, arrays, attrs):
    return jreg.get_lowering(op)(jreg.LoweringContext(), _j(arrays), attrs)


def _port(op, arrays, attrs):
    return treg.get_lowering(op)(treg.LoweringContext("cpu"), _t(arrays),
                                 attrs)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().numpy()
    return np.asarray(x)


def _check(got, want, err_msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    if np.issubdtype(want.dtype, np.integer):
        assert got.dtype == np.int64, (got.dtype, err_msg)
        np.testing.assert_array_equal(got, want, err_msg)
        return
    got, want = got.astype(np.float64), want.astype(np.float64)
    assert np.isfinite(got).all() and np.isfinite(want).all(), err_msg
    bound = TOL * (np.abs(want).max() or 1.0)
    assert np.abs(got - want).max() <= bound, (
        err_msg, np.abs(got - want).max(), bound)


def test_the_cases_cover_the_slice():
    """The 6 lowerings of the JAX decode_ops.py, each with a case (nce and
    the grad op below), registered in the port's decode_ops with the same
    no-grad flags; the port holds 297 (246 with this slice, 9 more with
    the CTC and index-pooling slice: tests/test_torch_ctc_pool_ops.py),
    none the JAX package lacks."""
    assert {_op(c) for c in CASES} | {"nce", "linear_chain_crf_grad"} == \
        DECODE_OPS
    assert {op for op in jreg._LOWERINGS if jreg._LOWERINGS[op].__module__
            .endswith("decode_ops")} == DECODE_OPS
    assert all(treg._LOWERINGS[op].__module__.endswith("decode_ops")
               for op in DECODE_OPS)
    for op in DECODE_OPS:
        assert jreg.is_no_grad(op) == treg.is_no_grad(op), op
    assert treg.has_grad_maker("linear_chain_crf")
    assert len(treg._LOWERINGS) == 297
    assert set(treg._LOWERINGS) <= set(jreg._LOWERINGS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    arrays, attrs = CASES[case]
    want = _jax(_op(case), arrays, attrs)
    got = _port(_op(case), arrays, attrs)
    assert set(got) == set(want)
    for slot, w in want.items():
        _check(got[slot][0], w[0], slot)


def test_ties_come_out_lower_index_first():
    """On tied scores the selections are the lowest flat indices of each
    group, in order: in group 0 (rows 0, 1) the 0.5s at flat 0 and 2; in
    group 1 the 1.0s at flat 0 and 1; in group 2 flat 0 and 1."""
    arrays, attrs = CASES["beam_search__ties"]
    got = _port("beam_search", arrays, attrs)
    np.testing.assert_array_equal(_np(got["selected_ids"][0]).ravel(),
                                  [0, 2, 0, 1, 0, 1])
    np.testing.assert_array_equal(_np(got["parent_idx"][0]),
                                  [0, 0, 2, 2, 4, 4])


@pytest.mark.parametrize("case", GRAD_CASES)
def test_crf_grad_matches_jax_vjp(case):
    arrays, attrs = CASES[case]
    arrays = dict(arrays, **{"LL@GRAD": [_randn(B, 1, seed=30)]})
    want = _jax("linear_chain_crf_grad", arrays, attrs)
    got = _port("linear_chain_crf_grad", arrays, attrs)
    assert set(got) == set(want) == {"Emission@GRAD", "Transition@GRAD"}
    for slot in want:
        _check(got[slot][0], want[slot][0], slot)


def test_crf_grad_is_autograd_of_the_forward():
    """The grad op's gradients are those of LogLikelihood itself: autograd
    through the port's forward lowering, against central differences of
    it in float64 at two entries."""
    arrays, attrs = CASES["linear_chain_crf"]
    ins = _t(arrays)
    cot = torch.from_numpy(_randn(B, 1, seed=31))
    got = treg.get_lowering("linear_chain_crf_grad")(
        treg.LoweringContext("cpu"), dict(ins, **{"LL@GRAD": [cot]}), {})
    e = ins["Emission"][0].double()
    tr = ins["Transition"][0].double()
    lab = ins["Label"][0].reshape(B, T)
    lens = ins["Length"][0]

    def f(e, tr):
        return float((decode_ops.crf_log_likelihood(e, tr, lab, lens).double()
                      * cot.double().reshape(-1)).sum())
    h = 1e-4
    for idx in ((0, 2, 1), (1, 1, 3)):
        ep, em = e.clone(), e.clone()
        ep[idx] += h
        em[idx] -= h
        num = (f(ep.float(), tr.float()) - f(em.float(), tr.float())) / (2 * h)
        assert abs(float(got["Emission@GRAD"][0][idx]) - num) < 2e-2
    # past a row's length an emission has no gradient (a row of length 0
    # keeps its first step's: alpha starts from it)
    assert float(got["Emission@GRAD"][0][1, 3:].abs().max()) == 0.0
    assert float(got["Emission@GRAD"][0][3, 1:].abs().max()) == 0.0


# --------------------------------------------------------------------------
# nce: invariants in both packages, the port's formula on the JAX draw
# --------------------------------------------------------------------------

def _nce_invariants(out, arrays, attrs, to_np):
    x, lab, w = (arrays[k][0] for k in ("Input", "Label", "Weight"))
    bias = arrays.get("Bias", [None])[0]
    v, k = w.shape[0], attrs["num_neg_samples"]
    labels = to_np(out["SampleLabels"][0])
    logits = to_np(out["SampleLogits"][0]).astype(np.float64)
    cost = to_np(out["Cost"][0]).astype(np.float64)
    assert labels.shape == logits.shape == (x.shape[0], 1 + k)
    # int64 in the port; int32 in JAX without jax_enable_x64
    assert np.issubdtype(labels.dtype, np.integer)
    np.testing.assert_array_equal(labels[:, 0], lab.ravel())
    assert ((labels >= 0) & (labels < v)).all()
    picked = np.einsum("bd,bkd->bk", x.astype(np.float64),
                       w[labels].astype(np.float64))
    if bias is not None:
        picked = picked + bias[labels]
    np.testing.assert_allclose(logits, picked, rtol=1e-5, atol=1e-5)
    log_q = -np.log(v)
    want = np.logaddexp(0, -(logits[:, 0] - log_q)) + np.logaddexp(
        0, logits[:, 1:] - log_q).sum(1)
    np.testing.assert_allclose(cost.ravel(), want, rtol=1e-5)
    return labels


@pytest.mark.parametrize("bias", [True, False])
def test_nce_invariants_in_both_packages(bias):
    arrays, attrs = _nce_in(40, bias=bias)
    draws = {}
    for name, run, to_np in (("jax", _jax, np.asarray), ("port", _port, _np)):
        if name == "port":
            assert run("nce", arrays, attrs)["SampleLabels"][0].dtype == \
                torch.int64
        first = _nce_invariants(run("nce", arrays, attrs), arrays, attrs,
                                to_np)
        again = _nce_invariants(run("nce", arrays, attrs), arrays, attrs,
                                to_np)
        np.testing.assert_array_equal(first, again)
        other = to_np(run("nce", arrays, dict(attrs, seed=8))[
            "SampleLabels"][0])
        assert (other[:, 1:] != first[:, 1:]).any(), name
        draws[name] = first
    # the two packages draw from different generators
    assert (draws["jax"][:, 1:] != draws["port"][:, 1:]).any()


@pytest.mark.parametrize("bias", [True, False])
def test_nce_on_the_jax_draw_matches_jax(bias):
    """nce_forward on the negatives the JAX lowering drew: every output of
    the JAX lowering, and the gradients of Cost (autograd) against
    jax.vjp's for Input, Weight and Bias."""
    arrays, attrs = _nce_in(50, bias=bias)
    keys = [k for k in ("Input", "Weight", "Bias") if k in arrays]

    def jfn(*xs):
        ins = _j(arrays)
        ins.update({k: [x] for k, x in zip(keys, xs)})
        return jreg.get_lowering("nce")(jreg.LoweringContext(), ins,
                                        attrs)["Cost"][0]
    want = _jax("nce", arrays, attrs)
    cost, vjp = jax.vjp(jfn, *[jnp.asarray(arrays[k][0]) for k in keys])
    cot = _randn(*cost.shape, seed=51)
    want_grads = vjp(jnp.asarray(cot))
    leaves = {k: torch.from_numpy(arrays[k][0]).requires_grad_(True)
              for k in keys}
    neg = torch.from_numpy(np.asarray(want["SampleLabels"][0])[:, 1:].copy())
    got = decode_ops.nce_forward(leaves["Input"],
                                 torch.from_numpy(arrays["Label"][0]),
                                 leaves["Weight"], leaves.get("Bias"), neg)
    for slot in want:
        _check(got[slot][0], want[slot][0], slot)
    grads = torch.autograd.grad(got["Cost"][0], [leaves[k] for k in keys],
                                torch.from_numpy(cot))
    for k, g, w in zip(keys, grads, want_grads):
        _check(g, w, k)


def test_nce_draws_on_the_ops_device_generator():
    """The negatives come from a generator made for the call, seeded by
    (seed, batch): the global generator's state is left as it was, and
    another batch size draws other rows."""
    state = torch.get_rng_state()
    a = decode_ops.nce_negatives("cpu", 7, 5, 4, 23)
    assert torch.equal(torch.get_rng_state(), state)
    b = decode_ops.nce_negatives("cpu", 7, 6, 4, 23)
    assert not torch.equal(a, b[:5])
    assert torch.equal(a, decode_ops.nce_negatives("cpu", 7, 5, 4, 23))


# --------------------------------------------------------------------------
# differences from the Paddle reference that both packages share
# --------------------------------------------------------------------------

def _best_path(e, tr, n_steps):
    """The highest-scoring tag path of one row by enumeration."""
    best = None
    for p in itertools.product(range(e.shape[1]), repeat=n_steps):
        s = tr[0][p[0]] + tr[1][p[-1]] + sum(e[t, p[t]]
                                             for t in range(n_steps)) + \
            sum(tr[2 + p[t - 1]][p[t]] for t in range(1, n_steps))
        if best is None or s > best[0]:
            best = (s, p)
    return np.array(best[1])


def test_viterbi_path_is_shifted_in_both_packages():
    """The JAX backtrack emits step t + 1's tag at step t and repeats the
    last tag; the port keeps it. Against the best path by enumeration, over
    rows of full length."""
    arrays, attrs = _crf_in(60, length=False, label=False)
    e, tr = arrays["Emission"][0], arrays["Transition"][0]
    got = _np(_port("crf_decoding", arrays, attrs)["ViterbiPath"][0])
    want = np.asarray(_jax("crf_decoding", arrays, attrs)["ViterbiPath"][0])
    np.testing.assert_array_equal(got, want)
    shifted = 0
    for b in range(B):
        best = _best_path(e[b], tr, T)
        np.testing.assert_array_equal(got[b], np.r_[best[1:], best[-1]])
        shifted += int((got[b] != best).any())
    assert shifted > 0


def test_crf_log_likelihood_is_not_negated_in_both_packages():
    """LogLikelihood is path - logZ <= 0 in both (the reference's op
    returns -(path - logZ), the cost the book minimizes)."""
    arrays, attrs = CASES["linear_chain_crf"]
    for out in (_np(_port("linear_chain_crf", arrays, attrs)
                    ["LogLikelihood"][0]),
                np.asarray(_jax("linear_chain_crf", arrays, attrs)
                           ["LogLikelihood"][0])):
        assert (out <= 0).all() and (out < 0).any()


def test_beam_search_adds_pre_scores_twice_and_selects_positions():
    """Both packages add pre_scores to scores a decoder has accumulated
    already, and take the selected id as a position in the scores' row:
    with scores = log p + pre_scores, a selection's score is log p + 2
    pre_scores, and its id is the column, not the ``ids`` input's token
    there (which the layer does not pass)."""
    pre = np.array([[-1.0], [-2.0]], np.float32)
    logp = np.log(np.array([[0.6, 0.4], [0.7, 0.3]], np.float32))
    arrays = {"pre_ids": [np.zeros((2, 1), np.int64)], "pre_scores": [pre],
              "scores": [logp + pre]}
    attrs = {"beam_size": 2, "end_id": 0}
    for out, to_np in ((_port("beam_search", arrays, attrs), _np),
                       (_jax("beam_search", arrays, attrs), np.asarray)):
        np.testing.assert_array_equal(to_np(out["selected_ids"][0]).ravel(),
                                      [0, 1])
        np.testing.assert_allclose(
            to_np(out["selected_scores"][0]).ravel(),
            [logp[0, 0] - 2.0, logp[0, 1] - 2.0], rtol=1e-6)


def test_beam_search_groups_rows_by_beam_in_both_packages():
    """The lowering groups the fed rows beam_size at a time: two sources
    fed one row each at beam 2 form one group, and the second row's
    selections come from the first row's candidates."""
    arrays = {"pre_ids": [np.zeros((2, 1), np.int64)],
              "pre_scores": [np.zeros((2, 1), np.float32)],
              "scores": [np.array([[-0.1, -0.2, -3.0], [-2.0, -2.5, -4.0]],
                                  np.float32)]}
    attrs = {"beam_size": 2, "end_id": 0}
    for out, to_np in ((_port("beam_search", arrays, attrs), _np),
                       (_jax("beam_search", arrays, attrs), np.asarray)):
        np.testing.assert_array_equal(to_np(out["parent_idx"][0]), [0, 0])
        np.testing.assert_array_equal(to_np(out["selected_ids"][0]).ravel(),
                                      [0, 1])


def _nce_program(fluid, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        fluid.layers.nce(x, y, num_total_classes=30, **kw)
    return [(op.type, dict(op.inputs), sorted(op.attrs.items()))
            for op in main.global_block().ops]


def test_nce_ignores_sampler_and_weights_in_both_packages():
    """nce's sample_weight, sampler, custom_dist and is_sparse change
    nothing in the program of either package."""
    for fluid in (jfluid, tfluid):
        plain = _nce_program(fluid)
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            w = fluid.layers.data(name="w", shape=[1], dtype="float32")
        assert _nce_program(
            fluid, sampler="custom_dist", custom_dist=[1.0 / 30] * 30,
            is_sparse=True) == plain
        assert _nce_program(fluid, sampler="log_uniform") == plain
        assert _nce_program(fluid, sample_weight=w) == plain
    assert _nce_program(jfluid) == _nce_program(tfluid)
