"""The port's plain flash and one-pass backward versions in bfloat16 against
the JAX package's Pallas backward kernels run in interpret mode on the CPU.

On the card chip_smoke.py holds the bf16 tensor-core backward kernels to
these plain versions, so here their rounding points are pinned in bf16: the
same seeded numpy inputs, cast to bf16 in both packages, with the Pallas
forward's out and lse given to both flash backward passes, at head widths
16, 40 (a multiple of 8 but not of 16), 256 (bench.py's wide Transformer)
and 264 (past the tensor-core kernels: the CUDA-core kernels in bf16) and
ragged lengths.

Both round P (before P^T dO) and dS = P (dP - delta) scale to bf16
elementwise and every output once, but they sum S, dP and delta in other
f32 orders (XLA's, PyTorch's). So the bound is chip_smoke.py's for the flash
backward: rtol 2^-7 of the element (one bf16 ulp of the output) and atol
2^-8 of its row's rms (the orders of the output's f32 sums), plus what the
orders of S, dP and delta can move through single P and dS terms whose bf16
rounding flips (chip_smoke.flash_bwd_rounding_bound: a term whose f32 value
lies near a rounding midpoint, and every term of a row that sees one key,
where dS is f32 noise). The one-pass backward takes P from the row max and
sum that each side computes itself, and delta = rowsum(dP o P) from that P:
chip_smoke.onepass_bwd_rounding_bound carries the orders of those sums into
the same flips.
"""
import importlib.util
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops import attention as JA
from paddle_tpu_torch.ops import attention as TA

SHAPES = [(48, 48), (24, 40), (40, 24)]     # (T_q, T_k)
BLOCK = 8                                   # the Pallas kernels' tiles


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
RTOL, ATOL = CS.BWD_TOL["flash_bwd"]["bfloat16"]
ONEPASS_TOL = CS.BWD_TOL["onepass_bwd"]["bfloat16"]
# (causal, T_q, T_k) without keyless rows: the Pallas one-pass kernel gives
# a keyless row dS = P (dP - delta) scale where the port follows the dense
# path (dS = 0; tests/test_torch_attention.py)
KEYED = [(c, t_q, t_k) for c in (False, True) for t_q, t_k in SHAPES
         if not (c and t_q > t_k)]


def _inputs(seed, t_q, t_k, d, b=2, h=2):
    """q, k, v, dO as bf16 jax and torch arrays with the same values."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(b, t, h, d).astype("float32")
              for t in (t_q, t_k, t_k, t_q)]
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])


def _torch(x):
    """A jax array as a torch tensor of the same dtype and values."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _pallas(jq, jk, jv, jdo, causal):
    """The Pallas forward's out and lse, and the Pallas backward's dq, dk,
    dv from them, as torch tensors."""
    out, lse = JA.flash_attention_fwd_bthd(jq, jk, jv, causal=causal,
                                           block_q=BLOCK, block_k=BLOCK,
                                           interpret=True)
    grads = JA.flash_attention_bwd_bthd(jq, jk, jv, out, lse, jdo,
                                        causal=causal, block_q=BLOCK,
                                        block_k=BLOCK, interpret=True)
    return _torch(out), _torch(lse), [_torch(g) for g in grads]


def _within(got, want, extra, slack=None, tol=(RTOL, ATOL)):
    """max |got - want| / bound <= 1, with the flash backward's bound (or
    tol's rtol and atol)."""
    bound = CS.bwd_bound(want, *tol, extra)
    if slack is not None:
        bound = bound + slack
    ratio = CS.err_ratio(got, want, 0, 0, bound=bound)
    assert ratio <= 1.0, "max |diff| / bound = %g" % ratio


@pytest.mark.parametrize("causal,t_q,t_k", KEYED)  # keyless: 2 tests on
@pytest.mark.parametrize("d", [16, 40, 256, 264])
def test_flash_bwd_plain_bf16_matches_pallas_interpret(d, causal, t_q, t_k):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(21, t_q, t_k, d)
    out, lse, want = _pallas(jq, jk, jv, jdo, causal)
    counts = (TA.flash_attention_bwd_dq.launches,
              TA.flash_attention_bwd_dkv.launches)
    got = TA.flash_attention_bwd_bthd(tq, tk, tv, out, lse, tdo, causal)
    assert counts == (TA.flash_attention_bwd_dq.launches,
                      TA.flash_attention_bwd_dkv.launches)   # no kernel
    extra = CS.flash_bwd_rounding_bound(TA, tq, tk, tv, tdo, out, lse,
                                        causal)
    for g, w, e, x in zip(got, want, extra, (tq, tk, tv)):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
        _within(g, w, e)
    # the two wrappers alone, with the delta the composite computes
    delta = TA.flash_delta(out, tdo)
    assert torch.equal(TA.flash_attention_bwd_dq(tq, tk, tv, tdo, lse, delta,
                                                 causal), got[0])
    for g, w in zip(TA.flash_attention_bwd_dkv(tq, tk, tv, tdo, lse, delta,
                                               causal), got[1:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_bound_rejects_a_wrong_plain_version(causal):
    """The bound is no blanket: the plain version with delta dropped (dq,
    dk) or with the last key tile dropped (dv) falls outside it."""
    t_q, t_k, d = 48, 48, 16
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(22, t_q, t_k, d)
    out, lse, want = _pallas(jq, jk, jv, jdo, causal)
    extra = CS.flash_bwd_rounding_bound(TA, tq, tk, tv, tdo, out, lse,
                                        causal)
    zero = torch.zeros_like(lse)
    wrong = (TA.flash_attention_bwd_dq_plain(tq, tk, tv, tdo, lse, zero,
                                             causal),
             TA.flash_attention_bwd_dkv_plain(tq, tk, tv, tdo, lse, zero,
                                              causal)[0])
    for g, w, e in zip(wrong, want[:2], extra[:2]):
        bound = CS.bwd_bound(w, RTOL, ATOL, e)
        assert CS.err_ratio(g, w, 0, 0, bound=bound) > 1
    keep = slice(0, t_k - BLOCK)
    kd, vd = tk[:, keep].contiguous(), tv[:, keep].contiguous()
    out_d, lse_d = TA.flash_attention_fwd_plain(tq, kd, vd, causal)
    wrong_dv = TA.flash_attention_bwd_dkv_plain(
        tq, kd, vd, tdo, lse_d, TA.flash_delta(out_d, tdo), causal)[1]
    bound = CS.bwd_bound(want[2][:, keep], RTOL, ATOL, extra[2][:, keep])
    assert CS.err_ratio(wrong_dv, want[2][:, keep], 0, 0, bound=bound) > 1


@pytest.mark.parametrize("d", [16, 40, 256, 264])
def test_bf16_bwd_keyless_rows_follow_the_dense_path(d):
    """Causal with T_q > T_k: the first T_q - T_k rows have no key. As on
    the dense path, their scores are constants: dq is exactly 0 there, they
    add nothing to dk, and each adds bf16(1/T_k) dO to every key's dv. The
    rows with keys match the Pallas kernels run without the keyless rows
    (whose own answer for keyless rows depends on their tiles)."""
    t_q, t_k = 40, 24
    n_kl = t_q - t_k
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(23, t_q, t_k, d)
    rows = slice(n_kl, None)
    out_s, lse_s, want = _pallas(jq[:, rows], jk, jv, jdo[:, rows], True)
    # the keyless rows' out and lse as the port's forward gives them
    out_kl, lse_kl = TA.flash_attention_fwd_bthd(tq, tk, tv, causal=True)
    out = torch.cat([out_kl[:, :n_kl], out_s], 1)
    lse = torch.cat([lse_kl[:, :n_kl], lse_s], 1)
    dq, dk, dv = TA.flash_attention_bwd_bthd(tq, tk, tv, out, lse, tdo, True)
    assert not dq[:, :n_kl].abs().max()
    extra = CS.flash_bwd_rounding_bound(TA, tq[:, rows].contiguous(), tk, tv,
                                        tdo[:, rows].contiguous(), out_s,
                                        lse_s, True)
    _within(dq[:, rows], want[0], extra[0])
    _within(dk, want[1], extra[1])
    # dv: the Pallas rows' dv (rounded to bf16 once, half an ulp: 2^-8 of
    # it) plus the keyless rows' uniform P^T dO
    uniform = torch.tensor(1.0 / t_k).to(torch.bfloat16).float()
    dv_kl = uniform * tdo[:, :n_kl].float().sum(1, keepdim=True)
    want_dv = want[2].float() + dv_kl
    _within(dv, want_dv, extra[2], slack=2.0 ** -8 * want[2].float().abs())


def _pallas_onepass(jq, jk, jv, jdo, causal):
    return [_torch(g) for g in JA.onepass_attention_bwd_bthd(
        jq, jk, jv, jdo, causal=causal, interpret=True)]


@pytest.mark.parametrize("causal,t_q,t_k", KEYED)
@pytest.mark.parametrize("d", [16, 40, 256, 264])
def test_onepass_bwd_plain_bf16_matches_pallas_interpret(d, causal, t_q,
                                                          t_k):
    """The one-pass plain version against the Pallas kernel under the
    one-pass bound: BWD_TOL's plus onepass_bwd_rounding_bound."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(24, t_q, t_k, d)
    want = _pallas_onepass(jq, jk, jv, jdo, causal)
    before = TA.onepass_attention_bwd_bthd.launches
    got = TA.onepass_attention_bwd_bthd(tq, tk, tv, tdo, causal)
    assert TA.onepass_attention_bwd_bthd.launches == before   # no kernel
    extra = CS.onepass_bwd_rounding_bound(TA, tq, tk, tv, tdo, causal)
    for g, w, e, x in zip(got, want, extra, (tq, tk, tv)):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
        _within(g, w, e, tol=ONEPASS_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 256])
def test_onepass_bwd_bound_rejects_a_wrong_plain_version(d, causal):
    """The one-pass bound is no blanket either: chip_smoke.py's control with
    delta dropped (dq, dk), and the plain version with the last key tile
    dropped (dv), fall outside it."""
    t_q, t_k = 48, 48
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(25, t_q, t_k, d)
    want = _pallas_onepass(jq, jk, jv, jdo, causal)
    extra = CS.onepass_bwd_rounding_bound(TA, tq, tk, tv, tdo, causal)
    wrong = CS._onepass_bwd_no_delta(TA, tq, tk, tv, tdo, causal)
    for g, w, e in zip(wrong[:2], want[:2], extra[:2]):
        bound = CS.bwd_bound(w, *ONEPASS_TOL, e)
        assert CS.err_ratio(g, w, 0, 0, bound=bound) > 1
    keep = slice(0, t_k - BLOCK)
    wrong_dv = TA.onepass_attention_bwd_plain(
        tq, tk[:, keep].contiguous(), tv[:, keep].contiguous(), tdo,
        causal)[2]
    bound = CS.bwd_bound(want[2][:, keep], *ONEPASS_TOL, extra[2][:, keep])
    assert CS.err_ratio(wrong_dv, want[2][:, keep], 0, 0, bound=bound) > 1


def test_bf16_flip_marks_only_terms_near_a_rounding_midpoint():
    """A term moves under bf16 rounding only where a midpoint lies within
    its possible error, and then by that error plus one bf16 ulp."""
    x = torch.tensor([1.0, 1.0 + 2 ** -8, 1.0 + 2 ** -9, 0.0, -(1 + 2 ** -8)])
    eps = torch.full_like(x, 1e-6)
    got = CS._bf16_flip(x, eps)
    want = torch.tensor([0.0, 1e-6 + 2 ** -7, 0.0, 1e-6 + 2 ** -27,
                         1e-6 + 2 ** -7])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
