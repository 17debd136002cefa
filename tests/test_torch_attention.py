"""The port's attention (paddle_tpu_torch/ops/attention.py) against the JAX
package's Pallas kernels run in interpret mode on the CPU.

On the CPU each kernel wrapper runs its plain PyTorch version, so these
tests hold the plain versions (the reference the CUDA kernels are compared
with on the card by chip_smoke.py) to the Pallas kernels' arithmetic. Inputs
come from a seeded numpy RNG and go to both packages as the same arrays.
Tolerance: 1e-5 in float32 (the two differ only in summation order).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops import attention as JA
from paddle_tpu_torch.ops import attention as TA

TOL = 1e-5


def _qkv(seed, b, t_q, t_k, h, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t_q, h, d).astype("float32"),
            rng.randn(b, t_k, h, d).astype("float32"),
            rng.randn(b, t_k, h, d).astype("float32"))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t_q,t_k", [(32, 32), (16, 32)])
def test_onepass_plain_matches_pallas_interpret(causal, t_q, t_k):
    q, k, v = _qkv(5, 2, t_q, t_k, 2, 8)
    want = JA.onepass_attention_fwd_bthd(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal,
                                         block_q=8, interpret=True)
    before = TA.onepass_attention_fwd_bthd.launches
    got = TA.onepass_attention_fwd_bthd(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), causal)
    assert TA.onepass_attention_fwd_bthd.launches == before  # no kernel on CPU
    assert got.dtype == torch.float32 and got.shape == q.shape
    _close(got, want)


@pytest.mark.parametrize("causal,t_q,t_k", [
    (False, 32, 32), (True, 32, 32), (False, 16, 32), (True, 16, 32),
    (False, 32, 16)])
def test_flash_plain_matches_pallas_interpret(causal, t_q, t_k):
    q, k, v = _qkv(6, 1, t_q, t_k, 2, 8)
    want_out, want_lse = JA.flash_attention_fwd_bthd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=8, block_k=8, interpret=True)
    before = TA.flash_attention_fwd_bthd.launches
    out, lse = TA.flash_attention_fwd_bthd(torch.from_numpy(q),
                                           torch.from_numpy(k),
                                           torch.from_numpy(v), causal)
    assert TA.flash_attention_fwd_bthd.launches == before
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (1, t_q, 2)
    _close(out, want_out)
    _close(lse, want_lse)


@pytest.mark.parametrize("t_q", [32, 28])
def test_flash_plain_keyless_rows_follow_the_dense_path(t_q):
    """Causal with T_q > T_k: rows before T_q - T_k have no key. The port
    gives them the dense path's (and the one-pass kernel's) uniform softmax
    over all keys, whatever the tiling. The Pallas kernel's answer for them
    depends on its tiles: 0/0 in a q-tile with no key at all, uniform over
    the k-tiles it visits otherwise. Rows with keys match it."""
    t_k = 16
    keyless = t_q - t_k
    q, k, v = _qkv(8, 1, t_q, t_k, 2, 8)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_out, want_lse = JA.flash_attention_fwd_bthd(
        jq, jk, jv, causal=True, block_q=8, block_k=8, interpret=True)
    want_out, want_lse = np.asarray(want_out), np.asarray(want_lse)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = TA.flash_attention_fwd_bthd(tq, tk, tv, causal=True)
    _close(out[:, keyless:], want_out[:, keyless:])
    _close(lse[:, keyless:], want_lse[:, keyless:])
    if t_q == 32:       # q-tiles 0 and 1 hold no key: Pallas gives 0/0
        assert not np.isfinite(want_out[:, :keyless]).any()
    dense = np.asarray(JA.dense_attention_bthd(jq, jk, jv, causal=True))
    _close(out[:, :keyless], dense[:, :keyless])
    _close(out[:, :keyless], v.mean(axis=1, keepdims=True).repeat(keyless, 1))
    _close(TA.onepass_attention_fwd_bthd(tq, tk, tv, causal=True), dense)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_attention_cpu_takes_dense_path(causal):
    """Off the card the dispatch picks the dense path, as the JAX package
    does off the TPU, and no kernel wrapper runs."""
    q, k, v = _qkv(7, 2, 16, 24, 2, 8)
    tq = [torch.from_numpy(a) for a in (q, k, v)]
    assert TA._bthd_mode(tq[0], tq[1]) == TA._MODE_DENSE
    counts = (TA.onepass_attention_fwd_bthd.launches,
              TA.flash_attention_fwd_bthd.launches)
    got = TA.fused_attention_bthd(*tq, causal=causal)
    assert counts == (TA.onepass_attention_fwd_bthd.launches,
                      TA.flash_attention_fwd_bthd.launches)
    want = JA.dense_attention_bthd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal)
    _close(got, want)


def test_dispatch_thresholds_match_jax(monkeypatch):
    """_bthd_mode's thresholds on the card are the JAX package's flags: a
    stand-in CUDA predicate routes meta tensors through the same decision
    (one-pass to 512, dense between, flash from 1024)."""
    monkeypatch.setattr(TA, "_use_kernels", lambda q: True)

    def mode(t, h=8, d=64):
        x = torch.empty(1, t, h, d, device="meta")
        return TA._bthd_mode(x, x)

    assert mode(256) == TA._MODE_ONEPASS
    assert mode(512) == TA._MODE_ONEPASS
    assert mode(768) == TA._MODE_DENSE
    assert mode(1024) == TA._MODE_FLASH
    assert mode(4096) == TA._MODE_FLASH
    assert mode(256, h=1, d=64) == TA._MODE_DENSE    # H*D % 128 != 0
    monkeypatch.setenv("FLAGS_flash_min_seq", "700")
    assert mode(768) == TA._MODE_FLASH


@pytest.mark.parametrize("fn", [TA.onepass_attention_fwd_bthd,
                                TA.flash_attention_fwd_bthd])
def test_wrappers_never_fall_back_off_the_cpu(fn):
    """A tensor that is not on the CPU reaches the kernel or an exception:
    never the plain version."""
    x = torch.empty(1, 8, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fn(x, x, x)


def test_kernel_sources_exist_and_name_their_pallas_kernels():
    """The CUDA source ships in the package and names the TPU kernels it
    replaces (nvcc builds it on the card, never here)."""
    import os
    from paddle_tpu_torch.ops import _build
    src = open(os.path.join(_build._CSRC, "attention.cu")).read()
    for sym in ("onepass_attention_fwd", "flash_attention_fwd",
                "_onepass_fwd_kernel", "_fwd_kernel", "Hopper"):
        assert sym in src
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    _, out_dir, _ = _build._paths("attention")
    assert os.path.basename(os.path.dirname(out_dir)) == "paddle_tpu_torch"
    assert os.path.basename(os.path.dirname(os.path.dirname(out_dir))) == \
        "build"


# --------------------------------------------------------------------------
# backward: the plain versions against the Pallas backward kernels
# --------------------------------------------------------------------------

def _do(seed, q):
    return np.random.RandomState(seed).randn(*q.shape).astype("float32")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t_q,t_k", [(32, 32), (16, 32)])
def test_onepass_bwd_plain_matches_pallas_interpret(causal, t_q, t_k):
    q, k, v = _qkv(11, 2, t_q, t_k, 2, 8)
    do = _do(12, q)
    want = JA.onepass_attention_bwd_bthd(
        *(jnp.asarray(a) for a in (q, k, v, do)), causal=causal,
        interpret=True)
    before = TA.onepass_attention_bwd_bthd.launches
    got = TA.onepass_attention_bwd_bthd(
        *(torch.from_numpy(a) for a in (q, k, v, do)), causal=causal)
    assert TA.onepass_attention_bwd_bthd.launches == before
    for g, w, a in zip(got, want, (q, k, v)):
        assert g.dtype == torch.float32 and g.shape == a.shape
        _close(g, w)


@pytest.mark.parametrize("causal,t_q,t_k", [
    (False, 32, 32), (True, 32, 32), (False, 16, 32), (True, 16, 32),
    (False, 32, 16), (True, 24, 40)])
def test_flash_bwd_plain_matches_pallas_interpret(causal, t_q, t_k):
    q, k, v = _qkv(13, 1, t_q, t_k, 2, 8)
    do = _do(14, q)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jout, jlse = JA.flash_attention_fwd_bthd(jq, jk, jv, causal=causal,
                                             block_q=8, block_k=8,
                                             interpret=True)
    want = JA.flash_attention_bwd_bthd(jq, jk, jv, jout, jlse, jdo,
                                       causal=causal, block_q=8, block_k=8,
                                       interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = TA.flash_attention_fwd_bthd(tq, tk, tv, causal)
    counts = (TA.flash_attention_bwd_dq.launches,
              TA.flash_attention_bwd_dkv.launches)
    got = TA.flash_attention_bwd_bthd(tq, tk, tv, out, lse, tdo, causal)
    assert counts == (TA.flash_attention_bwd_dq.launches,
                      TA.flash_attention_bwd_dkv.launches)
    for g, w in zip(got, want):
        _close(g, w)
    # the two wrappers alone, with the delta the composite computes
    delta = TA.flash_delta(out, tdo)
    _close(TA.flash_attention_bwd_dq(tq, tk, tv, tdo, lse, delta, causal),
           want[0])
    for g, w in zip(TA.flash_attention_bwd_dkv(tq, tk, tv, tdo, lse, delta,
                                               causal), want[1:]):
        _close(g, w)


def _dense_vjp(q, k, v, do, causal):
    import jax
    _, vjp = jax.vjp(lambda a, b, c: JA.dense_attention_bthd(a, b, c, causal),
                     *(jnp.asarray(x) for x in (q, k, v)))
    return vjp(jnp.asarray(do))


@pytest.mark.parametrize("t_q", [32, 28])
def test_bwd_keyless_rows_follow_the_dense_path(t_q):
    """Causal with T_q > T_k: a row with no key has the dense path's uniform
    softmax, so its scores get no gradient (dq rows 0, nothing into dk) and
    dv takes its dO / T_k. Both backward kernels' plain versions give the
    dense path's vjp."""
    t_k = 16
    q, k, v = _qkv(15, 1, t_q, t_k, 2, 8)
    do = _do(16, q)
    want = _dense_vjp(q, k, v, do, True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    for g, w in zip(TA.onepass_attention_bwd_bthd(tq, tk, tv, tdo, True),
                    want):
        _close(g, w)
    out, lse = TA.flash_attention_fwd_bthd(tq, tk, tv, causal=True)
    got = TA.flash_attention_bwd_bthd(tq, tk, tv, out, lse, tdo, True)
    for g, w in zip(got, want):
        _close(g, w)
    assert not got[0][:, :t_q - t_k].abs().max()


@pytest.mark.parametrize("causal", [False, True])
def test_fused_attention_cpu_grads_match_dense_vjp(causal):
    """fused_attention_bthd is differentiable; on the CPU (dense mode) torch
    autograd gives the JAX dense path's vjp."""
    q, k, v = _qkv(17, 2, 16, 24, 2, 8)
    do = _do(18, q)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = TA.fused_attention_bthd(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(got, _dense_vjp(q, k, v, do, causal)):
        _close(g, w)


@pytest.mark.parametrize("fn,n_in", [
    (TA.onepass_attention_bwd_bthd, 4), (TA.flash_attention_bwd_dq, 4),
    (TA.flash_attention_bwd_dkv, 4)])
def test_bwd_wrappers_never_fall_back_off_the_cpu(fn, n_in):
    x = torch.empty(1, 8, 2, 8, device="meta")
    rows = torch.empty(1, 8, 2, device="meta")
    args = [x] * n_in + ([rows, rows] if n_in == 4 and
                         fn is not TA.onepass_attention_bwd_bthd else [])
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args)


def test_bwd_kernel_source_names_its_pallas_kernels():
    import os
    from paddle_tpu_torch.ops import _build
    src = open(os.path.join(_build._CSRC, "attention_bwd.cu")).read()
    for sym in ("onepass_attention_bwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv", "_onepass_bwd_kernel",
                "_bwd_dq_kernel", "_bwd_dkv_kernel", "Hopper"):
        assert sym in src
    assert set(_build.SIGNATURES) == {"attention", "attention_bwd", "adam",
                                      "ce", "layernorm", "emb_grad"}
