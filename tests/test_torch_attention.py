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
