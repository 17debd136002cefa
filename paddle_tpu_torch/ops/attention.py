"""Attention on the native [B, T, H, D] ("bthd") layout: the one-pass and
flash CUDA kernels for Hopper, forward and backward, their plain PyTorch
versions, the dense path, and ``fused_attention_bthd`` with the JAX
package's dispatch.

Counterpart of ``paddle_tpu/ops/attention.py``. Dispatch (``_bthd_mode``)
is kept exactly: on the card, T_q and T_k <= FLAGS_onepass_max_seq with
D % 8 == 0 and H*D % 128 == 0 take the one-pass kernel; otherwise
T_k >= FLAGS_flash_min_seq takes the flash kernel; everything else, and
every tensor off the card, takes the dense path, which stays plain
PyTorch as it stays XLA in the JAX package.

The forward kernels live in ``csrc/attention.cu``: for bfloat16 on the
tensor cores (wgmma, bf16 tiles in shared memory by cp.async), for float32
on the CUDA cores (the tensor cores would take f32 only as TF32). Both keep
their Pallas kernels' rounding points:

- one-pass (replaces ``_onepass_fwd_kernel``, paddle_tpu/ops/attention.py:123):
  S = QK^T*scale in f32, causal mask to NEG_INF, exact row max and sum,
  P normalised in f32, then cast to V's dtype, then P.V accumulated in f32.
- flash (replaces ``_fwd_kernel``, paddle_tpu/ops/attention.py:272): k-tiled
  online softmax with running m, l and an f32 accumulator; the unnormalised
  P is cast to V's dtype before P.V; the accumulator is divided by l at the
  end; lse = m + log l is returned as [B, T_q, H] f32.

Causal masks are bottom-right aligned (col <= row + T_k - T_q), as in the
JAX package. A row with no key (causal, T_q > T_k) gets a uniform softmax
over all keys on every path here; the Pallas flash kernel's answer for it
depends on its tiles (0/0 where a whole q-tile has no key). Each wrapper
runs the kernel for a CUDA tensor (or raises) and the plain version only
for a CPU tensor; ``launches`` on the wrapper counts kernel launches.

The backward kernels live in ``csrc/attention_bwd.cu``:

- one-pass backward (replaces ``_onepass_bwd_kernel``, attention.py:146):
  P recomputed and normalised in f32 by the exact row max and sum, delta =
  rowsum(dP o P) from P, dS rounded to the input dtype, dQ = dS K, dK =
  dS^T Q, dV = P^T dO with P rounded first; two launches per call (dq with
  the row statistics, then dk and dv).
- flash backward (replaces ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``,
  attention.py:400 and :447): P = exp(S - lse) per tile, delta =
  rowsum(dO o O) computed outside; one wrapper per kernel. bfloat16 runs
  on the tensor cores, float32 on the CUDA cores, as in the forward.

Head dims: any D % 8 == 0, as the JAX package's gate asks; a kernel
wrapper raises on others. bfloat16 runs the tensor cores up to D = 256
(padded to 64, 128 or 256) and the CUDA-core kernels, instantiated for
bf16, past it; float32 runs the CUDA-core kernels at every D. Past 128
columns those split the output into 128-column chunks, one block each, and
stream the sums over all of D (S, dP) in 128-column pieces, so their tiles
and registers stay those of D = 128.

In the backward a keyless row keeps the dense path's answer: P = 1/T_k over
all keys, dS = 0. ``fused_attention_bthd`` is differentiable: an
autograd.Function runs the kernels with the JAX package's residuals.
"""
import math

import torch

from ..fluid import flags
from . import _build

NEG_INF = -1e30        # avoids inf-inf=nan in the online-softmax rescale

# the card's ceiling on the float32 one-pass kernel's shared-memory score
# tile: 64 query rows x T_k f32 scores, plus the Q and K/V staging tiles,
# must fit the 227 KB a block may use (the bf16 kernel keeps no score tile;
# both take the same T_k)
_ONEPASS_KERNEL_MAX_TK = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _flash_min_seq():
    return flags.get("flash_min_seq")


def _onepass_max_seq():
    return flags.get("onepass_max_seq")


def _scale_of(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _scores(q, k, causal, scale):
    """S = QK^T*scale as [B, H, T_q, T_k] f32, masked to NEG_INF above the
    bottom-right-aligned diagonal."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        keep = torch.ones(t_q, t_k, dtype=torch.bool,
                          device=s.device).tril(diagonal=t_k - t_q)
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s


def _pv(p, v, out_dtype):
    """P (already in V's dtype) times V, accumulated in f32, as [B,T,H,D]."""
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(out_dtype)


def dense_attention_bthd(q, k, v, causal=False, scale=None):
    """Dense attention on [B, T, H, D]: the path for short sequences off the
    card and for 512 < T_k < 1024 on it."""
    s = _scores(q, k, causal, _scale_of(q, scale))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return _pv(p, v, v.dtype)


# --------------------------------------------------------------------------
# one-pass kernel
# --------------------------------------------------------------------------

def onepass_attention_fwd_plain(q, k, v, causal=False, scale=None):
    """Plain version of the one-pass kernel, with its rounding points."""
    s = _scores(q, k, causal, _scale_of(q, scale))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return _pv(p.to(v.dtype), v, q.dtype)


def _check_kernel_inputs(name, q, k, v, max_tk):
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("%s: q, k, v must all be float32 or bfloat16, got "
                        "%s/%s/%s" % (name, q.dtype, k.dtype, v.dtype))
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError("%s: want q [B,T_q,H,D] and k, v [B,T_k,H,D], got "
                         "%s, %s, %s" % (name, tuple(q.shape), tuple(k.shape),
                                         tuple(v.shape)))
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    if d % 8 or min(b, t_q, t_k, h) < 1:
        raise ValueError("%s: needs D a multiple of 8 and non-empty B, T, H; "
                         "got %s" % (name, tuple(q.shape)))
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("%s: q, k, v must be on one CUDA device" % name)
    if t_k > max_tk:
        raise ValueError("%s: T_k=%d exceeds the kernel's %d"
                         % (name, t_k, max_tk))
    if h > 65535 or b > 65535:
        raise ValueError("%s: B and H must be at most 65535" % name)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("%s: q, k, v must be contiguous" % name)


def onepass_attention_fwd_bthd(q, k, v, causal=False, scale=None):
    """Short-sequence fused attention forward on [B, T, H, D]: the one-pass
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return onepass_attention_fwd_plain(q, k, v, causal, scale)
    _check_kernel_inputs("onepass_attention_fwd_bthd", q, k, v,
                         _ONEPASS_KERNEL_MAX_TK)
    b, t_q, h, d = q.shape
    out = torch.empty_like(q)
    _build.launch(onepass_attention_fwd_bthd, "attention",
                  "onepass_attention_fwd", q.device, q, k, v, out, b, t_q,
                  k.shape[1], h, d, float(_scale_of(q, scale)),
                  int(bool(causal)), _DTYPE_CODE[q.dtype])
    return out


onepass_attention_fwd_bthd.launches = 0


# --------------------------------------------------------------------------
# flash kernel
# --------------------------------------------------------------------------

def flash_attention_fwd_plain(q, k, v, causal=False, scale=None):
    """Plain version of the flash kernel in one tile: unnormalised P cast to
    V's dtype before P.V, divided by l at the end. Returns (out, lse)."""
    s = _scores(q, k, causal, _scale_of(q, scale))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)                     # [B, H, T_q, 1]
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(l))[..., 0].permute(0, 2, 1).contiguous()
    return out, lse


def flash_attention_fwd_bthd(q, k, v, causal=False, scale=None):
    """Long-sequence flash attention forward on [B, T, H, D]. Returns
    (out [B,T_q,H,D], lse [B,T_q,H] f32): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    _check_kernel_inputs("flash_attention_fwd_bthd", q, k, v, 2 ** 31 - 1)
    b, t_q, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, t_q, h), dtype=torch.float32, device=q.device)
    _build.launch(flash_attention_fwd_bthd, "attention",
                  "flash_attention_fwd", q.device, q, k, v, out, lse, b, t_q,
                  k.shape[1], h, d, float(_scale_of(q, scale)),
                  int(bool(causal)), _DTYPE_CODE[q.dtype])
    return out, lse


flash_attention_fwd_bthd.launches = 0


def last_kernel_name():
    """Name of the CUDA kernel instantiation that the last forward launch
    ran: ``*_wgmma<64|128|256>`` (tensor cores) for bfloat16 up to D = 256,
    ``*<__nv_bfloat16>`` (CUDA cores) past it, ``*<float>`` (CUDA cores) for
    float32."""
    return _build.library("attention").attention_last_kernel().decode()


# --------------------------------------------------------------------------
# backward kernels (csrc/attention_bwd.cu)
# --------------------------------------------------------------------------

def _keyless(q, k, causal):
    """[T_q, 1] bool: rows with no key (causal, row + T_k - T_q < 0)."""
    t_q, t_k = q.shape[1], k.shape[1]
    rows = torch.arange(t_q, device=q.device)[:, None]
    return (rows + (t_k - t_q) < 0) if causal else \
        torch.zeros(t_q, 1, dtype=torch.bool, device=q.device)


def _masked(q, k, causal):
    """[T_q, T_k] bool: the positions the causal mask removes."""
    t_q, t_k = q.shape[1], k.shape[1]
    keep = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device)
    return ~keep.tril(diagonal=t_k - t_q) if causal else ~keep


def _ds(p, dp, delta, masked, scale, dtype):
    """dS = P o (dP - delta) * scale rounded to dtype, 0 where masked."""
    ds = p * (dp - delta) * scale
    return torch.where(masked, torch.zeros_like(ds), ds).to(dtype)


def _dkv(q, do, p, ds, k, v):
    """dK = dS^T Q and dV = P^T dO (P rounded to dO's dtype), accumulated
    in f32, rounded once."""
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def onepass_attention_bwd_plain(q, k, v, do, causal=False, scale=None):
    """Plain version of the one-pass backward kernel: P recomputed with the
    exact row max and sum and normalised in f32, delta = rowsum(dP o P)
    from P (not from O), dS rounded to the input dtype. Returns (dq, dk,
    dv)."""
    scale = _scale_of(q, scale)
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = _ds(p, dp, delta, _masked(q, k, causal), scale, q.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.float(), k.float()).to(q.dtype)
    return (dq,) + _dkv(q, do, p, ds, k, v)


def onepass_attention_bwd_bthd(q, k, v, do, causal=False, scale=None):
    """Short-sequence fused attention backward on [B, T, H, D]: the one-pass
    CUDA kernels (two launches: dq with the row max, sum and delta, then dk
    and dv) for CUDA tensors, the plain version for CPU tensors. Returns
    (dq, dk, dv)."""
    if q.device.type == "cpu":
        return onepass_attention_bwd_plain(q, k, v, do, causal, scale)
    name = "onepass_attention_bwd_bthd"
    _check_kernel_inputs(name, q, k, v, _ONEPASS_KERNEL_MAX_TK)
    _check_like(name, do, q, "do")
    b, t_q, h, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the first launch's row max (bfloat16: in base 2, of S scale log2 e),
    # row sum and delta, read by the second
    m, l, delta = torch.empty((3, b, t_q, h), dtype=torch.float32,
                              device=q.device)
    _build.launch(onepass_attention_bwd_bthd, "attention_bwd",
                  "onepass_attention_bwd", q.device, q, k, v, do, dq, dk, dv,
                  m, l, delta, b, t_q, k.shape[1], h, d,
                  float(_scale_of(q, scale)), int(bool(causal)),
                  _DTYPE_CODE[q.dtype])
    return dq, dk, dv


onepass_attention_bwd_bthd.launches = 0


def _flash_p(q, k, lse, causal, scale):
    """P = exp(S - lse) in f32, [B, H, T_q, T_k]; a keyless row gets the
    dense path's uniform 1/T_k."""
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.permute(0, 2, 1)[..., None])
    return torch.where(_keyless(q, k, causal),
                       torch.full_like(p, 1.0 / k.shape[1]), p)


def _flash_ds(q, k, v, do, lse, delta, causal, scale):
    scale = _scale_of(q, scale)
    p = _flash_p(q, k, lse, causal, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = _ds(p, dp, delta.permute(0, 2, 1)[..., None],
             _masked(q, k, causal), scale, q.dtype)
    return p, ds


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal=False,
                                 scale=None):
    """Plain version of the flash dq kernel: dq = dS K in f32, rounded
    once."""
    _, ds = _flash_ds(q, k, v, do, lse, delta, causal, scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds.float(), k.float()).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal=False,
                                  scale=None):
    """Plain version of the flash dkv kernel. Returns (dk, dv)."""
    p, ds = _flash_ds(q, k, v, do, lse, delta, causal, scale)
    return _dkv(q, do, p, ds, k, v)


def _check_like(name, t, ref, what):
    if t.shape != ref.shape or t.dtype != ref.dtype or \
            t.device != ref.device or not t.is_contiguous():
        raise ValueError("%s: %s must be a contiguous tensor like q, got %s %s"
                         % (name, what, tuple(t.shape), t.dtype))


def _check_rows(name, t, q, what):
    b, t_q, h, _ = q.shape
    if tuple(t.shape) != (b, t_q, h) or t.dtype != torch.float32 or \
            t.device != q.device or not t.is_contiguous():
        raise ValueError("%s: %s must be contiguous [B, T_q, H] float32, got "
                         "%s %s" % (name, what, tuple(t.shape), t.dtype))


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False,
                           scale=None):
    """Flash backward, dq: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. lse and delta are [B, T_q, H] f32."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                            scale)
    name = "flash_attention_bwd_dq"
    _check_kernel_inputs(name, q, k, v, 2 ** 31 - 1)
    _check_like(name, do, q, "do")
    _check_rows(name, lse, q, "lse")
    _check_rows(name, delta, q, "delta")
    b, t_q, h, d = q.shape
    dq = torch.empty_like(q)
    _build.launch(flash_attention_bwd_dq, "attention_bwd",
                  "flash_attention_bwd_dq", q.device, q, k, v, do, lse, delta,
                  dq, b, t_q, k.shape[1], h, d, float(_scale_of(q, scale)),
                  int(bool(causal)), _DTYPE_CODE[q.dtype])
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            scale=None):
    """Flash backward, dk and dv: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Returns (dk, dv)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                             scale)
    name = "flash_attention_bwd_dkv"
    _check_kernel_inputs(name, q, k, v, 2 ** 31 - 1)
    _check_like(name, do, q, "do")
    _check_rows(name, lse, q, "lse")
    _check_rows(name, delta, q, "delta")
    b, t_q, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.launch(flash_attention_bwd_dkv, "attention_bwd",
                  "flash_attention_bwd_dkv", q.device, q, k, v, do, lse,
                  delta, dk, dv, b, t_q, k.shape[1], h, d,
                  float(_scale_of(q, scale)), int(bool(causal)),
                  _DTYPE_CODE[q.dtype])
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def last_bwd_kernel_name():
    """Name of the CUDA kernel instantiation that the last backward launch
    ran: the flash backward's ``flash_bwd_{dq,dkv}_kernel_wgmma<DP>``
    (tensor cores, DP = 64, 128 or 256) for bfloat16 up to D = 256,
    ``flash_bwd_dq_kernel<T>`` or ``bwd_dkv_kernel<T, false>`` (CUDA cores)
    for float32 (T = float) and for bfloat16 past D = 256 (T =
    __nv_bfloat16); the one-pass backward's two launches as "dq + dkv":
    ``onepass_bwd_dq_kernel_wgmma<DP> + onepass_bwd_dkv_kernel_wgmma<DP>``
    for bfloat16 up to D = 256, ``onepass_bwd_dq_kernel<T> +
    bwd_dkv_kernel<T, true>`` on the CUDA cores."""
    return _build.library("attention_bwd").attention_bwd_last_kernel().decode()


def flash_delta(out, do):
    """delta = rowsum(dO o O) in f32, [B, T_q, H] (outside the kernels, as
    in the JAX package)."""
    return (do.float() * out.float()).sum(dim=-1)


def flash_attention_bwd_bthd(q, k, v, out, lse, do, causal=False,
                             scale=None):
    """Flash backward on [B, T, H, D] from the forward's out and lse:
    delta, then the dq and dkv kernels. Returns (dq, dk, dv)."""
    delta = flash_delta(out, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


# --------------------------------------------------------------------------
# public op: the JAX package's dispatch, kernels on the card
# --------------------------------------------------------------------------

def _use_kernels(q):
    """The port's ``_use_pallas()``: the tensors are on a CUDA card."""
    return q.is_cuda


def _onepass_ok(q, k):
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    return (t_k <= _onepass_max_seq() and t_q <= _onepass_max_seq()
            and d % 8 == 0 and (h * d) % 128 == 0)


_MODE_DENSE, _MODE_ONEPASS, _MODE_FLASH = 0, 1, 2


def _bthd_mode(q, k):
    if not _use_kernels(q):
        return _MODE_DENSE
    if _onepass_ok(q, k):
        return _MODE_ONEPASS
    if k.shape[1] >= _flash_min_seq():
        return _MODE_FLASH
    return _MODE_DENSE


class _FusedAttention(torch.autograd.Function):
    """The one-pass or flash kernel with its backward kernel. Residuals are
    the JAX package's: (q, k, v) for one-pass, (q, k, v, out, lse) for
    flash."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, mode):
        if mode == _MODE_FLASH:
            out, lse = flash_attention_fwd_bthd(q, k, v, causal, scale)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = onepass_attention_fwd_bthd(q, k, v, causal, scale)
            ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale, ctx.mode = causal, scale, mode
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.mode == _MODE_FLASH:
            q, k, v, out, lse = ctx.saved_tensors
            grads = flash_attention_bwd_bthd(q, k, v, out, lse, g,
                                             ctx.causal, ctx.scale)
        else:
            q, k, v = ctx.saved_tensors
            grads = onepass_attention_bwd_bthd(q, k, v, g, ctx.causal,
                                               ctx.scale)
        return grads + (None, None, None)


def fused_attention_bthd(q, k, v, causal=False, scale=None):
    """[B,T,H,D] attention — the transpose-free path used by the Transformer.
    Differentiable: the kernel modes backpropagate through their backward
    kernels, the dense mode through torch autograd (as the JAX package's
    dense mode through jax.vjp)."""
    mode = _bthd_mode(q, k)
    if mode == _MODE_DENSE:
        return dense_attention_bthd(q, k, v, causal, scale)
    return _FusedAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, scale, mode)
