"""Attention forward on the native [B, T, H, D] ("bthd") layout: the one-pass
and flash CUDA kernels for Hopper, their plain PyTorch versions, the dense
path, and ``fused_attention_bthd`` with the JAX package's dispatch.

Counterpart of ``paddle_tpu/ops/attention.py``. Dispatch (``_bthd_mode``)
is kept exactly: on the card, T_q and T_k <= FLAGS_onepass_max_seq with
D % 8 == 0 and H*D % 128 == 0 take the one-pass kernel; otherwise
T_k >= FLAGS_flash_min_seq takes the flash kernel; everything else, and
every tensor off the card, takes the dense path, which stays plain
PyTorch as it stays XLA in the JAX package.

Both kernels live in ``csrc/attention.cu`` and keep their Pallas kernels'
rounding points:

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
depends on its tiles (0/0 where a whole q-tile has no key). Each wrapper runs the kernel for a CUDA tensor (or raises)
and the plain version only for a CPU tensor; ``launches`` on the wrapper
counts kernel launches.

Forward only: the backward kernels come with the training slice.
"""
import ctypes
import math

import torch

from ..fluid import flags
from . import _build

NEG_INF = -1e30        # avoids inf-inf=nan in the online-softmax rescale

# the card's ceiling on the one-pass kernel's shared-memory score tile: 64
# query rows x T_k f32 scores, plus the Q and K/V staging tiles, must fit
# the 227 KB a block may use
_ONEPASS_KERNEL_MAX_TK = 512
_KERNEL_MAX_D = 128
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
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("%s: q, k, v must be on one CUDA device" % name)
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
    if d % 8 or d > _KERNEL_MAX_D or min(b, t_q, t_k, h) < 1:
        raise ValueError("%s: needs D a multiple of 8 up to %d and non-empty "
                         "B, T, H; got %s" % (name, _KERNEL_MAX_D,
                                              tuple(q.shape)))
    if t_k > max_tk:
        raise ValueError("%s: T_k=%d exceeds the kernel's %d"
                         % (name, t_k, max_tk))
    if h > 65535 or b > 65535:
        raise ValueError("%s: B and H must be at most 65535" % name)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("%s: q, k, v must be contiguous" % name)


def _launch_check(name, err):
    if err != 0:
        raise RuntimeError("%s: CUDA error %d (%s)" % (
            name, err, _build.error_string(err)))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def onepass_attention_fwd_bthd(q, k, v, causal=False, scale=None):
    """Short-sequence fused attention forward on [B, T, H, D]: the one-pass
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return onepass_attention_fwd_plain(q, k, v, causal, scale)
    _check_kernel_inputs("onepass_attention_fwd_bthd", q, k, v,
                         _ONEPASS_KERNEL_MAX_TK)
    b, t_q, h, d = q.shape
    out = torch.empty_like(q)
    lib = _build.library("attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.onepass_attention_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), b, t_q, k.shape[1], h, d,
            float(_scale_of(q, scale)), int(bool(causal)),
            _DTYPE_CODE[q.dtype], ctypes.c_void_p(stream))
    _launch_check("onepass_attention_fwd_bthd", err)
    onepass_attention_fwd_bthd.launches += 1
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
    lib = _build.library("attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), b, t_q,
            k.shape[1], h, d, float(_scale_of(q, scale)), int(bool(causal)),
            _DTYPE_CODE[q.dtype], ctypes.c_void_p(stream))
    _launch_check("flash_attention_fwd_bthd", err)
    flash_attention_fwd_bthd.launches += 1
    return out, lse


flash_attention_fwd_bthd.launches = 0


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


def fused_attention_bthd(q, k, v, causal=False, scale=None):
    """[B,T,H,D] attention — the transpose-free path used by the Transformer.
    Forward only."""
    mode = _bthd_mode(q, k)
    if mode == _MODE_FLASH:
        return flash_attention_fwd_bthd(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal, scale)[0]
    if mode == _MODE_ONEPASS:
        return onepass_attention_fwd_bthd(q.contiguous(), k.contiguous(),
                                          v.contiguous(), causal, scale)
    return dense_attention_bthd(q, k, v, causal, scale)
