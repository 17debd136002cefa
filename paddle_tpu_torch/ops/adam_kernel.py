"""Fused dense-Adam update: the CUDA kernel for Hopper, its plain PyTorch
version, and the JAX package's admission rule.

Counterpart of ``paddle_tpu/ops/adam_kernel.py``; the kernel
(``csrc/adam.cu``) replaces the Pallas ``_kernel``
(paddle_tpu/ops/adam_kernel.py:53). One elementwise pass per parameter,
in place on p, m1 and m2, as the Pallas kernel aliases them:

    m1' = b1*m1 + (1-b1)*g                (f32)
    m2' = b2*m2 + (1-b2)*g*g              (f32)
    step = lr_t*m1' / (sqrt(m2') + eps)   (f32, rounded to p's dtype)
    p'   = p - step                       (in f32, rounded to p's dtype once)

lr_t is a 0-d f32 tensor on the device, read by the kernel through a
pointer. ``adam_ok`` and ``_block_rows`` are the JAX package's, verbatim, so
the same parameters take the kernel: the TPU's VMEM budget is not the
card's limit, but the rule decides which 67 parameters of the flagship
model do.
"""
import torch

from . import _build

_VMEM_BUDGET = 12 * 1024 * 1024
_BYTES_PER_ELEM = 40   # f32 staging for p/g/m1/m2 + 3 outputs, ~double-buffered
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def adam_ok(shape, cols_multiple=128):
    """2-D, lane-aligned, sublane-aligned rows: the whole hot set (qkv/out
    [512,512], FFN [512,2048]/[2048,512], embed/head [V,512]/[512,V])."""
    if len(shape) != 2:
        return False
    r, c = int(shape[0]), int(shape[1])
    return r % 8 == 0 and c % cols_multiple == 0 and _block_rows(r, c) > 0


def _block_rows(r, c):
    fit = _VMEM_BUDGET // max(1, c * _BYTES_PER_ELEM)
    if fit < 8:
        return 0   # even the minimum 8-row block would overflow VMEM
    b = min(r, fit)
    b = 1 << (b.bit_length() - 1)      # power of two
    while b >= 8 and r % b:
        b //= 2
    return b if b >= 8 and r % b == 0 else 0


def adam_update_plain(p, g, m1, m2, lr_t, b1, b2, eps):
    """Plain version of the kernel, with its rounding points. Returns new
    (p', m1', m2')."""
    gf = g.float()
    m1_out = b1 * m1 + (1.0 - b1) * gf
    m2_out = b2 * m2 + (1.0 - b2) * gf * gf
    step = (lr_t.reshape(()) * m1_out / (torch.sqrt(m2_out) + eps)).to(p.dtype)
    return p - step, m1_out, m2_out


def _check(p, g, m1, m2, lr_t):
    dev = p.device
    if not (p.is_cuda and all(t.device == dev for t in (g, m1, m2, lr_t))):
        raise ValueError("adam_update: p, g, m1, m2, lr_t must be on one "
                         "CUDA device")
    if p.dtype not in _DTYPE_CODE or g.dtype not in _DTYPE_CODE or \
            m1.dtype != torch.float32 or m2.dtype != torch.float32 or \
            lr_t.dtype != torch.float32:
        raise TypeError("adam_update: p and g must be float32 or bfloat16, "
                        "m1, m2 and lr_t float32; got %s/%s/%s/%s/%s" % (
                            p.dtype, g.dtype, m1.dtype, m2.dtype, lr_t.dtype))
    if not adam_ok(p.shape) or g.shape != p.shape or m1.shape != p.shape \
            or m2.shape != p.shape or lr_t.numel() != 1:
        raise ValueError("adam_update: the kernel takes a 2-D p with rows "
                         "%% 8 == 0 and cols %% 128 == 0 and g, m1, m2 of "
                         "its shape, got %s, %s, %s, %s" % (
                             tuple(p.shape), tuple(g.shape), tuple(m1.shape),
                             tuple(m2.shape)))
    if p.numel() >= 2 ** 31:
        raise ValueError("adam_update: at most 2^31 - 1 elements")
    if not all(t.is_contiguous() for t in (p, g, m1, m2, lr_t)):
        raise ValueError("adam_update: tensors must be contiguous")


def adam_update(p, g, m1, m2, lr_t, b1, b2, eps):
    """Fused Adam on a 2-D parameter, in place on p, m1 and m2; returns
    (p, m1, m2). The CUDA kernel for CUDA tensors (or raises), the plain
    version for CPU tensors (its result copied into p, m1 and m2)."""
    if p.device.type == "cpu":
        new = adam_update_plain(p, g, m1, m2, lr_t, b1, b2, eps)
        for dst, src in zip((p, m1, m2), new):
            dst.copy_(src)
        return p, m1, m2
    _check(p, g, m1, m2, lr_t)
    # (1 - b) in double, then rounded to f32, as the plain version's
    _build.launch(adam_update, "adam", "adam_update", p.device, p, g, m1, m2,
                  lr_t, p.numel(), float(b1), float(1.0 - b1), float(b2),
                  float(1.0 - b2), float(eps), _DTYPE_CODE[p.dtype],
                  _DTYPE_CODE[g.dtype])
    return p, m1, m2


adam_update.launches = 0
