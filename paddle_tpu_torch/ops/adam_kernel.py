"""Fused dense-Adam update: the CUDA kernel for Hopper, its plain PyTorch
version, and the JAX package's admission rule.

Counterpart of ``paddle_tpu/ops/adam_kernel.py``; the kernel
(``csrc/adam.cu``) replaces the Pallas ``_kernel``
(paddle_tpu/ops/adam_kernel.py:53). One elementwise pass, in place on p, m1
and m2, as the Pallas kernel aliases them, over a whole list of parameters
in one launch (``adam_update_multi``; a training step's optimizer ops go to
it as one group), or over one (``adam_update``, a one-entry call of the
same kernel):

    m1' = b1*m1 + (1-b1)*g                (f32)
    m2' = b2*m2 + (1-b2)*g*g              (f32)
    step = lr_t*m1' / (sqrt(m2') + eps)   (f32, rounded to p's dtype)
    p'   = p - step                       (in f32, rounded to p's dtype once)

lr_t is a one-element f32 tensor on the device per parameter, read by the
kernel through a pointer. ``adam_ok`` and ``_block_rows`` are the JAX
package's, verbatim, so the same parameters take the kernel: the TPU's VMEM
budget is not the card's limit, but the rule decides which 67 parameters of
the flagship model do.
"""
import array

import torch

from . import _build

_VMEM_BUDGET = 12 * 1024 * 1024
_BYTES_PER_ELEM = 40   # f32 staging for p/g/m1/m2 + 3 outputs, ~double-buffered
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the descriptors one launch takes (csrc/adam.cu kMaxTensors: what fits the 4
# KB of kernel parameters)
_MAX_TENSORS = 72


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
    _launch(adam_update, [p], [g], [m1], [m2], [lr_t], b1, b2, eps)
    return p, m1, m2


adam_update.launches = 0


def adam_update_multi_plain(ps, gs, m1s, m2s, lr_ts, b1, b2, eps):
    """Plain version of the multi-tensor kernel: adam_update_plain on each
    parameter. Returns a list of (p', m1', m2')."""
    return [adam_update_plain(p, g, m1, m2, lr_t, b1, b2, eps)
            for p, g, m1, m2, lr_t in zip(ps, gs, m1s, m2s, lr_ts,
                                          strict=True)]


def _table(ps, gs, m1s, m2s, lr_ts):
    """The kernel's descriptor rows (p, g, m1, m2, lr_t pointers, elements,
    p's and g's dtype codes) as one int64 array, after the checks the kernel
    needs: one CUDA device, p and g float32 or bfloat16, m1, m2 and lr_t
    float32, g, m1 and m2 as many elements as p, one lr_t value, contiguous.
    Kept to one pass of cheap attribute reads: it runs every step."""
    f32, code = torch.float32, _DTYPE_CODE
    dev = ps[0].get_device()
    rows = []
    for p, g, m1, m2, lr_t in zip(ps, gs, m1s, m2s, lr_ts, strict=True):
        n = p.numel()
        if not (dev >= 0 and g.numel() == n == m1.numel() == m2.numel() and
                lr_t.numel() == 1 and m1.dtype is f32 and m2.dtype is f32 and
                lr_t.dtype is f32 and p.dtype in code and g.dtype in code and
                p.is_contiguous() and g.is_contiguous() and
                m1.is_contiguous() and m2.is_contiguous() and
                p.get_device() == g.get_device() == m1.get_device() ==
                m2.get_device() == lr_t.get_device() == dev and n < 2 ** 31):
            raise ValueError(
                "adam_update_multi: each p, g must be float32 or bfloat16 "
                "and m1, m2, lr_t float32, contiguous, on one CUDA device, "
                "with g, m1, m2 of p's size and one lr_t value; got %s" % (
                    [(tuple(t.shape), t.dtype, str(t.device))
                     for t in (p, g, m1, m2, lr_t)],))
        rows += (p.data_ptr(), g.data_ptr(), m1.data_ptr(), m2.data_ptr(),
                 lr_t.data_ptr(), n, code[p.dtype], code[g.dtype])
    return array.array("q", rows)


def _launch(wrapper, ps, gs, m1s, m2s, lr_ts, b1, b2, eps):
    """One launch per _MAX_TENSORS parameters (the descriptors a launch
    takes by value)."""
    table = _table(ps, gs, m1s, m2s, lr_ts)
    row = table.itemsize * 8
    for i in range(0, len(ps), _MAX_TENSORS):
        # (1 - b) in double, then rounded to f32, as the plain version's
        _build.launch(wrapper, "adam", "adam_update_multi", ps[0].device,
                      table.buffer_info()[0] + i * row,
                      min(_MAX_TENSORS, len(ps) - i), float(b1),
                      float(1.0 - b1), float(b2), float(1.0 - b2),
                      float(eps))


def adam_update_multi(ps, gs, m1s, m2s, lr_ts, b1, b2, eps):
    """Fused Adam on a list of parameters of any shape, in place on each p,
    m1 and m2, with one lr_t (a one-element f32 tensor) per parameter;
    returns (ps, m1s, m2s). For CUDA tensors one kernel launch covers up to
    72 parameters, so the flagship's 67 take one (or raises;
    ``last_tensors`` counts the parameters of the call); for CPU tensors the
    plain version runs, its results copied in."""
    if not ps:
        return ps, m1s, m2s
    if ps[0].device.type == "cpu":
        if any(t.device.type != "cpu"
               for ts in (ps, gs, m1s, m2s, lr_ts) for t in ts):
            raise ValueError("adam_update_multi: the tensors must all be on "
                             "the CPU or all on one CUDA device")
        for p, m1, m2, new in zip(ps, m1s, m2s, adam_update_multi_plain(
                ps, gs, m1s, m2s, lr_ts, b1, b2, eps)):
            for dst, src in zip((p, m1, m2), new):
                dst.copy_(src)
        return ps, m1s, m2s
    _launch(adam_update_multi, ps, gs, m1s, m2s, lr_ts, b1, b2, eps)
    adam_update_multi.last_tensors = len(ps)
    return ps, m1s, m2s


adam_update_multi.launches = 0
adam_update_multi.last_tensors = 0
