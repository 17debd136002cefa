"""One-pass LayerNorm backward: the CUDA kernel for Hopper, its plain
PyTorch version, and the JAX package's admission rule.

Counterpart of ``paddle_tpu/ops/layernorm_kernel.py``; the kernel
(``csrc/layernorm.cu``) replaces the Pallas ``_kernel``
(paddle_tpu/ops/layernorm_kernel.py:43). Per row of x, dy [rows, d], in f32,
the row statistics recomputed from x (two-pass centered variance):

    xhat = (x - mean) * rsqrt(var + eps),  g = dy * gamma
    dx   = rstd * (g - (sum(g) + xhat * sum(g * xhat)) / d)   in x's dtype

dgamma = sum_rows dy * xhat and dbeta = sum_rows dy come out of the same
launch: each block writes a partial row pair and the last blocks to finish
add them in a fixed order (the JAX package sums its per-tile partials
outside the kernel). ``ln_bwd_ok`` and ``_block_rows`` are the JAX
package's, verbatim, so the same shapes take the kernel.
"""
import torch

from . import _build

_VMEM_BUDGET = 10 * 1024 * 1024
# bf16 x/dy/dx + f32 staging of x, dy, xhat, g (~26 B/elem), x2 double-buffer
_BYTES_PER_ELEM = 56
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's grid: at most 8 blocks a SM (csrc/layernorm.cu), whose
# partials it adds in groups of 16 blocks
_BLOCKS_PER_SM, _GROUP = 8, 16
# (device index, stream) -> the kernel's zeroed counters (it leaves them
# zero)
_counters = {}


def ln_bwd_ok(rows, d):
    return rows % 8 == 0 and d % 128 == 0 and _block_rows(rows, d) > 0


def _block_rows(r, d):
    fit = _VMEM_BUDGET // max(1, d * _BYTES_PER_ELEM)
    if fit < 8:
        return 0   # even the minimum 8-row block would overflow VMEM
    b = min(r, fit)
    b = 1 << (b.bit_length() - 1)
    while b >= 8 and r % b:
        b //= 2
    return b if b >= 8 and r % b == 0 else 0


def ln_backward_plain(x, dy, gamma, eps):
    """Plain version of the kernel, with its formula. x, dy [rows, d];
    gamma [d]. Returns (dx in x's dtype, dgamma f32 [d], dbeta f32 [d])."""
    xf, dyf = x.float(), dy.float()
    inv_d = 1.0 / x.shape[1]
    mean = xf.sum(dim=1, keepdim=True) * inv_d
    cx = xf - mean
    var = (cx * cx).sum(dim=1, keepdim=True) * inv_d
    rstd = torch.rsqrt(var + eps)
    xhat = cx * rstd
    g = dyf * gamma.float()
    s1 = g.sum(dim=1, keepdim=True)
    s2 = (g * xhat).sum(dim=1, keepdim=True)
    dx = rstd * (g - (s1 + xhat * s2) * inv_d)
    return dx.to(x.dtype), (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


def _check(x, dy, gamma):
    name = "ln_backward"
    if not (x.is_cuda and dy.device == x.device and gamma.device == x.device):
        raise ValueError("%s: x, dy, gamma must be on one CUDA device" % name)
    if x.dtype not in _DTYPE_CODE or dy.dtype != x.dtype or \
            gamma.dtype != torch.float32:
        raise TypeError("%s: x and dy must both be float32 or bfloat16 and "
                        "gamma float32; got %s/%s/%s" % (
                            name, x.dtype, dy.dtype, gamma.dtype))
    if x.ndim != 2 or dy.shape != x.shape or \
            tuple(gamma.shape) != (x.shape[1],) or \
            not ln_bwd_ok(x.shape[0], x.shape[1]):
        raise ValueError("%s: the kernel takes x, dy [rows, d] with rows %% "
                         "8 == 0, d %% 128 == 0 and a block the gate admits, "
                         "and gamma [d]; got %s, %s, %s" % (
                             name, tuple(x.shape), tuple(dy.shape),
                             tuple(gamma.shape)))
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, dy, gamma)):
        raise ValueError("%s: tensors must be contiguous and 16-byte aligned"
                         % name)


def ln_backward(x, dy, gamma, eps):
    """LayerNorm backward over [rows, d] from x (the statistics are
    recomputed), dy and gamma f32 [d]; eps is the forward's epsilon.
    Returns (dx [rows, d] in x's dtype, dgamma f32 [d], dbeta f32 [d]): the
    CUDA kernel for CUDA tensors (or raises), the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return ln_backward_plain(x, dy, gamma, eps)
    _check(x, dy, gamma)
    rows, d = x.shape
    dev = x.device
    index = dev.index
    max_blocks = _BLOCKS_PER_SM * \
        torch.cuda.get_device_properties(index).multi_processor_count
    groups = -(-max_blocks // _GROUP)
    # counters per stream: launches on one stream are ordered, so they
    # never share them at once
    key = (index, torch.cuda.current_stream(index).cuda_stream)
    counters = _counters.get(key)
    if counters is None:
        counters = _counters[key] = torch.zeros(groups + 1, dtype=torch.int32,
                                                device=dev)
    dx = torch.empty_like(x)
    out = torch.empty((2, d), dtype=torch.float32, device=dev)
    part = torch.empty((max_blocks + groups, 2, d), dtype=torch.float32,
                       device=dev)
    _build.launch(ln_backward, "layernorm", "ln_backward", dev, x, dy, gamma,
                  dx, out[0], out[1], part, part[max_blocks:], counters, rows,
                  d, float(eps), max_blocks, _DTYPE_CODE[x.dtype])
    return dx, out[0], out[1]


ln_backward.launches = 0
