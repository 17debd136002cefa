"""Softmax cross-entropy over flat [tokens, V] logits: the CUDA kernels for
Hopper (forward: loss and lse; backward: dlogits in the logits dtype), their
plain PyTorch versions, and the JAX package's admission rule.

Counterpart of ``paddle_tpu/ops/ce_kernel.py``; the kernels
(``csrc/ce.cu``) replace the Pallas ``_fwd_kernel``
(paddle_tpu/ops/ce_kernel.py:60) and ``_bwd_kernel`` (:72), with their
rounding points:

    forward:  m = max l (f32); lse = m + log(sum exp(l - m)) (f32);
              loss = lse - l[label], 0 where label == ignore, < 0 or >= V
    backward: dlogits = (exp(l - lse) - onehot(label)) * dloss in f32, 0 on
              masked rows, rounded once to the logits dtype

Neither writes an f32 [tokens, V] tensor. ``ce_ok``, ``_fit_block``,
``_pick_block`` and the row-byte rules are the JAX package's, verbatim, so
the same shapes take the kernels: the TPU's VMEM budget is not the card's
limit, but the rule decides which programs do. Labels are int64, as the
port feeds them.
"""
import torch

from . import _build

DEFAULT_BLOCK_T = 128
DEFAULT_BLOCK_T_BWD = 64
_VMEM_BUDGET = 12 * 1024 * 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _pick_block(t, block):
    b = min(block, t)
    while t % b:
        b //= 2
    return b


def _row_bytes_fwd(v, itemsize):
    return v * (itemsize + 8)          # logits tile + ~2 f32 temporaries


def _row_bytes_bwd(v, itemsize):
    return v * (2 * itemsize + 8)      # + dlogits out tile


def _fit_block(t, v, itemsize, row_bytes, start):
    """Largest power-of-two divisor of t (>= 8) whose tile fits VMEM; 0 if
    none does."""
    b = _pick_block(t, start)
    while b >= 8 and b * row_bytes(v, itemsize) > _VMEM_BUDGET:
        b //= 2
    return b if b >= 8 and t % b == 0 else 0


def ce_ok(t, v, itemsize):
    """Gate on flat [tokens, V] shapes: non-empty, lane-aligned V, and a
    viable VMEM block for BOTH passes (the backward tile is the bigger
    one — large-vocab models that can't fit stay on the XLA path)."""
    return (t > 0 and t % 8 == 0 and v % 128 == 0
            and _fit_block(t, v, itemsize, _row_bytes_bwd,
                           DEFAULT_BLOCK_T_BWD) > 0)


def _masked(label, v, ignore):
    return (label == ignore) | (label < 0) | (label >= v)


def ce_forward_plain(logits, label, ignore=-100):
    """Plain version of the forward kernel. logits [t, V], label [t] int.
    Returns (loss [t] f32, lse [t] f32)."""
    lf = logits.float()
    v = lf.shape[-1]
    m = lf.amax(dim=-1, keepdim=True)
    lse = m + torch.log(torch.exp(lf - m).sum(dim=-1, keepdim=True))
    lab = label.reshape(-1).long()
    picked = torch.gather(lf, -1, lab.clamp(0, v - 1)[:, None])
    loss = torch.where(_masked(lab, v, ignore)[:, None],
                       torch.zeros_like(lse), lse - picked)
    return loss[:, 0], lse[:, 0]


def ce_backward_plain(logits, label, lse, dloss, ignore=-100):
    """Plain version of the backward kernel. lse, dloss [t]. Returns
    dlogits [t, V] in the logits dtype."""
    lf = logits.float()
    v = lf.shape[-1]
    lab = label.reshape(-1).long()
    g = torch.where(_masked(lab, v, ignore), torch.zeros_like(dloss.float()),
                    dloss.float())
    onehot = torch.arange(v, device=lf.device) == lab[:, None]
    dl = (torch.exp(lf - lse.float()[:, None]) - onehot.float()) * g[:, None]
    return dl.to(logits.dtype)


def _check(name, logits, label, rows=()):
    dev = logits.device
    if not (logits.is_cuda and label.device == dev and
            all(r.device == dev for r in rows)):
        raise ValueError("%s: logits, label and the row vectors must be on "
                         "one CUDA device" % name)
    if logits.dtype not in _DTYPE_CODE or label.dtype != torch.int64 or \
            any(r.dtype != torch.float32 for r in rows):
        raise TypeError("%s: logits must be float32 or bfloat16, label "
                        "int64 and the row vectors float32; got %s/%s" % (
                            name, logits.dtype, label.dtype))
    if logits.ndim != 2 or not ce_ok(logits.shape[0], logits.shape[1],
                                     logits.element_size()):
        raise ValueError("%s: the kernel takes [t, V] logits with t %% 8 == "
                         "0, V %% 128 == 0 and a tile the gate admits; got "
                         "%s" % (name, tuple(logits.shape)))
    t = logits.shape[0]
    if tuple(label.shape) != (t,) or any(tuple(r.shape) != (t,)
                                         for r in rows):
        raise ValueError("%s: label and the row vectors must be [%d]"
                         % (name, t))
    if not all(x.is_contiguous() for x in (logits, label) + tuple(rows)) \
            or logits.data_ptr() % 16:
        raise ValueError("%s: tensors must be contiguous, logits 16-byte "
                         "aligned" % name)


def ce_forward(logits, label, ignore=-100):
    """Cross-entropy forward on [t, V] logits and [t] int64 labels ->
    (loss [t] f32, lse [t] f32). The CUDA kernel for CUDA tensors (or
    raises), the plain version for CPU tensors."""
    if logits.device.type == "cpu":
        return ce_forward_plain(logits, label, ignore)
    _check("ce_forward", logits, label)
    t, v = logits.shape
    loss = torch.empty(t, dtype=torch.float32, device=logits.device)
    lse = torch.empty(t, dtype=torch.float32, device=logits.device)
    _build.launch(ce_forward, "ce", "ce_forward", logits.device, logits,
                  label, loss, lse, t, v, int(ignore),
                  _DTYPE_CODE[logits.dtype])
    return loss, lse


ce_forward.launches = 0


def ce_backward(logits, label, lse, dloss, ignore=-100):
    """Cross-entropy backward -> dlogits [t, V] in the logits dtype, from
    the forward's lse [t] and the loss gradient dloss [t] (f32). The CUDA
    kernel for CUDA tensors (or raises), the plain version for CPU
    tensors."""
    if logits.device.type == "cpu":
        return ce_backward_plain(logits, label, lse, dloss, ignore)
    _check("ce_backward", logits, label, (lse, dloss))
    t, v = logits.shape
    dlogits = torch.empty_like(logits)
    _build.launch(ce_backward, "ce", "ce_backward", logits.device, logits,
                  label, lse, dloss, dlogits, t, v, int(ignore),
                  _DTYPE_CODE[logits.dtype])
    return dlogits


ce_backward.launches = 0
