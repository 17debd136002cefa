"""Dense embedding gradient (``lookup_table_grad``): the two CUDA kernels for
Hopper, their plain PyTorch versions, and the JAX package's admission rule.

Counterpart of ``paddle_tpu/ops/emb_grad_kernel.py``; the kernels
(``csrc/emb_grad.cu``, one template) replace the Pallas ``_scatter_kernel``
(paddle_tpu/ops/emb_grad_kernel.py:96) and ``_segsum_kernel`` (:147),
chosen by ``FLAGS_emb_grad_kernel``, with their accumulation semantics:

- "scatter": each id's dout row added in the TABLE dtype, one rounding per
  add (as ``zeros.at[ids].add(dout.astype(w.dtype))``), in id order.
- "segsum": each row's dout rows summed in f32 in id order, rounded once.

On the card each block keeps the accumulator of its rows in shared memory,
filters the ids for them in order and writes dW whole: one launch a call,
no sort, no atomics, no memset. Both kernels equal their plain versions bit
for bit.

dout is cast to the table dtype first, as in the JAX package. An id outside
[0, vocab) contributes nothing (the lowering wraps negative ids before
either route). ``emb_grad_ok``, ``_pow2_chunk``, ``_sublane`` and
``_segsum_tile`` are the JAX package's, verbatim: the scatter's gate still
depends on the real table dtype.
"""
import torch

from . import _build

_VMEM_BUDGET = 11 * 1024 * 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _pow2_chunk(n, cap=512):
    """Largest power-of-two chunk <= cap that divides n (0 if none >= 8)."""
    c = 1 << (min(n, cap).bit_length() - 1)
    while c >= 8 and n % c:
        c //= 2
    return c if c >= 8 and n % c == 0 else 0


def _sublane(dtype):
    return 16 if dtype.itemsize == 2 else 8


def _segsum_tile(vocab, dim, dtype):
    """Vocab-tile height for the segsum variant: a multiple of the dtype
    sublane that divides vocab, with the f32 accumulator + dW/dout blocks
    inside the VMEM budget."""
    sub = _sublane(dtype)
    per_row = dim * (4 + 2 * dtype.itemsize)   # acc + 2x dW buf
    fit = max(1, (_VMEM_BUDGET // 2) // per_row)
    tv = min(vocab, 1 << (fit.bit_length() - 1))
    while tv >= sub and vocab % tv:
        tv //= 2
    return tv if tv >= sub and vocab % tv == 0 else 0


def emb_grad_ok(w_shape, n_ids, impl, dtype=torch.bfloat16):
    """Can `impl` ("scatter" | "segsum") handle a [vocab, dim] table of
    `dtype` with n_ids updates? Lane-aligned dim, sublane-aligned vocab, a
    power-of-two chunk dividing n_ids, and the variant's VMEM bound (which
    depends on the REAL table dtype — an f32 dW is twice the bf16 one)."""
    if len(w_shape) != 2 or n_ids <= 0:
        return False
    vocab, dim = int(w_shape[0]), int(w_shape[1])
    if dim % 128 or _pow2_chunk(n_ids) == 0:
        return False
    if impl == "scatter":
        # whole dW resident in VMEM + one streamed dout chunk
        itemsize = dtype.itemsize
        return vocab % _sublane(dtype) == 0 and \
            vocab * dim * itemsize + _pow2_chunk(n_ids) * dim * 8 \
            <= _VMEM_BUDGET
    if impl == "segsum":
        return _segsum_tile(vocab, dim, dtype) > 0
    return False


def _segments(flat_ids, vocab):
    """(stable argsort of the ids, starts [vocab + 1]: the first sorted
    position with id >= r). Ids outside [0, vocab) fall outside every
    row's run."""
    ids = flat_ids.long()
    order = torch.argsort(ids, stable=True)
    starts = torch.searchsorted(
        ids[order], torch.arange(vocab + 1, dtype=torch.int64,
                                 device=ids.device))
    return order, starts


def _sum_runs(w, flat_ids, dflat, acc_dtype):
    """Each row's dout rows (cast to the table dtype), in id order (a stable
    sort's), summed one add at a time in acc_dtype (the k-th terms of every
    row added together, k = 0, 1, ...); the sum in the table dtype."""
    vocab = w.shape[0]
    order, starts = _segments(flat_ids, vocab)
    sdout = dflat.to(w.dtype)[order]
    counts = starts[1:] - starts[:-1]
    acc = torch.zeros(w.shape, dtype=acc_dtype, device=w.device)
    for k in range(int(counts.max()) if vocab else 0):
        rows = torch.nonzero(counts > k)[:, 0]
        acc[rows] += sdout[starts[rows] + k].to(acc_dtype)
    return acc.to(w.dtype)


def emb_grad_scatter_plain(w, flat_ids, dflat):
    """Plain version of the scatter kernel: each id's dout row added in the
    table dtype, rounded after every add, in id order."""
    return _sum_runs(w, flat_ids, dflat, w.dtype)


def emb_grad_segsum_plain(w, flat_ids, dflat):
    """Plain version of the segsum kernel: each row's dout rows summed in
    f32 in id order, rounded once to the table dtype."""
    return _sum_runs(w, flat_ids, dflat, torch.float32)


def _check(name, w, ids, dflat, impl):
    if not (w.is_cuda and ids.device == w.device and
            dflat.device == w.device):
        raise ValueError("%s: w, ids and dout must be on one CUDA device"
                         % name)
    if w.dtype not in _DTYPE_CODE or ids.dtype != torch.int64:
        raise TypeError("%s: the table must be float32 or bfloat16 and the "
                        "ids int64; got %s/%s" % (name, w.dtype, ids.dtype))
    n = ids.shape[0] if ids.ndim == 1 else -1
    if w.ndim != 2 or n < 0 or tuple(dflat.shape) != (n, w.shape[1]) or \
            not emb_grad_ok(w.shape, n, impl, dtype=w.dtype):
        raise ValueError("%s: the kernel takes a [vocab, dim] table the gate "
                         "admits, [n] ids and [n, dim] dout; got %s, %s, %s"
                         % (name, tuple(w.shape), tuple(ids.shape),
                            tuple(dflat.shape)))
    if n >= 2 ** 31 or w.numel() >= 2 ** 31:
        raise ValueError("%s: at most 2^31 - 1 ids and table elements" % name)


def _aligned(t):
    """t contiguous and 16-byte aligned (the kernels' 16-byte copies)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(wrapper, entry, w, flat_ids, dflat):
    vocab, dim = w.shape
    dw = torch.empty_like(w, memory_format=torch.contiguous_format)
    _build.launch(wrapper, "emb_grad", entry, w.device, _aligned(flat_ids),
                  _aligned(dflat.to(w.dtype)), dw, flat_ids.shape[0], vocab,
                  dim, _DTYPE_CODE[w.dtype])
    return dw


def emb_grad_scatter(w, flat_ids, dflat):
    """Dense embedding grad by adds in the table dtype: w [vocab, dim]
    (dtype and shape source only), flat_ids [n] int64, dflat [n, dim] ->
    dW [vocab, dim] in w.dtype. The CUDA kernel for CUDA tensors (or
    raises), the plain version for CPU tensors."""
    if w.device.type == "cpu":
        return emb_grad_scatter_plain(w, flat_ids, dflat)
    _check("emb_grad_scatter", w, flat_ids, dflat, "scatter")
    return _launch(emb_grad_scatter, "emb_grad_scatter", w, flat_ids, dflat)


emb_grad_scatter.launches = 0


def emb_grad_segsum(w, flat_ids, dflat):
    """Dense embedding grad by per-row f32 sums, rounded once; same
    signature and result shape as emb_grad_scatter."""
    if w.device.type == "cpu":
        return emb_grad_segsum_plain(w, flat_ids, dflat)
    _check("emb_grad_segsum", w, flat_ids, dflat, "segsum")
    return _launch(emb_grad_segsum, "emb_grad_segsum", w, flat_ids, dflat)


emb_grad_segsum.launches = 0


def emb_grad(w, flat_ids, dflat, impl):
    """Dispatch by FLAGS_emb_grad_kernel value ("scatter" | "segsum")."""
    if impl == "scatter":
        return emb_grad_scatter(w, flat_ids, dflat)
    if impl == "segsum":
        return emb_grad_segsum(w, flat_ids, dflat)
    raise ValueError("unknown FLAGS_emb_grad_kernel=%r "
                     "(use 'scatter' or 'segsum')" % (impl,))
