"""Shared helpers for op lowerings."""
import torch


def one(inputs, slot, idx=0):
    """Fetch the idx-th tensor bound to an input slot, or None if absent."""
    lst = inputs.get(slot)
    if not lst:
        return None
    return lst[idx]


def many(inputs, slot):
    """Every value bound to an input slot (a list, empty if absent)."""
    return list(inputs.get(slot) or [])


def on_card(x):
    """The port's ``_use_pallas()`` for the flag-gated kernels (CE,
    LayerNorm backward, embedding grad): the tensor lies on a CUDA card."""
    return x.is_cuda


def compute_dtype(x):
    """float32 for a half-precision x (such a lowering computes in float32
    and rounds its result once), else x's dtype."""
    return torch.float32 if x.element_size() < 4 else x.dtype


def round_scalar(value, dtype):
    """A Python scalar rounded to ``dtype``: the JAX lowerings build
    ``jnp.asarray(attr, x.dtype)`` before multiplying, so a bf16 tensor is
    scaled by the bf16-rounded attr."""
    return torch.tensor(value, dtype=dtype).item()


def jnp_abs(x):
    """|x| with ``jnp.abs``'s gradient: 1 at 0, where ``torch.abs`` gives
    0."""
    return torch.where(x >= 0, x, -x)


def true_div(a, b):
    """a / b for a Python number b, rounded as IEEE division on every
    device: PyTorch's CUDA kernels multiply by a scalar divisor's
    reciprocal, which can land an ulp off (7 / 3 then times 3 is
    7.0000005, and a bin edge's ceil 8 where the CPU's and XLA's give
    7; a quantized value on a .5 boundary then rounds to its
    neighbour)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def align_rank(x, y, axis):
    """Fluid elementwise broadcast: y's dims align to x starting at ``axis``
    (reference: operators/elementwise/elementwise_op_function.h trim-and-expand
    semantics). axis=-1 -> trailing alignment (numpy rule)."""
    if x.ndim == y.ndim:
        return y
    if axis is None or axis == -1:
        return y
    if y.ndim > x.ndim:
        raise ValueError("elementwise with axis=%d: Y rank > X rank" % axis)
    shape = [1] * x.ndim
    for i, d in enumerate(y.shape):
        shape[axis + i] = d
    return y.reshape(shape)


def flatten_to_2d(x, num_col_dims):
    """Collapse dims [0,num_col_dims) and [num_col_dims,ndim) (mul-op semantics,
    reference: operators/mul_op.cc x_num_col_dims)."""
    lead = 1
    for d in x.shape[:num_col_dims]:
        lead *= d
    tail = 1
    for d in x.shape[num_col_dims:]:
        tail *= d
    return x.reshape(lead, tail)


# ---------- ranking: the one place that decides the order of ties ----------

_SAME_WIDTH_INT = {torch.float32: torch.int32, torch.float64: torch.int64,
                   torch.bfloat16: torch.int16, torch.float16: torch.int16}


def total_order_key(x):
    """Integers that sort as ``jax.lax.top_k`` orders floats: the total
    order -NaN < -inf < ... < -0.0 < +0.0 < ... < inf < NaN (torch's sort
    takes -0.0 and +0.0 as equal and puts every NaN last). Integer tensors
    are their own keys."""
    if not x.is_floating_point():
        return x
    bits = x.view(_SAME_WIDTH_INT[x.dtype])
    return torch.where(bits < 0, bits ^ torch.iinfo(bits.dtype).max, bits)


def top_k(x, k):
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    int64 indices in its total order (``total_order_key``), equal values
    lower index first (``torch.topk`` promises no order among ties)."""
    idx = torch.sort(total_order_key(x), dim=-1, descending=True,
                     stable=True)[1][..., :k]
    return torch.gather(x, -1, idx), idx


def argsort(x, dim=-1):
    """``jnp.argsort``: ascending and stable, -0.0 equal to +0.0 and every
    NaN last, as torch's stable sort orders them (``torch.argsort`` is
    unstable by default)."""
    return torch.sort(x, dim=dim, stable=True)[1]
