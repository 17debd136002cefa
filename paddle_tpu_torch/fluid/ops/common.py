"""Shared helpers for op lowerings."""
import torch


def one(inputs, slot, idx=0):
    """Fetch the idx-th tensor bound to an input slot, or None if absent."""
    lst = inputs.get(slot)
    if not lst:
        return None
    return lst[idx]


def round_scalar(value, dtype):
    """A Python scalar rounded to ``dtype``: the JAX lowerings build
    ``jnp.asarray(attr, x.dtype)`` before multiplying, so a bf16 tensor is
    scaled by the bf16-rounded attr."""
    return torch.tensor(value, dtype=dtype).item()


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
