"""Tensor arrays and the LoD plumbing ops.

The port's counterpart of ``paddle_tpu/fluid/ops/array_ops.py``: its 9
lowerings (``lod_array_length``, ``lod_rank_table``, ``max_sequence_len``,
``shrink_rnn_memory``, ``reorder_lod_tensor_by_rank``,
``split_lod_tensor``, ``merge_lod_tensor``, ``lod_reset``,
``rnn_memory_helper``) and its 5 env lowerings (``write_to_array``,
``read_from_array``, ``lod_tensor_to_array``, ``array_to_lod_tensor``,
``tensor_array_to_tensor``), with the same padded-dense layout: a ragged
batch is a padded [B, T, ...] tensor and a length vector [B]; a
LOD_TENSOR_ARRAY is a Python list of tensors; a LOD_RANK_TABLE holds the
lengths and the descending-length order. Where the reference shrinks the
batch as sequences end, rows are masked instead, and a split keeps every
row, the other side's rows zeroed. Every op here is a gather or a select,
so the card gives the CPU's bits.

An array index must be a constant of the program (fill_constant /
increment chains, folded by ``registry.fold_const``), as in the JAX
package, so an array inside a While raises; loops over time steps use the
``recurrent`` op (StaticRNN, DynamicRNN).
"""
import collections

import numpy as np
import torch

from .registry import register_lowering, register_env_lowering
from .common import one

RankTable = collections.namedtuple("RankTable", ["lengths", "order"])


def _const_index(ctx, name, op_type):
    v = ctx.const_env.get(name)
    if v is not None:
        return int(np.asarray(v).reshape(-1)[0])
    raise NotImplementedError(
        "%s: array index %r is not a trace-time constant (it depends on loop "
        "state or feeds). Static-shape TPU programs index tensor arrays with "
        "fill_constant/increment chains; for loops over time steps use "
        "StaticRNN/DynamicRNN (one lax.scan)." % (op_type, name))


@register_env_lowering("write_to_array")
def _write_to_array(ctx, env, op):
    x = env[op.input("X")[0]]
    idx = _const_index(ctx, op.input("I")[0], "write_to_array")
    name = op.output("Out")[0]
    arr = env.get(name)
    arr = [] if not isinstance(arr, list) else list(arr)
    if idx >= len(arr):
        arr.extend([None] * (idx + 1 - len(arr)))
    arr[idx] = x
    env[name] = arr


@register_env_lowering("read_from_array")
def _read_from_array(ctx, env, op):
    arr = env[op.input("X")[0]]
    idx = _const_index(ctx, op.input("I")[0], "read_from_array")
    if not isinstance(arr, list) or idx >= len(arr) or arr[idx] is None:
        raise IndexError("read_from_array: index %d not written" % idx)
    env[op.output("Out")[0]] = arr[idx]


@register_lowering("lod_array_length", no_grad=True)
def _lod_array_length(ctx, inputs, attrs):
    arr = one(inputs, "X")
    n = len(arr) if isinstance(arr, list) else 0
    return {"Out": [torch.tensor(n, dtype=torch.int32, device=ctx.device)]}


@register_lowering("lod_rank_table", no_grad=True)
def _lod_rank_table(ctx, inputs, attrs):
    """The descending-length order (reference lod_rank_table_op.cc) of a
    padded [B, T, ...] batch and its Length [B]; without lengths every row
    is full length. Ties keep their rows' order."""
    x = one(inputs, "X")
    length = one(inputs, "Length")
    if length is None:
        b, t = x.shape[0], (x.shape[1] if x.ndim > 1 else 1)
        length = torch.full((b,), t, dtype=torch.int32, device=x.device)
    length = length.reshape(-1).to(torch.int32)
    order = torch.argsort(-length, stable=True).to(torch.int32)
    return {"Out": [RankTable(lengths=length, order=order)]}


@register_lowering("max_sequence_len", no_grad=True)
def _max_sequence_len(ctx, inputs, attrs):
    rt = one(inputs, "RankTable")
    return {"Out": [rt.lengths.max().to(torch.int64)]}


def _take_rows(x, order):
    return torch.index_select(x, 0, order.long())


@register_env_lowering("lod_tensor_to_array")
def _lod_tensor_to_array(ctx, env, op):
    """Padded [B, T, ...] to a time-major list of [B, ...] steps, the rows
    in the rank table's order (the reference emits shrinking batches; B
    stays and finished rows are masked)."""
    x = env[op.input("X")[0]]
    rt = env[op.input("RankTable")[0]]
    xs = _take_rows(x, rt.order)
    env[op.output("Out")[0]] = [xs[:, t] for t in range(x.shape[1])]


@register_env_lowering("array_to_lod_tensor")
def _array_to_lod_tensor(ctx, env, op):
    """The steps stacked back to [B, T, ...], the rank table's order
    undone."""
    arr = env[op.input("X")[0]]
    rt = env[op.input("RankTable")[0]]
    x = torch.stack([a for a in arr if a is not None], dim=1)
    inv = torch.argsort(rt.order)
    env[op.output("Out")[0]] = _take_rows(x, inv)


@register_lowering("shrink_rnn_memory")
def _shrink_rnn_memory(ctx, inputs, attrs):
    """The reference drops the sequences that ended by step I from the
    batch; here their rows (in the rank table's order) are zeroed."""
    x = one(inputs, "X")
    rt = one(inputs, "RankTable")
    step = one(inputs, "I").reshape(-1)[0].to(torch.int32)
    alive = rt.lengths[rt.order.long()] > step
    mask = alive.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
    return {"Out": [x * mask]}


@register_lowering("reorder_lod_tensor_by_rank")
def _reorder_lod_tensor_by_rank(ctx, inputs, attrs):
    return {"Out": [_take_rows(one(inputs, "X"), one(inputs,
                                                     "RankTable").order)]}


def _row_mask(mask, ref):
    mask = mask.reshape(-1).to(torch.bool)
    return mask.reshape((-1,) + (1,) * (ref.dim() - 1))


@register_lowering("split_lod_tensor")
def _split_lod_tensor(ctx, inputs, attrs):
    """The reference routes rows into two smaller tensors by Mask; here
    both outputs keep [B, ...] with the other side's rows zeroed."""
    x = one(inputs, "X")
    mexp = _row_mask(one(inputs, "Mask"), x)
    zero = torch.zeros_like(x)
    return {"OutTrue": [torch.where(mexp, x, zero)],
            "OutFalse": [torch.where(mexp, zero, x)]}


@register_lowering("merge_lod_tensor")
def _merge_lod_tensor(ctx, inputs, attrs):
    in_true = one(inputs, "InTrue")
    in_false = one(inputs, "InFalse")
    ref = in_true if in_true is not None else in_false
    mexp = _row_mask(one(inputs, "Mask"), ref)
    if in_true is None:
        in_true = torch.zeros_like(in_false)
    if in_false is None:
        in_false = torch.zeros_like(in_true)
    return {"Out": [torch.where(mexp, in_true, in_false)]}


@register_env_lowering("tensor_array_to_tensor")
def _tensor_array_to_tensor(ctx, env, op):
    arr = env[op.input("X")[0]]
    steps = [a for a in arr if a is not None]
    axis = op.attr("axis", 0) or 0
    if op.attr("use_stack", False):
        out = torch.stack(steps, dim=axis)
    else:
        out = torch.cat(steps, dim=axis)
    env[op.output("Out")[0]] = out
    outs_index = op.output("OutIndex")
    if outs_index:
        env[outs_index[0]] = torch.tensor(
            [s.shape[axis] for s in steps], dtype=torch.int32,
            device=out.device)


@register_lowering("lod_reset", no_grad=False)
def _lod_reset(ctx, inputs, attrs):
    """The reference replaces a tensor's LoD; the data passes through and
    the new lengths come from Y (a length vector) or the target_lod
    offsets."""
    x = one(inputs, "X")
    y = one(inputs, "Y")
    outs = {"Out": [x]}
    if y is not None:
        outs["OutLength"] = [y.reshape(-1).to(torch.int32)]
    else:
        tl = attrs.get("target_lod")
        if tl:
            offs = np.asarray(tl, np.int64)
            outs["OutLength"] = [torch.as_tensor(
                np.diff(offs).astype(np.int32), device=x.device)]
    return outs


@register_lowering("rnn_memory_helper")
def _rnn_memory_helper(ctx, inputs, attrs):
    # the identity on a recurrent memory (rnn_memory_helper_op.cc)
    return {"Out": [one(inputs, "X")]}
