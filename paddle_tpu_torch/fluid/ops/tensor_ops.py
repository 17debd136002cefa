"""Tensor creation / shape / indexing lowerings (the port's counterpart of
``paddle_tpu/fluid/ops/tensor_ops.py``). Random ops draw from the run's
``torch.Generator`` (ctx.next_rng) instead of stateless JAX keys."""
import math

import torch

from .. import sparse_grads
from ..core_types import to_torch_dtype
from . import common
from .registry import register_lowering, register_grad_maker
from .common import one


# ---------- creation ----------

@register_lowering("fill_constant", no_grad=True)
def _fill_constant(ctx, inputs, attrs):
    shape = tuple(attrs.get("shape", ()))
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(shape, attrs.get("value", 0.0), dtype=dtype,
                               device=ctx.device)]}


def _random(ctx, attrs, fill):
    """f32 draw of attrs' shape from the op's generator, then cast to the
    target dtype (as the JAX lowering draws f32 and casts)."""
    shape = tuple(attrs["shape"])
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    gen = ctx.next_rng(attrs.get("seed", 0))
    if gen is not None:
        fill(out, gen)
    return {"Out": [out.to(dtype)]}


@register_lowering("uniform_random", no_grad=True)
def _uniform_random(ctx, inputs, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    return _random(ctx, attrs, lambda t, g: t.uniform_(lo, hi, generator=g))


@register_lowering("gaussian_random", no_grad=True)
def _gaussian_random(ctx, inputs, attrs):
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    return _random(ctx, attrs,
                   lambda t, g: t.normal_(mean, std, generator=g))


@register_lowering("assign")
def _assign(ctx, inputs, attrs):
    return {"Out": [one(inputs, "X")]}


@register_lowering("cast")
def _cast(ctx, inputs, attrs):
    return {"Out": [one(inputs, "X").to(to_torch_dtype(attrs["out_dtype"]))]}


# ---------- shape manipulation ----------

def _do_reshape(x, shape):
    shape = [int(s) for s in shape]
    # fluid: 0 means "copy this dim from input"
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape[:x.ndim])] + \
            [s for s in shape[x.ndim:]]
    return x.reshape(shape)


def _xshape(x):
    """The XShape output: a zero-size tensor carrying x's shape."""
    return torch.empty((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


@register_lowering("reshape2")
def _reshape2(ctx, inputs, attrs):
    x = one(inputs, "X")
    return {"Out": [_do_reshape(x, attrs["shape"])], "XShape": [_xshape(x)]}


@register_lowering("transpose2")
def _transpose2(ctx, inputs, attrs):
    x = one(inputs, "X")
    return {"Out": [x.permute(*attrs["axis"])], "XShape": [_xshape(x)]}


@register_lowering("flatten2")
def _flatten2(ctx, inputs, attrs):
    x = one(inputs, "X")
    ax = attrs.get("axis", 1)
    lead = math.prod(x.shape[:ax])
    return {"Out": [x.reshape(lead, -1)], "XShape": [_xshape(x)]}


@register_lowering("concat")
def _concat(ctx, inputs, attrs):
    return {"Out": [torch.cat(list(inputs.get("X") or []),
                              dim=attrs.get("axis", 0))]}


@register_lowering("slice")
def _slice(ctx, inputs, attrs):
    """Python slicing per axis; a negative start or end counts from the end
    of the axis and both clamp to [0, dim], as the JAX lowering clamps
    them. The gradient (grad_of) is zero outside the slice."""
    x = one(inputs, "Input")
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    return {"Out": [x[tuple(idx)]]}


def wrap_ids(flat, vocab):
    """Ids as ``jnp.take`` and ``.at[].add`` index: a negative id wraps once
    by +vocab. An id still outside [0, vocab) stays out of range."""
    return torch.where(flat < 0, flat + vocab, flat)


@register_lowering("lookup_table")
def _lookup_table(ctx, inputs, attrs):
    w, ids = one(inputs, "W"), one(inputs, "Ids")
    padding_idx = attrs.get("padding_idx", -1)
    flat = ids.reshape(-1).long()
    vocab = w.shape[0]
    # jnp.take's default fill mode: a negative id wraps once by +vocab, and
    # an id still outside [0, vocab) reads NaN. The clamp also keeps a bad
    # feed from tripping a device-side assert.
    wrapped = wrap_ids(flat, vocab)
    valid = (wrapped >= 0) & (wrapped < vocab)
    out = torch.index_select(w, 0, wrapped.clamp(0, vocab - 1))
    out = out.masked_fill(~valid[:, None], float("nan"))
    if padding_idx is not None and padding_idx != -1:
        pad = (padding_idx + vocab) if padding_idx < 0 else padding_idx
        out = out.masked_fill((flat == pad)[:, None], 0)
    out_shape = tuple(ids.shape[:-1]) + (w.shape[1],) \
        if ids.shape and ids.shape[-1] == 1 else tuple(ids.shape) + (w.shape[1],)
    return {"Out": [out.reshape(out_shape)]}


@register_grad_maker("lookup_table")
def _lookup_table_grad_maker(op, block, no_grad_set):
    """The embedding grad. Dense: a scatter-add of the output grads into a
    [vocab, dim] table. Sparse (is_sparse=True, and this lookup the table's
    only reader): the JAX package's SelectedRows analog, a pair of
    ``W@GRAD`` (the [n, dim] values) and ``W@GRAD@ROWS`` (the [n] ids), never
    a [vocab, dim] tensor. A table with another reader takes the dense grad:
    backward's sum op needs every contribution dense."""
    w_name = op.input("W")[0]
    uses = sum(1 for o in block.ops if w_name in o.input_arg_names)
    sparse = bool(op.attrs.get("is_sparse")) and uses == 1
    outputs = {"W@GRAD": [w_name + "@GRAD"]}
    attrs = dict(op.attrs)
    attrs["is_sparse"] = sparse
    if sparse:
        rows_name = w_name + "@GRAD" + sparse_grads.ROWS_SUFFIX
        outputs["W@GRAD@ROWS"] = [rows_name]
        if not block._has_var_recursive(rows_name):
            block.create_var(name=rows_name, shape=[-1], dtype="int64")
    grad_op = {
        "type": "lookup_table_grad",
        "inputs": {"W": op.input("W"), "Ids": op.input("Ids"),
                   "Out@GRAD": [op.output("Out")[0] + "@GRAD"]},
        "outputs": outputs,
        "attrs": attrs,
    }
    return [grad_op], {w_name + "@GRAD": w_name}


@register_lowering("lookup_table_grad")
def _lookup_table_grad(ctx, inputs, attrs):
    """Sparse: the (values, ids) pair, the values in the table dtype, the
    ids as looked up. Dense: dW = zeros.index_add_(ids, dout) in the table
    dtype, as ``zeros.at[ids].add`` in the JAX lowering: a negative id wraps
    once by +vocab, and an id still outside [0, vocab) contributes nothing
    (its forward row read NaN). FLAGS_emb_grad_kernel routes the sum to a
    CUDA kernel (ops/emb_grad_kernel.py) where the gate admits the table;
    the kernels skip out-of-range ids, so both routes give the same dW."""
    from ...ops import emb_grad_kernel as eg
    from .. import flags
    w, ids = one(inputs, "W"), one(inputs, "Ids")
    dout = one(inputs, "Out@GRAD")
    vocab = w.shape[0]
    ids = ids.reshape(-1).long()
    if dout.ndim < 2:
        lead = tuple(one(inputs, "Ids").shape)
        lead = lead[:-1] if lead and lead[-1] == 1 else lead
        dout = torch.broadcast_to(dout, lead + (w.shape[1],))
    dflat = dout.reshape(ids.shape[0], w.shape[1]).to(w.dtype)
    if attrs.get("is_sparse"):
        return {"W@GRAD": [dflat], "W@GRAD@ROWS": [ids]}
    flat = wrap_ids(ids, vocab)
    impl = flags.get("emb_grad_kernel")
    if impl and common.on_card(w) and \
            eg.emb_grad_ok(w.shape, flat.shape[0], impl, dtype=w.dtype):
        return {"W@GRAD": [eg.emb_grad(w, flat, dflat, impl)]}
    if flags.get("emb_grad_sorted"):
        # the JAX lowering's presorted scatter (indices_are_sorted=True)
        order = torch.argsort(flat, stable=True)
        ids, dflat = ids[order], dflat[order]
    return {"W@GRAD": [scatter_rows_(torch.zeros_like(w), ids, dflat)]}


def scatter_rows_(dst, rows, vals):
    """``dst.at[rows].add(vals)`` as the JAX package scatters a row
    gradient, in place on dst, which it returns: a negative row wraps once
    by +len(dst), a row still outside [0, len(dst)) is dropped, and vals
    are cast to dst's dtype. Rows add in their order."""
    n = dst.shape[0]
    rows = wrap_ids(rows.reshape(-1).long(), n)
    valid = (rows >= 0) & (rows < n)
    vals = torch.where(valid[:, None], vals.to(dst.dtype),
                       torch.zeros((), dtype=dst.dtype, device=dst.device))
    return dst.index_add_(0, rows.clamp(0, n - 1), vals)


@register_lowering("selected_rows_densify", no_grad=True)
def _selected_rows_densify(ctx, inputs, attrs):
    """(values, rows) sparse-grad pair -> the dense gradient of the table
    ``Ref``: the values summed into zeros of its shape and dtype."""
    ref = one(inputs, "Ref")
    return {"Out": [scatter_rows_(torch.zeros_like(ref),
                                  one(inputs, "Rows"), one(inputs, "X"))]}


@register_lowering("one_hot", no_grad=True)
def _one_hot(ctx, inputs, attrs):
    """float32 [..., depth]; a trailing size-1 axis of the ids is squeezed,
    and an id outside [0, depth) gives a row of zeros (``jax.nn.one_hot``)."""
    x = one(inputs, "X")
    flat = x.reshape(x.shape[:-1]) if x.ndim and x.shape[-1] == 1 else x
    depth = torch.arange(attrs["depth"], device=x.device)
    return {"Out": [(flat.long()[..., None] == depth).float()]}


@register_lowering("causal_mask", no_grad=True)
def _causal_mask(ctx, inputs, attrs):
    """Additive causal attention bias [1, 1, T, T]: 0 on/below diagonal,
    -1e9 above (decoder self-attention)."""
    t = attrs["seq_len"]
    dtype = to_torch_dtype(attrs.get("dtype", "float32"))
    mask = torch.triu(torch.full((t, t), -1e9, dtype=torch.float32,
                                 device=ctx.device), diagonal=1)
    return {"Out": [mask[None, None, :, :].to(dtype)]}


@register_lowering("add_position_encoding")
def _add_position_encoding(ctx, inputs, attrs):
    # sinusoidal position encoding added to a batched [B, T, D] input
    # (reference: operators/add_position_encoding_op.h)
    x = one(inputs, "X")
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    b, t, d = x.shape
    half = d // 2
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    div = torch.pow(10000.0, torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half)
    enc = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], dim=1)
    return {"Out": [alpha * x + beta * enc[None, :, :].to(x.dtype)]}


@register_lowering("label_smooth")
def _label_smooth(ctx, inputs, attrs):
    """(1 - epsilon) * X + epsilon / K over X's last axis of K classes, or
    + epsilon * PriorDist where a prior is given."""
    x = one(inputs, "X")
    eps = attrs.get("epsilon", 0.0)
    dist = one(inputs, "PriorDist")
    if dist is not None:
        return {"Out": [(1.0 - eps) * x + eps * dist]}
    return {"Out": [(1.0 - eps) * x + eps / x.shape[-1]]}


# ---------- top-k ----------

@register_lowering("top_k", no_grad=True)
def _top_k(ctx, inputs, attrs):
    """The k largest values of each row of X's last axis and their int64
    indices, largest first. Equal values come out lower index first, as
    ``jax.lax.top_k`` orders them: a stable descending sort, where
    ``torch.topk`` promises no order among ties."""
    x = one(inputs, "X")
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    k = attrs["k"]
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}
