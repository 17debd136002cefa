"""Tensor creation / shape / indexing lowerings (the port's counterpart of
``paddle_tpu/fluid/ops/tensor_ops.py``). Random ops draw from the run's
``torch.Generator`` (ctx.next_rng) instead of stateless JAX keys.

Ops that move or pick values (reshapes, pads, crops, gather, split,
stack, argsort, ...) give the JAX lowerings' values bit for bit, out of
range indices included. The row sums of gather's gradient and of
scatter's adds go through ``scatter_rows_``: in batch order, the same bits
in every run, on the card as on the CPU."""
import math

import numpy as np
import torch
import torch.nn.functional as F

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


@register_lowering("fill_zeros_like", no_grad=True)
def _fill_zeros_like(ctx, inputs, attrs):
    return {"Out": [torch.zeros_like(one(inputs, "X"))]}


def _batch_size_like(attrs, ref):
    """attrs' shape with its output_dim_idx axis taken from the
    input_dim_idx axis of ``ref``."""
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    return shape


@register_lowering("fill_constant_batch_size_like", no_grad=True)
def _fill_constant_batch_size_like(ctx, inputs, attrs):
    shape = _batch_size_like(attrs, one(inputs, "Input"))
    return _fill_constant(ctx, inputs, dict(attrs, shape=shape))


def _host_values(vals, shape, dtype, device):
    """A numpy array reshaped to ``shape`` as a tensor of ``dtype`` on
    ``device`` (``jnp.asarray(vals.reshape(shape), dtype)``)."""
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(vals).reshape(shape)))
    return t.to(device=device, dtype=to_torch_dtype(dtype))


@register_lowering("fill", no_grad=True)
def _fill(ctx, inputs, attrs):
    """attrs' value list in attrs' shape and dtype (rounded from the
    list's float64 once, as ``np.asarray(value, dtype)``)."""
    return {"Out": [_host_values(np.asarray(attrs["value"], np.float64),
                                 attrs["shape"],
                                 attrs.get("dtype", "float32"), ctx.device)]}


@register_lowering("assign_value", no_grad=True)
def _assign_value(ctx, inputs, attrs):
    """A constant from the op's attrs: ``fp32_values`` if it has any, else
    ``int32_values``, else ``values`` (the float64 list that
    NumpyArrayInitializer and ``assign`` of an array write)."""
    if len(attrs.get("fp32_values", [])):
        vals = np.asarray(attrs["fp32_values"], dtype=np.float32)
    elif len(attrs.get("int32_values", [])):
        vals = np.asarray(attrs["int32_values"], dtype=np.int32)
    else:
        vals = np.asarray(attrs["values"])
    return {"Out": [_host_values(vals, attrs["shape"],
                                 attrs.get("dtype", "float32"), ctx.device)]}


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


@register_lowering("uniform_random_batch_size_like", no_grad=True)
def _uniform_random_bsl(ctx, inputs, attrs):
    shape = _batch_size_like(attrs, one(inputs, "Input"))
    return _uniform_random(ctx, inputs, dict(attrs, shape=shape))


@register_lowering("gaussian_random_batch_size_like", no_grad=True)
def _gaussian_random_bsl(ctx, inputs, attrs):
    shape = _batch_size_like(attrs, one(inputs, "Input"))
    return _gaussian_random(ctx, inputs, dict(attrs, shape=shape))


@register_lowering("truncated_gaussian_random", no_grad=True)
def _truncated_gaussian_random(ctx, inputs, attrs):
    """mean + std * z, z a standard normal truncated to [-2, 2] and not
    rescaled (its variance is 0.7737), as ``jax.random.truncated_normal``
    draws it."""
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    return _random(ctx, attrs, lambda t, g: torch.nn.init.trunc_normal_(
        t, 0.0, 1.0, -2.0, 2.0, generator=g).mul_(std).add_(mean))


@register_lowering("range", no_grad=True)
def _range(ctx, inputs, attrs):
    """``jnp.arange`` of the three [1] inputs' values (float32): the
    length depends on the values, so they are read on the host."""
    start, end, step = (float(one(inputs, s)) for s in ("Start", "End",
                                                         "Step"))
    return {"Out": [_arange(start, end, step, "float32", ctx.device)]}


@register_lowering("range_static", no_grad=True)
def _range_static(ctx, inputs, attrs):
    return {"Out": [_arange(attrs["start"], attrs["end"], attrs["step"],
                            attrs.get("dtype", "float32"), ctx.device)]}


def _arange(start, end, step, dtype, device):
    """``jnp.arange(start, end, step).astype(dtype)`` for float bounds:
    numpy's float32 arange (the same length and bits), then the cast."""
    vals = np.arange(start, end, step, dtype=np.float32)
    return torch.from_numpy(vals).to(device=device,
                                     dtype=to_torch_dtype(dtype))


@register_lowering("sampling_id", no_grad=True)
def _sampling_id(ctx, inputs, attrs):
    """One int64 id a row of X's probabilities, a categorical over
    log(x + 1e-20) drawn as ``jax.random.categorical`` draws it: the
    argmax of the logits plus Gumbel noise -log(-log(u)), u uniform on
    [tiny, 1) in float32. The layer's min, max and dtype play no part."""
    x = one(inputs, "X")
    logits = torch.log(x.float() + 1e-20)
    u = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    gen = ctx.next_rng(attrs.get("seed", 0))
    if gen is not None:
        u.uniform_(torch.finfo(torch.float32).tiny, 1.0, generator=gen)
    return {"Out": [torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)]}


@register_lowering("random_crop", no_grad=True)
def _random_crop(ctx, inputs, attrs):
    """X's trailing axes cut to attrs' shape at a random offset: one
    window for the whole batch, as the JAX lowering draws it (Fluid's op
    draws one an instance). SeedOut is int64 zeros [1]."""
    x = one(inputs, "X")
    shape = attrs["shape"]
    gen = ctx.next_rng(attrs.get("seed", 0))
    lead = x.ndim - len(shape)
    out = x
    for i, size in enumerate(shape):
        start = torch.zeros((1,), dtype=torch.int64, device=x.device)
        if gen is not None:
            start = torch.randint(0, x.shape[lead + i] - size + 1, (1,),
                                  generator=gen, device=x.device)
        idx = start + torch.arange(size, device=x.device)
        out = torch.index_select(out, lead + i, idx)
    return {"Out": [out],
            "SeedOut": [torch.zeros((1,), dtype=torch.int64,
                                    device=ctx.device)]}


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


def _squeeze_shape(x, axes):
    if not axes:
        return tuple(d for d in x.shape if d != 1)
    axes = [a % x.ndim for a in axes]
    return tuple(d for i, d in enumerate(x.shape) if i not in axes or d != 1)


def _unsqueeze_shape(x, axes):
    shape = list(x.shape)
    for a in sorted(axes):
        shape.insert(a if a >= 0 else a + len(shape) + 1, 1)
    return tuple(shape)


def _flatten(x, attrs):
    ax = attrs.get("axis", 1)
    return x.reshape(math.prod(x.shape[:ax]), -1)


# each reshape op and the function of (X, attrs) that gives its Out; the
# "2" ops also write XShape
_RESHAPES = {
    "reshape": lambda x, a: _do_reshape(x, a["shape"]),
    "transpose": lambda x, a: x.permute(*a["axis"]),
    "flatten": _flatten,
    "squeeze": lambda x, a: x.reshape(_squeeze_shape(x, a.get("axes", []))),
    "unsqueeze": lambda x, a: x.reshape(_unsqueeze_shape(x, a["axes"])),
}


def _register_reshape(op_type, fn):
    @register_lowering(op_type)
    def lowering(ctx, inputs, attrs):
        return {"Out": [fn(one(inputs, "X"), attrs)]}

    @register_lowering(op_type + "2")
    def lowering2(ctx, inputs, attrs):
        x = one(inputs, "X")
        return {"Out": [fn(x, attrs)], "XShape": [_xshape(x)]}


for _op_type, _fn in _RESHAPES.items():
    _register_reshape(_op_type, _fn)


@register_lowering("concat")
def _concat(ctx, inputs, attrs):
    return {"Out": [torch.cat(list(inputs.get("X") or []),
                              dim=attrs.get("axis", 0))]}


@register_lowering("split")
def _split(ctx, inputs, attrs):
    """At the cumulative ``sections``, or into ``num`` equal parts (an
    axis ``num`` does not divide raises, as ``jnp.split`` does)."""
    x = one(inputs, "X")
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        return {"Out": list(torch.tensor_split(
            x, np.cumsum(sections)[:-1].tolist(), dim=axis))}
    num = attrs.get("num", 0)
    if x.shape[axis] % num:
        raise ValueError("split: axis %d of size %d does not split into %d "
                         "equal parts" % (axis, x.shape[axis], num))
    return {"Out": list(torch.split(x, x.shape[axis] // num, dim=axis))}


@register_lowering("stack")
def _stack(ctx, inputs, attrs):
    return {"Y": [torch.stack(list(inputs["X"]), dim=attrs.get("axis", 0))]}


@register_lowering("unstack")
def _unstack(ctx, inputs, attrs):
    return {"Y": list(torch.unbind(one(inputs, "X"),
                                   dim=attrs.get("axis", 0)))}


@register_lowering("expand")
def _expand(ctx, inputs, attrs):
    """``jnp.tile``: X repeated expand_times along each axis (fewer times
    than axes repeat the last axes)."""
    x = one(inputs, "X")
    times = list(attrs["expand_times"])
    return {"Out": [x.repeat(*([1] * (x.ndim - len(times)) + times))]}


@register_lowering("reverse")
def _reverse(ctx, inputs, attrs):
    """X flipped along each listed axis in turn (an axis listed twice
    flips back)."""
    x = one(inputs, "X")
    axes = [a % x.ndim for a in attrs["axis"]]
    odd = [a for a in sorted(set(axes)) if axes.count(a) % 2]
    return {"Out": [torch.flip(x, odd) if odd else x]}


# ---------- pads, crops and channel moves ----------

def _pad_constant(x, pads, value):
    """X padded by [(before, after)] an axis with ``value`` in X's dtype."""
    flat = [p for before_after in reversed(pads) for p in before_after]
    return F.pad(x, flat, value=value)


@register_lowering("pad")
def _pad(ctx, inputs, attrs):
    x = one(inputs, "X")
    p = attrs["paddings"]
    return {"Out": [_pad_constant(x, [(p[2 * i], p[2 * i + 1])
                                      for i in range(x.ndim)],
                                  attrs.get("pad_value", 0.0))]}


def _pad_by_index(x, dim, before, after, mode):
    """X padded along ``dim`` in numpy's "reflect" or "edge" mode, as
    ``jnp.pad`` pads: the source of each padded position is numpy's pad of
    the positions, so a pad as wide as the axis or wider reflects again.
    The positions are taken as gather takes rows, so the gradient adds a
    source's copies in order, the same bits every run."""
    if not before and not after:
        return x
    src = np.pad(np.arange(x.shape[dim]), (before, after), mode=mode)
    src = torch.from_numpy(src).to(x.device)
    return _Gather.apply(x.movedim(dim, 0), src).movedim(0, dim)


@register_lowering("pad2d")
def _pad2d(ctx, inputs, attrs):
    """The two spatial axes (NCHW or NHWC) padded [top, bottom, left,
    right]: constant (pad_value), reflect or edge."""
    x = one(inputs, "X")
    p = attrs["paddings"]
    mode = attrs.get("mode", "constant")
    h = 1 if attrs.get("data_format", "NCHW") == "NHWC" else 2
    if mode == "constant":
        pads = [(0, 0)] * x.ndim
        pads[h], pads[h + 1] = (p[0], p[1]), (p[2], p[3])
        return {"Out": [_pad_constant(x, pads, attrs.get("pad_value", 0.0))]}
    mode = "reflect" if mode == "reflect" else "edge"
    out = _pad_by_index(x, h, p[0], p[1], mode)
    return {"Out": [_pad_by_index(out, h + 1, p[2], p[3], mode)]}


@register_lowering("pad_constant_like")
def _pad_constant_like(ctx, inputs, attrs):
    """Y padded at the end of each axis up to X's shape."""
    x, y = one(inputs, "X"), one(inputs, "Y")
    pads = [(0, xd - yd) for xd, yd in zip(x.shape, y.shape)]
    return {"Out": [_pad_constant(y, pads, attrs.get("pad_value", 0.0))]}


@register_lowering("crop")
def _crop(ctx, inputs, attrs):
    x = one(inputs, "X")
    idx = tuple(slice(o, o + s) for o, s in zip(attrs.get("offsets"),
                                                attrs.get("shape")))
    return {"Out": [x[idx]]}


@register_lowering("sequence_mask", no_grad=True)
def _sequence_mask(ctx, inputs, attrs):
    """lengths [N] or [N, 1] -> [N, maxlen] of out_dtype, 1 before each
    length. maxlen is required, as in the JAX package."""
    x = one(inputs, "X")
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise NotImplementedError(
            "sequence_mask needs a static maxlen under XLA; pass maxlen")
    dtype = to_torch_dtype(attrs.get("out_dtype", "int64"))
    mask = torch.arange(maxlen, device=x.device)[None, :] < \
        x.reshape(-1)[:, None]
    return {"Y": [mask.to(dtype)]}


@register_lowering("shape", no_grad=True)
def _shape(ctx, inputs, attrs):
    return {"Out": [torch.tensor(list(one(inputs, "Input").shape),
                                 dtype=torch.int32, device=ctx.device)]}


@register_lowering("space_to_depth")
def _space_to_depth(ctx, inputs, attrs):
    x = one(inputs, "X")  # NCHW
    b = attrs["blocksize"]
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // b, b, w // b, b)
    return {"Out": [out.permute(0, 3, 5, 1, 2, 4).reshape(
        n, c * b * b, h // b, w // b)]}


@register_lowering("shuffle_channel")
def _shuffle_channel(ctx, inputs, attrs):
    x = one(inputs, "X")
    g = attrs["group"]
    n, c, h, w = x.shape
    return {"Out": [x.reshape(n, g, c // g, h, w).transpose(1, 2)
                    .reshape(n, c, h, w)]}


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
    out = take_rows(w, flat)
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
    are cast to dst's dtype. Rows add in their order, one after another
    (a half-precision dst in float32, rounded once at the end, as the
    CPU's ``index_add_`` adds it). ``index_add_`` on the CPU;
    ``add_rows_in_order_`` on the card, where ``index_add_`` adds with
    atomics in an order that changes from run to run."""
    if dst.is_cuda:
        return add_rows_in_order_(dst, rows, vals)
    return dst.index_add_(0, *_row_adds(dst, rows, vals))


def _row_adds(dst, rows, vals):
    """(rows, vals) of scatter_rows_'s adds: the rows wrapped and clamped
    into dst, a dropped row's values zeros, the values in dst's dtype."""
    n = dst.shape[0]
    rows = wrap_ids(rows.reshape(-1).long(), n)
    valid = (rows >= 0) & (rows < n)
    vals = torch.where(valid.reshape((-1,) + (1,) * (vals.ndim - 1)),
                       vals.to(dst.dtype),
                       torch.zeros((), dtype=dst.dtype, device=dst.device))
    return rows.clamp(0, n - 1), vals


# index_put_(accumulate=True) on the card sorts the ids stably and, in rows
# wider than a warp, adds each run of equal ids into the destination one
# value after another, reading and rounding it at every add: no atomics, so
# the same bits in every run, in the CPU's order. Narrower rows take kernels
# that sum a run before adding it once (a warp reduction, for one-column
# rows), so they are padded to IN_ORDER_MIN_WIDTH columns. The CPU's
# index_add_ adds a half-precision table in float32 and rounds once, and so
# does this route. One warp walks a run through memory, about a microsecond
# an add: an id repeated 16,489 times takes about 12 ms on an H100.
IN_ORDER_MIN_WIDTH = 64


def add_rows_in_order_(dst, rows, vals):
    """scatter_rows_'s adds on the card: in batch order, the same bits in
    every run, and the CPU's index_add_'s values (on CPU tensors too, run
    on one thread: the CPU's index_put_ splits the ids among threads)."""
    rows, vals = _row_adds(dst, rows, vals)
    flat = dst.view(dst.shape[0], -1)
    vals = vals.reshape(vals.shape[0], -1)
    width = flat.shape[1]
    acc_dtype = torch.float32 if dst.element_size() < 4 else dst.dtype
    if width >= IN_ORDER_MIN_WIDTH and acc_dtype == dst.dtype:
        flat.index_put_((rows,), vals, accumulate=True)
        return dst
    cols = max(width, IN_ORDER_MIN_WIDTH)
    acc = flat.new_zeros((flat.shape[0], cols), dtype=acc_dtype)
    acc[:, :width] = flat
    wide = vals.new_zeros((vals.shape[0], cols), dtype=acc_dtype)
    wide[:, :width] = vals
    acc.index_put_((rows,), wide, accumulate=True)
    flat.copy_(acc[:, :width])
    return dst


@register_lowering("selected_rows_densify", no_grad=True)
def _selected_rows_densify(ctx, inputs, attrs):
    """(values, rows) sparse-grad pair -> the dense gradient of the table
    ``Ref``: the values summed into zeros of its shape and dtype."""
    ref = one(inputs, "Ref")
    return {"Out": [scatter_rows_(torch.zeros_like(ref),
                                  one(inputs, "Rows"), one(inputs, "X"))]}


def take_rows(x, ids, fill=None):
    """``jnp.take(x, ids, axis=0)`` in its default fill mode: a negative id
    wraps once by +len(x), and an id still out of range reads ``fill``
    (default: NaN, or the dtype's least value for integers, as JAX fills;
    the clamp before the read also keeps a bad feed from tripping a
    device-side assert). ids: a flat int64 tensor."""
    n = x.shape[0]
    wrapped = wrap_ids(ids, n)
    valid = (wrapped >= 0) & (wrapped < n)
    out = torch.index_select(x, 0, wrapped.clamp(0, n - 1))
    if fill is None:
        fill = float("nan") if x.is_floating_point() else \
            torch.iinfo(x.dtype).min
    return out.masked_fill(~valid.reshape((-1,) + (1,) * (x.ndim - 1)),
                           fill)


class _Gather(torch.autograd.Function):
    """take_rows whose gradient sums the output rows into X's rows through
    scatter_rows_ (in batch order, the same bits every run), not through
    index_select's autograd, which adds with atomics on the card."""

    @staticmethod
    def forward(fctx, x, ids):
        fctx.save_for_backward(ids)
        fctx.x_shape = x.shape
        return take_rows(x, ids)

    @staticmethod
    def backward(fctx, g):
        ids, = fctx.saved_tensors
        return scatter_rows_(g.new_zeros(fctx.x_shape), ids, g), None


@register_lowering("gather")
def _gather(ctx, inputs, attrs):
    x, idx = one(inputs, "X"), one(inputs, "Index")
    return {"Out": [_Gather.apply(x, idx.reshape(-1).long())]}


class _ScatterAdd(torch.autograd.Function):
    """``x.at[ids].add(updates)`` through scatter_rows_ (a negative id wraps
    once, an id still out of range is dropped). The gradient: X's is the
    output's, the updates' the output's rows at their ids (0 for a dropped
    id)."""

    @staticmethod
    def forward(fctx, x, ids, upd):
        fctx.save_for_backward(ids)
        fctx.upd_dtype = upd.dtype
        return scatter_rows_(x.clone(), ids, upd)

    @staticmethod
    def backward(fctx, g):
        ids, = fctx.saved_tensors
        return g, None, take_rows(g, ids, fill=0).to(fctx.upd_dtype)


def _scatter_set(x, ids, upd):
    """``x.at[ids].set(updates)``: a negative id wraps once, an id still
    out of range is dropped, and of repeated ids the last update lands, as
    XLA's scatter keeps it on the CPU; its gradient reaches only the
    update that landed, as JAX's scatter JVP gives it. Each update that
    does not land is written to a spare row past the end, which is cut
    off: every kept row is written once, so the card and the CPU keep the
    same update and no host sync picks them."""
    n = x.shape[0]
    rows = wrap_ids(ids, n)
    key = torch.where((rows >= 0) & (rows < n), rows, n)
    order = torch.sort(key, stable=True).indices
    ranked = key[order]
    last = torch.ones_like(ranked, dtype=torch.bool)
    last[:-1] = ranked[1:] != ranked[:-1]
    lands = torch.empty_like(last).index_put_((order,), last) & (key < n)
    target = torch.where(lands, key, n)
    spare = x.new_zeros((1,) + tuple(x.shape[1:]))
    padded = torch.cat([x, spare])
    return padded.index_copy(0, target, upd.to(x.dtype))[:n]


@register_lowering("scatter")
def _scatter(ctx, inputs, attrs):
    x, ids, upd = one(inputs, "X"), one(inputs, "Ids"), one(inputs, "Updates")
    ids = ids.reshape(-1).long()
    if attrs.get("overwrite", True):
        return {"Out": [_scatter_set(x, ids, upd)]}
    return {"Out": [_ScatterAdd.apply(x, ids, upd)]}


@register_lowering("multiplex")
def _multiplex(ctx, inputs, attrs):
    """Row i of Out is row i of X[Ids[i]], as ``xs[ids, arange(n)]``
    indexes in JAX: an id wraps once by +len(X) if negative and is then
    clamped into range; the row of an id still out of range after the wrap
    passes no gradient (XLA's scatter drops it)."""
    xs = list(inputs["X"])
    ids = one(inputs, "Ids").reshape((-1,) + (1,) * (xs[0].ndim - 1))
    rows = wrap_ids(ids.long(), len(xs))
    pick = rows.clamp(0, len(xs) - 1)
    out = xs[-1]
    for k in range(len(xs) - 2, -1, -1):
        out = torch.where(pick == k, xs[k], out)
    in_range = (rows >= 0) & (rows < len(xs))
    return {"Out": [torch.where(in_range, out, out.detach())]}


@register_lowering("arg_max", no_grad=True)
def _arg_max(ctx, inputs, attrs):
    """int64 index of the largest value (the first of ties; a NaN counts as
    the largest, the first NaN wins), as ``jnp.argmax``."""
    return {"Out": [torch.argmax(one(inputs, "X"),
                                 dim=attrs.get("axis", -1))]}


@register_lowering("arg_min", no_grad=True)
def _arg_min(ctx, inputs, attrs):
    """int64 index of the least value (the first of ties; the first NaN
    wins), as ``jnp.argmin``."""
    return {"Out": [torch.argmin(one(inputs, "X"),
                                 dim=attrs.get("axis", -1))]}


@register_lowering("argsort", no_grad=True)
def _argsort(ctx, inputs, attrs):
    """Sorted values and their int64 indices, ascending and stable (equal
    values, -0.0 and 0.0 among them, keep their order; NaNs go last), as
    ``jnp.sort`` / ``jnp.argsort``."""
    x, axis = one(inputs, "X"), attrs.get("axis", -1)
    idx = common.argsort(x, axis)
    return {"Out": [torch.gather(x, axis, idx)], "Indices": [idx]}


@register_lowering("isinf", no_grad=True)
def _isinf(ctx, inputs, attrs):
    """bool [1]: does X hold an infinity?"""
    return {"Out": [torch.isinf(one(inputs, "X")).any().reshape(1)]}


@register_lowering("isnan", no_grad=True)
def _isnan(ctx, inputs, attrs):
    """bool [1]: does X hold a NaN?"""
    return {"Out": [torch.isnan(one(inputs, "X")).any().reshape(1)]}


# Both packages hand these ops what the executor holds under a sparse
# gradient's name: lookup_table_grad's [n, dim] values, one row an id as
# looked up (the ids beside them in @ROWS), so each is the identity.
@register_lowering("get_tensor_from_selected_rows")
def _get_tensor_from_selected_rows(ctx, inputs, attrs):
    return {"Out": [one(inputs, "X")]}


@register_lowering("merge_selected_rows")
def _merge_selected_rows(ctx, inputs, attrs):
    return {"Out": [one(inputs, "X")]}


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
    indices, largest first, in ``jax.lax.top_k``'s order (``common.top_k``:
    equal values lower index first, -0.0 below +0.0, NaN above inf and -NaN
    below -inf)."""
    vals, idx = common.top_k(one(inputs, "X"), attrs["k"])
    return {"Out": [vals], "Indices": [idx]}
