"""The remaining parity lowerings: the port's counterpart of
``paddle_tpu/fluid/ops/parity_ops.py``, all 11 of its lowerings with their
no-grad flags: chunk and pair metrics, channel-wise quantization and
requantize, hashing, the id-sharding plumbing and buffer coalescing
(reference: chunk_eval_op.{cc,h}, positive_negative_pair_op.{cc,h},
fake_quantize_op.cc's channel-wise variants, requantize_op.cc,
hash_op.cc, split_selected_rows_op.cc, split_byref_op.cc,
alloc_continuous_space_op.cc, ref_by_trainer_id_op.cc,
lookup_sparse_table_op.cc).

- chunk_eval marks each position's chunk begin and end over the whole
  [B, T] batch at once, and runs the JAX lowering's matching recurrence
  over T (a ``lax.scan`` there) in closed form: the match open after step
  t is ``a`` at the last step s <= t where it was reset or cut (``a_s |
  ~b_s``), found by a running maximum of step indices. A few launches a
  request whatever T, and no host read.
- hash computes the JAX lowering's uint32 arithmetic in int64, each
  product split into 16-bit halves and every result masked to 32 bits
  (PyTorch's uint32 has no CUDA multiply), so that its buckets equal the
  JAX package's exactly.
- The channel-wise quantize divides by a tensor on x's device before it
  rounds (``quantize_ops``: a CUDA kernel divides by a Python number
  through its reciprocal).

Differences from the Paddle reference that the JAX lowerings have and the
port keeps (ROADMAP Queue 3): hash mixes with a Knuth multiplier and a
position salt, not xxHash; lookup_sparse_table clips an id past the table
to its last row and grows no row; chunk_eval's layer passes no Length, so
a padded tail is scored as tags.
"""
import numpy as np
import torch

from .registry import register_lowering, get_lowering
from .common import jnp_abs, many, one

# tag layouts per chunk scheme (chunk_eval_op.h GetSegments):
# label id = chunk_type * num_tag_types + tag; "other" = num_types*num_tags
_SCHEMES = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}
_MASK32 = 0xFFFFFFFF


def _shift(x, fill, step):
    """x [B, T] moved `step` (+1: from the previous position, -1: from the
    next) along T, `fill` where nothing moves in."""
    pad = torch.full_like(x[:, :1], fill)
    if step > 0:
        return torch.cat([pad, x[:, :-1]], dim=1)
    return torch.cat([x[:, 1:], pad], dim=1)


def _chunk_marks(tags, types, other, scheme):
    """begin / end masks [B, T] from the tags, the types (-1 where other)
    and the is-other mask (conlleval semantics, as the JAX lowering's
    per-sequence vectors)."""
    inside = ~other
    prev_type, next_type = _shift(types, -1, 1), _shift(types, -1, -1)
    prev_tag, next_tag = _shift(tags, -1, 1), _shift(tags, -1, -1)
    prev_inside = _shift(inside, False, 1)
    next_inside = _shift(inside, False, -1)
    newseg = (~prev_inside) | (prev_type != types)
    segend = (~next_inside) | (next_type != types)
    if scheme == "plain":
        return inside, inside
    if scheme == "IOB":
        return (inside & ((tags == 0) | newseg),
                inside & (segend | (next_tag == 0)))
    if scheme == "IOE":
        return (inside & (newseg | (prev_tag == 1)),
                inside & ((tags == 1) | segend))
    # IOBES: B=0 I=1 E=2 S=3
    return (inside & ((tags == 0) | (tags == 3) | newseg),
            inside & ((tags == 2) | (tags == 3) | segend))


def _marks(seq, valid, ntag, other_id, excluded, scheme):
    """(begins, ends, types with -1 where other) of the label ids [B, T]."""
    other = (seq >= other_id) | (seq < 0) | ~valid
    tags = torch.remainder(seq, ntag)
    types = torch.div(seq, ntag, rounding_mode="floor")
    for e in excluded:
        other = other | (types == e)
    types = torch.where(other, torch.full_like(types, -1), types)
    begin, end = _chunk_marks(tags, types, other, scheme)
    return begin & valid, end & valid, types


def matched_chunks(ib, ie, ity, lb, le, lty):
    """The JAX lowering's scan over T, per row: a match opens where both
    sequences begin a chunk of one type (``both``), stays open while both
    agree on begin, end and type (``same``), counts where both end with it
    open, and closes at either's end. In closed form: after step t the
    match is open iff the last step s <= t that reset it (``a``) or cut it
    (``~b``) reset it. Returns the correct chunks [B, T]."""
    both = ib & lb & (ity == lty) & (ity >= 0)
    same = (ib == lb) & (ie == le) & (ity == lty)
    end = ie | le
    a, b = both & ~end, same & ~end
    t = ib.shape[1]
    steps = torch.arange(t, device=ib.device).expand_as(ib)
    last = torch.cummax(torch.where(a | ~b, steps, torch.full_like(
        steps, -1)), dim=1)[0]
    opened = (last >= 0) & torch.gather(a, 1, last.clamp(min=0))
    before = _shift(opened, False, 1)
    return (both | (before & same)) & ie & le


@register_lowering("chunk_eval", no_grad=True)
def _chunk_eval(ctx, inputs, attrs):
    """Precision, recall and F1 over labeled chunks (chunk_eval_op.h),
    dense [B, T] with an optional Length."""
    inf = one(inputs, "Inference")
    lab = one(inputs, "Label")
    length = one(inputs, "Length")
    if inf.ndim == 3:
        inf, lab = inf[..., 0], lab[..., 0]
    if inf.shape != lab.shape:
        # the JAX lowering squeezes Label only with Inference, and its
        # vmap then refuses the two shapes
        raise ValueError("chunk_eval: Inference %s and Label %s differ in "
                         "shape" % (tuple(inf.shape), tuple(lab.shape)))
    inf = inf.to(torch.int32)
    lab = lab.to(torch.int32)
    num_types = attrs.get("num_chunk_types", 1)
    scheme = attrs.get("chunk_scheme", "IOB")
    excluded = sorted(set(attrs.get("excluded_chunk_types", []) or []))
    ntag = _SCHEMES[scheme]
    other_id = num_types * ntag
    b, t = inf.shape
    steps = torch.arange(t, device=inf.device)
    if length is None:
        valid = torch.ones((b, t), dtype=torch.bool, device=inf.device)
    else:
        valid = steps[None, :] < length.reshape(-1, 1)
    ib, ie, ity = _marks(inf, valid, ntag, other_id, excluded, scheme)
    lb, le, lty = _marks(lab, valid, ntag, other_id, excluded, scheme)
    correct = matched_chunks(ib, ie, ity, lb, le, lty)
    num_inf = ib.sum().to(torch.float32)
    num_lab = lb.sum().to(torch.float32)
    num_cor = correct.sum().to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=inf.device)
    prec = torch.where(num_inf > 0, num_cor / num_inf, zero)
    rec = torch.where(num_lab > 0, num_cor / num_lab, zero)
    f1 = torch.where(prec + rec > 0, 2 * prec * rec / (prec + rec), zero)
    i64 = torch.int64
    return {"Precision": [prec.reshape(1)], "Recall": [rec.reshape(1)],
            "F1-Score": [f1.reshape(1)],
            "NumInferChunks": [num_inf.to(i64).reshape(1)],
            "NumLabelChunks": [num_lab.to(i64).reshape(1)],
            "NumCorrectChunks": [num_cor.to(i64).reshape(1)]}


@register_lowering("positive_negative_pair", no_grad=True)
def _positive_negative_pair(ctx, inputs, attrs):
    """Ranking pair counts within query groups
    (positive_negative_pair_op.h): an O(B^2) masked pair matrix."""
    score = one(inputs, "Score").reshape(-1)
    label = one(inputs, "Label").reshape(-1)
    qid = one(inputs, "QueryID").reshape(-1)
    same_q = qid[:, None] == qid[None, :]
    upper = torch.ones_like(same_q).triu(diagonal=1)
    pairmask = same_q & upper & (label[:, None] != label[None, :])
    sdiff = score[:, None] - score[None, :]
    ldiff = (label[:, None] - label[None, :]).to(sdiff.dtype)
    f32 = torch.float32
    pos = (pairmask & (sdiff * ldiff > 0)).to(f32).sum()
    neg = (pairmask & (sdiff * ldiff < 0)).to(f32).sum()
    neu = (pairmask & (sdiff == 0)).to(f32).sum()
    accp = one(inputs, "AccumulatePositivePair")
    accn = one(inputs, "AccumulateNegativePair")
    accu = one(inputs, "AccumulateNeutralPair")
    if accp is not None:
        pos = pos + accp.reshape(-1)[0]
        neg = neg + accn.reshape(-1)[0]
        neu = neu + accu.reshape(-1)[0]
    return {"PositivePair": [pos.reshape(1)],
            "NegativePair": [neg.reshape(1)],
            "NeutralPair": [neu.reshape(1)]}


# ------------------------------------------------ channel-wise quantization

@register_lowering("fake_channel_wise_quantize_abs_max")
def _fake_cw_quant(ctx, inputs, attrs):
    x = one(inputs, "X")
    rng = float(2 ** (attrs.get("bit_length", 8) - 1) - 1)
    # jnp.abs's gradient (1 at 0) reaches X through OutScale
    scale = jnp_abs(x).amax(dim=tuple(range(1, x.ndim))) if x.ndim > 1 \
        else jnp_abs(x)
    s = scale.reshape((-1,) + (1,) * (x.ndim - 1))
    out = torch.round(x / torch.clamp(s, min=1e-12) * rng)
    return {"Out": [out], "OutScale": [scale]}


@register_lowering("fake_channel_wise_dequantize_max_abs")
def _fake_cw_dequant(ctx, inputs, attrs):
    x = one(inputs, "X")
    scales = many(inputs, "Scales")
    bits = attrs.get("quant_bits", [8])
    if isinstance(bits, int):
        bits = [bits]
    s0 = scales[0].reshape((-1,) + (1,) * (x.ndim - 1))
    out = x * s0 / float(2 ** (bits[0] - 1) - 1)
    if len(scales) > 1 and scales[1] is not None:
        out = out * scales[1].reshape(-1)[0] / \
            float(2 ** (bits[1] - 1) - 1)
    return {"Out": [out]}


@register_lowering("requantize", no_grad=True)
def _requantize(ctx, inputs, attrs):
    x = one(inputs, "Input")
    s_in = attrs.get("Scale_in", 1.0)
    s_out = attrs.get("Scale_out", 1.0)
    return {"Output": [x.to(torch.float32) * (s_out / s_in)]}


# ------------------------------------------------------- id / shard plumbing

def mul32(a, b):
    """a * b modulo 2**32 for int64 tensors (or Python ints) in
    [0, 2**32), without overflowing int64: the 16-bit halves' products."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    cross = (a_hi * b_lo + a_lo * b_hi) & 0xFFFF
    return (a_lo * b_lo + (cross << 16)) & _MASK32


@register_lowering("hash", no_grad=True)
def _hash(ctx, inputs, attrs):
    """hash_op.cc maps int id rows through num_hash hash functions modulo
    mod_by. The reference uses xxHash; the JAX lowering a Knuth
    multiplicative mixer with a position salt (a plain sum would hash
    [1, 2] as [2, 1]), computed here in int64 modulo 2**32."""
    x = one(inputs, "X")
    num_hash = attrs.get("num_hash", 1)
    mod_by = attrs.get("mod_by", 1)
    flat = x.reshape(x.shape[0], -1).to(torch.int64) & _MASK32
    pos_salt = mul32(torch.arange(flat.shape[1], dtype=torch.int64,
                                  device=x.device) + 1, 0x85EBCA6B)
    outs = []
    for i in range(num_hash):
        mixed = (mul32(flat, 2654435761) +
                 ((0x9E3779B9 * (i + 1)) & _MASK32)) & _MASK32
        mixed = mixed ^ (mixed >> 16)
        mixed = mixed ^ pos_salt[None, :]
        mixed = mul32(mixed, 0xC2B2AE35)
        combined = mixed.sum(dim=1) & _MASK32
        outs.append(torch.remainder(combined, mod_by))
    out = torch.stack(outs, dim=1).reshape(x.shape[0], num_hash, 1)
    return {"Out": [out]}


@register_lowering("split_selected_rows", no_grad=True)
def _split_selected_rows(ctx, inputs, attrs):
    """Dense equivalent: split rows by height_sections
    (split_selected_rows_op.cc)."""
    x = one(inputs, "X")
    outs, start = [], 0
    for s in attrs.get("height_sections", []):
        outs.append(x[start:start + s])
        start += s
    return {"Out": outs}


def _split_like(ctx, inputs, attrs):
    return get_lowering("split")(ctx, inputs, attrs)


register_lowering("split_byref", no_grad=True)(_split_like)


@register_lowering("alloc_continuous_space", no_grad=True)
def _alloc_continuous_space(ctx, inputs, attrs):
    """Coalesce tensors into one flat buffer (alloc_continuous_space_op.cc):
    FusedOutput = the inputs flattened and concatenated; Output the inputs
    themselves (aliased views in the reference), or, with set_constant,
    the constant buffer's pieces in their shapes."""
    xs = many(inputs, "Input")
    if xs:
        fused = torch.cat([x.reshape(-1) for x in xs])
    else:
        fused = torch.zeros((0,), dtype=torch.float32, device=ctx.device)
    if attrs.get("set_constant", False):
        fused = torch.full_like(fused, attrs.get("constant", 0.0))
        outs, off = [], 0
        for x in xs:
            n = int(np.prod(x.shape))
            outs.append(fused[off:off + n].reshape(x.shape))
            off += n
        return {"FusedOutput": [fused], "Output": outs}
    return {"FusedOutput": [fused], "Output": list(xs)}


@register_lowering("ref_by_trainer_id", no_grad=True)
def _ref_by_trainer_id(ctx, inputs, attrs):
    """X[TrainerId] as ``jnp.take`` picks it: a negative id counts from the
    end, and an id outside the list gives take's fill (NaN for floats, the
    most negative value for signed integers)."""
    xs = many(inputs, "X")
    stacked = torch.stack(xs)
    n = stacked.shape[0]
    idx = one(inputs, "TrainerId").reshape(-1)[:1].to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    inside = ((idx >= 0) & (idx < n)).reshape(())
    out = torch.index_select(stacked, 0, idx.clamp(0, n - 1))[0]
    if stacked.is_floating_point():
        fill = float("nan")
    elif stacked.dtype == torch.bool:
        fill = True
    else:
        fill = torch.iinfo(stacked.dtype).min
    return {"Out": [torch.where(inside, out, torch.full_like(out, fill))]}


@register_lowering("lookup_sparse_table", no_grad=True)
def _lookup_sparse_table(ctx, inputs, attrs):
    """Pserver-side sparse-table row fetch (lookup_sparse_table_op.cc), as
    the JAX lowering's gather: an id past the table reads its last row (and
    a negative id its first), where the reference grows the table with
    zero rows."""
    w = one(inputs, "W")
    ids = one(inputs, "Ids").reshape(-1).to(torch.int32).to(torch.int64)
    return {"Out": [w[ids.clamp(0, w.shape[0] - 1)]]}
