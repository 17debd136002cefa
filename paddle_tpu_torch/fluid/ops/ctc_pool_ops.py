"""CTC and index-carrying pooling lowerings: the port's counterpart of
``paddle_tpu/fluid/ops/ctc_pool_ops.py``, all 7 of its lowerings (warpctc,
ctc_align, edit_distance, max_pool2d_with_index, max_pool3d_with_index,
unpool, spp), with the JAX lowerings' semantics (reference:
operators/warpctc_op.cc, ctc_align_op.cc, edit_distance_op.cc,
pool_with_index_op.cc, unpool_op.cc, spp_op.cc).

Every one is plain PyTorch on the op's device, as the JAX lowerings are
plain XLA (no Pallas kernel): no value is read back to the host, so the
CTC recursion and the edit distance cost launches and no sync.

- warpctc is optax's ``ctc_loss`` written out (``ctc_nll``): the
  blank / label ("phi" / "emit") form of the forward recursion in log
  space over T, log(+0) taken as LOG_EPSILON = -1e5, so that a label that
  needs more frames than its row has gives a large finite loss (about
  1e5), where ``F.ctc_loss`` gives inf. Its gradient comes from the
  executor's ``grad_of``, autograd over this forward, as the JAX one comes
  from ``jax.vjp``.
- edit_distance runs the Levenshtein table by anti-diagonals: H + R + 1
  steps, each vectorized over the batch and the diagonal, in float32 (the
  distances are integers, exact).
- The max pools take Out with ``amax`` over each window's elements, whose
  gradient splits evenly among tied maxima, as ``jnp.max``'s does (not
  ``F.max_pool2d``'s, which sends it to one element); Mask is the first
  maximum in row-major window order (``argmax``, as ``jnp.argmax``), a
  flat int32 index into the input's spatial plane. Uniform windows
  (explicit, global, adaptive where every size divides) come from
  ``Tensor.unfold`` over the -inf-padded input; true adaptive bins
  [floor(i S / O), ceil((i + 1) S / O)) and spp's bins from one gather of
  every bin padded to the widest with -inf (0 for spp's average), not a
  loop over bins.
- unpool resolves repeated indices as the JAX lowering does: the last
  source in input order wins (a scatter-max of each source's ordinal, then
  a gather), the same on every run and device.

Differences from the Paddle reference that the JAX lowerings have and the
port keeps (ROADMAP Queue 3): the max pools' and spp's gradients split
among ties (the reference sends each window's to its Mask index);
``norm_by_times`` divides the loss by the frame count (the reference
scales only the gradient); unpool's output size is always
(h - 1) * stride - 2 * pad + ksize (the layer never passes
``output_size``).
"""
import math

import torch
import torch.nn.functional as F

from .registry import register_lowering
from .common import one

# optax.ctc_loss's log(+0)
LOG_EPSILON = -1e5


def _lengths(length, b, full, device):
    """Each row's length as int64 [B] (`full` for every row without it)."""
    if length is None:
        return torch.full((b,), full, dtype=torch.int64, device=device)
    return length.reshape(-1).long()


# ---------------------------------------------------------------- CTC family

def label_repeats(label):
    """[B, L] float32: 1 where label n equals label n + 1 (the last 0)."""
    rep = (label[:, :-1] == label[:, 1:]).float()
    return F.pad(rep, (0, 1))


def _phi_update(phi, added):
    """phi with logaddexp(phi[:, 1:], added) in place of its tail."""
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=1)


def ctc_nll(logits, label, llen, tlen, blank):
    """optax.ctc_loss over logits [B, T, C] and label [B, L]: -log p of
    each row's first tlen labels over its first llen frames, [B], in
    float32 (float64 logits stay float64). ``label_repeats`` bars the skip
    of the blank between equal labels. Labels outside [0, C) emit with
    log-probability 0, as optax's one-hot product gives them."""
    logp = torch.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    b, t, c = logp.shape
    n = label.shape[1]
    lab = label.long()
    inside = (lab >= 0) & (lab < c)
    emit_lp = torch.gather(logp, 2, lab.clamp(0, c - 1)[:, None, :]
                           .expand(b, t, n))
    emit_lp = torch.where(inside[:, None, :], emit_lp, 0.0)
    phi_lp = logp[:, :, blank:blank + 1]
    live = torch.arange(t, device=logp.device)[None, :] < llen[:, None]
    repeat = label_repeats(label)
    skip_barred = LOG_EPSILON * repeat
    blank_barred = LOG_EPSILON * (1.0 - repeat)
    phi = F.pad(torch.full((b, n), LOG_EPSILON, dtype=logp.dtype,
                           device=logp.device), (1, 0))
    emit = torch.full((b, n), LOG_EPSILON, dtype=logp.dtype,
                      device=logp.device)
    for s in range(t):
        lp_e, lp_p = emit_lp[:, s], phi_lp[:, s]
        # emit -> phi, except into a repeated label's blank
        prev_phi = _phi_update(phi, emit + skip_barred)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_e, emit + lp_e)
        # phi's self loop, and emit -> phi on the blank only between equal
        # labels
        next_phi = _phi_update(prev_phi + lp_p, emit + lp_p + blank_barred)
        keep = live[:, s:s + 1]
        emit = torch.where(keep, next_emit, emit)
        phi = torch.where(keep, next_phi, phi)
    last = _phi_update(phi, emit)
    return -torch.gather(last, 1, tlen.clamp(0, n)[:, None])[:, 0]


@register_lowering("warpctc")
def _warpctc(ctx, inputs, attrs):
    """CTC loss. Dense layout: Logits [B, T, C] (+ LogitsLength [B]),
    Label [B, L] (+ LabelLength [B]). Loss [B, 1] (float32 for float32 or
    narrower logits), divided by max(frames, 1) under norm_by_times."""
    logits = one(inputs, "Logits")
    label = one(inputs, "Label")
    b, t = logits.shape[0], logits.shape[1]
    llen = _lengths(one(inputs, "LogitsLength"), b, t, logits.device)
    tlen = _lengths(one(inputs, "LabelLength"), b, label.shape[1],
                    logits.device)
    loss = ctc_nll(logits, label, llen, tlen, attrs.get("blank", 0))
    if attrs.get("norm_by_times", False):
        loss = loss / llen.to(loss.dtype).clamp(min=1.0)
    return {"Loss": [loss.reshape(b, 1)]}


def stable_compact(x, keep):
    """The kept tokens of each row of x [B, T] moved left in order (the
    rest after them, in order), and their count as int32 [B]."""
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    return torch.gather(x, 1, order), keep.sum(dim=1, dtype=torch.int32)


@register_lowering("ctc_align", no_grad=True)
def _ctc_align(ctx, inputs, attrs):
    """Greedy CTC decode: drop blanks and (merge_repeated) repeats. Input
    [B, T] (+ Length); Output [B, T] int32, left-compacted and 0-padded,
    and OutputLength [B] int32, as the JAX lowering returns them."""
    x = one(inputs, "Input")
    b, t = x.shape
    length = _lengths(one(inputs, "Length"), b, t, x.device)
    ar = torch.arange(t, device=x.device)[None, :]
    x = x.int()
    keep = (x != attrs.get("blank", 0)) & (ar < length[:, None])
    if attrs.get("merge_repeated", True):
        # the previous token, blanks included: [1, 0, 1] keeps both 1s
        prev = F.pad(x[:, :-1], (1, 0), value=-1)
        keep = keep & (x != prev)
    compacted, n = stable_compact(x, keep)
    return {"Output": [torch.where(ar < n[:, None], compacted, 0)],
            "OutputLength": [n]}


def levenshtein(hyp, ref, hlen, rlen):
    """The edit distance between each row's first hlen tokens of hyp
    [B, H] and first rlen of ref [B, R], float32 [B]: the table
    D[i][j] (ref prefix i, hyp prefix j) by anti-diagonals d = i + j, each
    diagonal indexed by i, from the two before it; D[rlen][hlen] read from
    the stacked diagonals."""
    b, h = hyp.shape
    r = ref.shape[1]
    dev = hyp.device
    big = math.inf
    nd = r + h + 1
    i = torch.arange(r + 1, device=dev)[None, :]
    j = torch.arange(nd, device=dev)[:, None] - i               # [nd, R+1]
    # substitution costs skewed to [B, nd, R+1]: cell (i, d - i)
    mis = F.pad((ref[:, :, None] != hyp[:, None, :]).float(), (1, 0, 1, 0))
    skew = mis[:, i.expand(nd, r + 1), j.clamp(0, h)]
    # the fixed cells: D[i][0] = i, D[0][j] = j, inf off the table; NaN
    # marks the cells computed from their neighbours
    fixed = torch.where((i == 0) | (j == 0), (i + j).float(), math.nan)
    fixed = torch.where((j < 0) | (j > h), big, fixed)
    free = torch.isnan(fixed)

    def up(v):
        return F.pad(v[:, :-1], (1, 0), value=big)     # v[i - 1]
    prev = torch.full((b, r + 1), big, device=dev)
    up_prev2 = prev
    diags = []
    for d in range(nd):
        up_prev = up(prev)
        cur = torch.minimum(torch.minimum(up_prev2 + skew[:, d],
                                          up_prev + 1.0), prev + 1.0)
        cur = torch.where(free[d], cur, fixed[d])
        diags.append(cur)
        prev, up_prev2 = cur, up_prev
    table = torch.stack(diags, dim=1)
    return table[torch.arange(b, device=dev), hlen + rlen, rlen]


def strip_tokens(x, length, ignored):
    """x [B, T] with the tokens of `ignored` dropped from each row's first
    `length` (stable compaction), and the new lengths (int64)."""
    keep = torch.arange(x.shape[1], device=x.device)[None, :] < \
        length[:, None]
    for tok in ignored:
        keep = keep & (x != int(tok))
    out, n = stable_compact(x, keep)
    return out, n.long()


@register_lowering("edit_distance", no_grad=True)
def _edit_distance(ctx, inputs, attrs):
    """Levenshtein distance between padded Hyps [B, H] and Refs [B, R]
    (+ HypsLength, RefsLength; the widths without them), the tokens of
    ignored_tokens stripped from both first; normalized by max(ref length,
    1). Out [B, 1] float32, SequenceNum the batch size (int64 scalar)."""
    hyp, ref = one(inputs, "Hyps"), one(inputs, "Refs")
    b = hyp.shape[0]
    hlen = _lengths(one(inputs, "HypsLength"), b, hyp.shape[1], hyp.device)
    rlen = _lengths(one(inputs, "RefsLength"), b, ref.shape[1], hyp.device)
    hyp, ref = hyp.int(), ref.int()
    ignored = attrs.get("ignored_tokens", []) or []
    if ignored:
        hyp, hlen = strip_tokens(hyp, hlen, ignored)
        ref, rlen = strip_tokens(ref, rlen, ignored)
    d = levenshtein(hyp, ref, hlen, rlen)
    if attrs.get("normalized", True):
        d = d / rlen.float().clamp(min=1.0)
    return {"Out": [d.reshape(b, 1)],
            "SequenceNum": [torch.full((), b, dtype=torch.int64,
                                       device=hyp.device)]}


# ------------------------------------------------- pooling with index family

def _flat_positions(tables, spatial):
    """Per-dim positions [O_d, K_d] -> flat positions into the spatial
    plane, [*O, K] with the window's offsets row-major."""
    nd = len(tables)
    flat = 0
    for d, t in enumerate(tables):
        shape = [1] * (2 * nd)
        shape[d], shape[nd + d] = t.shape
        flat = flat * spatial[d] + t.reshape(shape)
    return flat.reshape(flat.shape[:nd] + (-1,))


def uniform_windows(x, ksize, strides, pads):
    """x [N, C, *S]'s windows of ksize at strides over the -inf-padded
    input: (values [N, C, *O, K], flat positions [*O, K])."""
    nd = len(ksize)
    padding = [p for q in reversed(pads) for p in (q, q)]
    w = F.pad(x, padding, value=-math.inf) if any(pads) else x
    for d in range(nd):
        w = w.unfold(2 + d, ksize[d], strides[d])
    out = w.shape[2:2 + nd]
    w = w.reshape(w.shape[:2 + nd] + (-1,))
    tables = [torch.arange(o, device=x.device)[:, None] * s - p +
              torch.arange(k, device=x.device)[None, :]
              for o, k, s, p in zip(out, ksize, strides, pads)]
    return w, _flat_positions(tables, x.shape[2:])


def bin_windows(x, edges, fill):
    """x [N, C, *S]'s bins, one gather: edges[d] = (start, end) as int64
    [O_d] tensors and the widest bin K_d; each bin padded to K_d with
    `fill` (an extra element at the end of every dim). (values
    [N, C, *O, K], flat positions [*O, K])."""
    nd = len(edges)
    spatial = x.shape[2:]
    xp = F.pad(x, [0, 1] * nd, value=fill)
    tables, index = [], []
    for d, ((start, end, k), s) in enumerate(zip(edges, spatial)):
        pos = start[:, None] + torch.arange(k, device=x.device)[None, :]
        pos = torch.where(pos < end[:, None], pos, s)
        tables.append(pos)
        shape = [1] * (2 * nd)
        shape[2 * d], shape[2 * d + 1] = pos.shape
        index.append(pos.reshape(shape))
    w = xp[(slice(None), slice(None)) + tuple(index)]
    # [N, C, O0, K0, O1, K1, ...] -> [N, C, O0, O1, ..., K0, K1, ...]
    w = w.permute([0, 1] + [2 + 2 * d for d in range(nd)] +
                  [3 + 2 * d for d in range(nd)])
    w = w.reshape(w.shape[:2 + nd] + (-1,))
    return w, _flat_positions(tables, spatial)


def _edges(s, o, bounds, device):
    """A dim's bins: (start, end) int64 [o] on `device` and the widest
    bin, from `bounds(i, s, o)` -> (start, end), which takes Python ints
    and tensors alike."""
    k = max(e - b for b, e in (bounds(i, s, o) for i in range(o)))
    start, end = bounds(torch.arange(o, device=device), s, o)
    return start, end, k


def adaptive_bounds(i, s, o):
    """Adaptive bin i of o over s: [floor(i s / o), ceil((i + 1) s / o))."""
    return i * s // o, ((i + 1) * s + o - 1) // o


def spp_bounds(i, s, bins):
    """spp's bin i of bins over s: [floor(i s / bins), floor((i + 1) s /
    bins)), at least one wide."""
    start, end = i * s // bins, (i + 1) * s // bins
    return start, end + (end <= start)


def pool_windows(x, ksize, strides, pads, adaptive=False,
                 global_pool=False):
    """The windows _pool_with_index takes the max over: (values [N, C, *O,
    K] with -inf at padded places, flat positions [*O, K])."""
    spatial = list(x.shape[2:])
    nd = len(spatial)
    if global_pool:
        ksize, strides, pads = spatial, [1] * nd, [0] * nd
    if adaptive:
        if all(s % o == 0 for s, o in zip(spatial, ksize)):
            ksize = [s // o for s, o in zip(spatial, ksize)]
            strides, pads = list(ksize), [0] * nd
        else:
            return bin_windows(x, [_edges(s, o, adaptive_bounds, x.device)
                                   for s, o in zip(spatial, ksize)],
                               -math.inf)
    return uniform_windows(x, list(ksize), list(strides), list(pads))


def max_with_index(windows, positions):
    """(amax over each window, the flat position of its first maximum as
    int32)."""
    arg = windows.argmax(dim=-1, keepdim=True)
    mask = torch.gather(positions.expand(windows.shape), -1, arg)[..., 0]
    return windows.amax(dim=-1), mask.int()


def _pool_with_index(x, attrs, nd):
    windows, positions = pool_windows(
        x, list(attrs.get("ksize", [2] * nd)),
        list(attrs.get("strides", [1] * nd)),
        list(attrs.get("paddings", [0] * nd)),
        adaptive=attrs.get("adaptive", False),
        global_pool=attrs.get("global_pooling", False))
    out, mask = max_with_index(windows, positions)
    return {"Out": [out.to(x.dtype)], "Mask": [mask]}


@register_lowering("max_pool2d_with_index")
def _max_pool2d_with_index(ctx, inputs, attrs):
    """Max pool of X [N, C, H, W]: Out and Mask (int32, the flat H * W
    position of each window's first maximum)."""
    return _pool_with_index(one(inputs, "X"), attrs, 2)


@register_lowering("max_pool3d_with_index")
def _max_pool3d_with_index(ctx, inputs, attrs):
    """Max pool of X [N, C, D, H, W]: Out and Mask (int32, the flat
    D * H * W position)."""
    return _pool_with_index(one(inputs, "X"), attrs, 3)


def unpool_winners(idx, size):
    """For each of the `size` positions of an unpooled plane, the last
    source (ordinal in input order) whose index [N, C, k] names it, -1 for
    none."""
    n, c, k = idx.shape
    ordinal = torch.arange(k, device=idx.device).expand(n, c, k)
    winner = torch.full((n, c, size), -1, dtype=torch.int64,
                        device=idx.device)
    return winner.scatter_reduce(2, idx.long(), ordinal, reduce="amax",
                                 include_self=True)


@register_lowering("unpool")
def _unpool(ctx, inputs, attrs):
    """Max unpooling: X [N, C, h, w] to the flat positions Indices of an
    [oh, ow] plane, oh = (h - 1) * stride - 2 * pad + ksize (ow alike);
    where indices repeat the last source wins, zeros elsewhere."""
    x, idx = one(inputs, "X"), one(inputs, "Indices")
    ksize = list(attrs.get("ksize", [2, 2]))
    strides = list(attrs.get("strides", [2, 2]))
    pads = list(attrs.get("paddings", [0, 0]))
    n, c, h, w = x.shape
    oh = (h - 1) * strides[0] - 2 * pads[0] + ksize[0]
    ow = (w - 1) * strides[1] - 2 * pads[1] + ksize[1]
    k = h * w
    winner = unpool_winners(idx.reshape(n, c, k), oh * ow)
    gathered = torch.gather(x.reshape(n, c, k), 2, winner.clamp(0, k - 1))
    out = torch.where(winner >= 0, gathered, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
    return {"Out": [out.reshape(n, c, oh, ow)]}


@register_lowering("spp")
def _spp(ctx, inputs, attrs):
    """Spatial pyramid pooling of X [N, C, H, W]: levels 0 .. H - 1 pool to
    2^l bins a side (``spp_bounds``), by max (``amax``) or average, each
    level flattened channel-major, concatenated: [N, C * sum 4^l]."""
    x = one(inputs, "X")
    ptype = attrs.get("pooling_type", "max")
    n, c, h, w = x.shape
    outs = []
    for level in range(attrs.get("pyramid_height", 1)):
        bins = 2 ** level
        edges = [_edges(s, bins, spp_bounds, x.device) for s in (h, w)]
        if ptype == "max":
            windows, _ = bin_windows(x, edges, -math.inf)
            v = windows.amax(dim=-1)
        else:
            windows, _ = bin_windows(x, edges, 0.0)
            count = ((edges[0][1] - edges[0][0])[:, None] *
                     (edges[1][1] - edges[1][0])[None, :])
            v = windows.sum(dim=-1) / count.to(x.dtype)
        outs.append(v.reshape(n, c * bins * bins))
    return {"Out": [torch.cat(outs, dim=1)]}
