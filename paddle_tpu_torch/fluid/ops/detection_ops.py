"""Detection lowerings: the port's counterpart of
``paddle_tpu/fluid/ops/detection_ops.py``, all 23 of its lowerings, with the
JAX lowerings' semantics and no-grad flags (reference:
operators/detection/*). Data-dependent box counts stay fixed-size padded
tensors, as in the JAX package: multiclass_nms pads with label -1,
generate_proposals with zero rows, the target assigners with index -1.

Every one is plain PyTorch on the op's device, as the JAX lowerings are
plain XLA (no Pallas kernel), and none reads a value back to the host:
the greedy loops run a fixed number of trips on the device.

- Ranking: ``common.top_k`` and ``common.argsort`` order ties as
  ``jax.lax.top_k`` and ``jnp.argsort`` do (lower index first;
  ``torch.topk`` orders no ties and ``torch.argsort`` is unstable by
  default), so that multiclass_nms's zero-score padding, the mined
  negatives, the proposals and the sampled RoIs come out in the JAX
  order.
- Greedy suppression (multiclass_nms, generate_proposals) runs its K
  trips over a precomputed [.., K, K] "i suppresses j" matrix, batched
  over images and classes as the JAX ``vmap``s are; bipartite_match runs
  its trips over the ground-truth rows, batched over images.
- roi_pool reduces a chunk of RoIs at a time, rows then columns, and
  never builds the JAX lowering's [R, C, ph, pw, H, W] mask; its backward
  (a custom autograd function) recomputes each bin and splits the
  gradient evenly among tied maxima, as ``jnp.max``'s does. roi_align contracts
  the map with per-RoI bilinear weights ([R, ph, H] rows, [R, pw, W]
  columns) in two products, and psroi_pool with its bin masks, image by
  image, so that neither gathers ``x[bids]`` whole.
- generate_proposal_labels(use_random=True) draws its score jitter from
  the run's generator: it matches the JAX package by its invariants, not
  bit for bit.

Differences from the Paddle reference that the JAX lowerings have and the
port keeps (ROADMAP Queue 3): multiclass_nms reads no background_label;
roi_align with sampling_ratio <= 0 samples ceil(H / ph) x ceil(W / pw)
points a bin whatever the RoI's size; rpn_target_assign subsamples the
hardest anchors first, not at random; generate_mask_labels takes padded
polygons [G, P, 2]; box_decoder_and_assign is the second of the JAX
module's two definitions (the live one).
"""
import math

import numpy as np
import torch

from .registry import register_lowering
from .common import argsort, one, top_k, true_div

# roi_pool gathers the map of at most this many elements for a chunk of
# RoIs at a time
_ROI_CHUNK_ELEMENTS = 1 << 25


def device_constant(array, device):
    """A numpy constant on `device` (a pinned, non-blocking copy on a
    card, so that the host does not wait for it)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _gather_rows(x, idx):
    """x [..., M, D] at idx [..., K] along the row axis: [..., K, D]."""
    return torch.gather(x, -2, idx[..., None].expand(
        *idx.shape, x.shape[-1]))


# ---------------------------------------------------------------- priors

@register_lowering("prior_box", no_grad=True)
def _prior_box(ctx, inputs, attrs):
    feat = one(inputs, "Input")
    image = one(inputs, "Image")
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", [])]
    aspect_ratios = [float(a) for a in attrs.get("aspect_ratios", [1.0])]
    flip = attrs.get("flip", False)
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    offset = attrs.get("offset", 0.5)
    steps = attrs.get("steps", [0.0, 0.0])
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    step_h = steps[1] if steps[1] > 0 else float(ih) / h
    step_w = steps[0] if steps[0] > 0 else float(iw) / w
    ars = []
    for ar in aspect_ratios:
        ars.append(ar)
        if flip and abs(ar - 1.0) > 1e-6:
            ars.append(1.0 / ar)
    widths, heights = [], []
    for ms in min_sizes:
        for ar in ars:
            widths.append(ms * np.sqrt(ar))
            heights.append(ms / np.sqrt(ar))
        if max_sizes:
            idx = min_sizes.index(ms)
            if idx < len(max_sizes):
                s = np.sqrt(ms * max_sizes[idx])
                widths.append(s)
                heights.append(s)
    widths = np.asarray(widths, np.float32)
    heights = np.asarray(heights, np.float32)
    cx = (np.arange(w, dtype=np.float32) + offset) * step_w
    cy = (np.arange(h, dtype=np.float32) + offset) * step_h
    cxg, cyg = np.meshgrid(cx, cy)
    cxg, cyg = cxg[:, :, None], cyg[:, :, None]
    boxes = np.stack([(cxg - widths / 2.0) / iw, (cyg - heights / 2.0) / ih,
                      (cxg + widths / 2.0) / iw, (cyg + heights / 2.0) / ih],
                     axis=-1)
    if attrs.get("clip", False):
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variances, np.float32), boxes.shape)
    return {"Boxes": [device_constant(boxes, ctx.device)],
            "Variances": [device_constant(var, ctx.device)]}


@register_lowering("anchor_generator", no_grad=True)
def _anchor_generator(ctx, inputs, attrs):
    feat = one(inputs, "Input")
    sizes = [float(s) for s in attrs["anchor_sizes"]]
    ratios = [float(a) for a in attrs.get("aspect_ratios", [1.0])]
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    stride = [float(s) for s in attrs["stride"]]
    offset = float(attrs.get("offset", 0.5))
    h, w = feat.shape[2], feat.shape[3]
    ws, hs = [], []
    for r_ in ratios:
        for s in sizes:
            base_w = np.round(np.sqrt(stride[0] * stride[1] / r_))
            base_h = np.round(base_w * r_)
            ws.append(s / stride[0] * base_w)
            hs.append(s / stride[1] * base_h)
    ws = np.asarray(ws, np.float32)
    hs = np.asarray(hs, np.float32)
    cx = (np.arange(w, dtype=np.float32) + offset) * stride[0]
    cy = (np.arange(h, dtype=np.float32) + offset) * stride[1]
    cxg, cyg = np.meshgrid(cx, cy)
    cxg, cyg = cxg[:, :, None], cyg[:, :, None]
    anchors = np.stack([cxg - 0.5 * (ws - 1.0), cyg - 0.5 * (hs - 1.0),
                        cxg + 0.5 * (ws - 1.0), cyg + 0.5 * (hs - 1.0)],
                       axis=-1)
    var = np.broadcast_to(np.asarray(variances, np.float32), anchors.shape)
    return {"Anchors": [device_constant(anchors, ctx.device)],
            "Variances": [device_constant(var, ctx.device)]}


@register_lowering("density_prior_box", no_grad=True)
def _density_prior_box(ctx, inputs, attrs):
    feat = one(inputs, "Input")
    image = one(inputs, "Image")
    densities = [int(d) for d in attrs.get("densities", [])]
    fixed_sizes = [float(s) for s in attrs.get("fixed_sizes", [])]
    fixed_ratios = [float(r_) for r_ in attrs.get("fixed_ratios", [1.0])]
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    steps = attrs.get("steps", [0.0, 0.0])
    offset = float(attrs.get("offset", 0.5))
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    step_w = steps[0] if steps[0] > 0 else float(iw) / w
    step_h = steps[1] if steps[1] > 0 else float(ih) / h
    boxes = []
    for density, fs in zip(densities, fixed_sizes):
        for ar in fixed_ratios:
            box_w, box_h = fs * np.sqrt(ar), fs / np.sqrt(ar)
            shift = 1.0 / density
            for di in range(density):
                for dj in range(density):
                    boxes.append(((dj + 0.5) * shift - 0.5,
                                  (di + 0.5) * shift - 0.5, box_w, box_h))
    per_cell = np.asarray(boxes, np.float32)
    cx = (np.arange(w, dtype=np.float32) + offset) * step_w
    cy = (np.arange(h, dtype=np.float32) + offset) * step_h
    cxg, cyg = np.meshgrid(cx, cy)
    ctr_x = cxg[:, :, None] + per_cell[:, 0] * step_w
    ctr_y = cyg[:, :, None] + per_cell[:, 1] * step_h
    out = np.stack([(ctr_x - per_cell[:, 2] / 2) / iw,
                    (ctr_y - per_cell[:, 3] / 2) / ih,
                    (ctr_x + per_cell[:, 2] / 2) / iw,
                    (ctr_y + per_cell[:, 3] / 2) / ih], axis=-1)
    if attrs.get("clip", False):
        out = np.clip(out, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variances, np.float32), out.shape)
    return {"Boxes": [device_constant(out, ctx.device)],
            "Variances": [device_constant(var, ctx.device)]}


# ---------------------------------------------------------------- coding

@register_lowering("box_coder", no_grad=True)
def _box_coder(ctx, inputs, attrs):
    prior = one(inputs, "PriorBox")          # [M, 4]
    prior_var = one(inputs, "PriorBoxVar")   # [M, 4] or None
    target = one(inputs, "TargetBox")
    code_type = attrs.get("code_type", "encode_center_size")
    adj = 0.0 if attrs.get("box_normalized", True) else 1.0
    pw = prior[:, 2] - prior[:, 0] + adj
    ph = prior[:, 3] - prior[:, 1] + adj
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if prior_var is None:
        prior_var = torch.ones_like(prior)
    if code_type.startswith("encode"):
        # [N, 4] -> [N, M, 4]; batched targets [B, T, 4] -> [B, T, M, 4]
        tw = target[..., 2] - target[..., 0] + adj
        th = target[..., 3] - target[..., 1] + adj
        tcx = (target[..., 0] + tw * 0.5)[..., None]
        tcy = (target[..., 1] + th * 0.5)[..., None]
        tw, th = tw[..., None], th[..., None]
        out = torch.stack([(tcx - pcx) / pw / prior_var[:, 0],
                           (tcy - pcy) / ph / prior_var[:, 1],
                           torch.log(tw / pw) / prior_var[:, 2],
                           torch.log(th / ph) / prior_var[:, 3]], dim=-1)
    else:                     # decode_center_size: [M, 4] -> [1, M, 4]
        pv = prior_var[None]
        ox = pv[..., 0] * target[..., 0] * pw[None] + pcx[None]
        oy = pv[..., 1] * target[..., 1] * ph[None] + pcy[None]
        ow = torch.exp(pv[..., 2] * target[..., 2]) * pw[None]
        oh = torch.exp(pv[..., 3] * target[..., 3]) * ph[None]
        out = torch.stack([ox - ow * 0.5, oy - oh * 0.5,
                           ox + ow * 0.5 - adj, oy + oh * 0.5 - adj], dim=-1)
    return {"OutputBox": [out]}


def iou_matrix(x, y, normalized=True):
    """IoU of boxes x [..., M, 4] against y [..., N, 4]: [..., M, N]."""
    adj = 0.0 if normalized else 1.0
    area_x = (x[..., 2] - x[..., 0] + adj) * (x[..., 3] - x[..., 1] + adj)
    area_y = (y[..., 2] - y[..., 0] + adj) * (y[..., 3] - y[..., 1] + adj)
    xc, yc = x[..., :, None, :], y[..., None, :, :]
    iw = (torch.minimum(xc[..., 2], yc[..., 2]) -
          torch.maximum(xc[..., 0], yc[..., 0]) + adj).clamp(min=0.0)
    ih = (torch.minimum(xc[..., 3], yc[..., 3]) -
          torch.maximum(xc[..., 1], yc[..., 1]) + adj).clamp(min=0.0)
    inter = iw * ih
    return inter / (area_x[..., :, None] + area_y[..., None, :] -
                    inter).clamp(min=1e-10)


@register_lowering("iou_similarity", no_grad=True)
def _iou_similarity(ctx, inputs, attrs):
    x, y = one(inputs, "X"), one(inputs, "Y")
    return {"Out": [iou_matrix(x, y, attrs.get("box_normalized", True))]}


@register_lowering("yolo_box", no_grad=True)
def _yolo_box(ctx, inputs, attrs):
    x = one(inputs, "X")               # [N, A*(5+C), H, W]
    img_size = one(inputs, "ImgSize")  # [N, 2] (h, w)
    anchors = attrs["anchors"]
    class_num = attrs["class_num"]
    conf_thresh = attrs.get("conf_thresh", 0.01)
    downsample = attrs.get("downsample_ratio", 32)
    n, _, h, w = x.shape
    na = len(anchors) // 2
    x = x.reshape(n, na, 5 + class_num, h, w)
    dev = x.device
    grid_x = torch.arange(w, dtype=torch.float32, device=dev)
    grid_y = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    bx = true_div(torch.sigmoid(x[:, :, 0]) + grid_x, w)
    by = true_div(torch.sigmoid(x[:, :, 1]) + grid_y, h)
    anc = device_constant(np.asarray(anchors, np.float32).reshape(-1, 2),
                          dev)
    aw, ah = anc[:, 0, None, None], anc[:, 1, None, None]
    bw = true_div(torch.exp(x[:, :, 2]) * aw, downsample * w)
    bh = true_div(torch.exp(x[:, :, 3]) * ah, downsample * h)
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    keep = (conf >= conf_thresh).float()
    img_h = img_size[:, 0].float()[:, None, None, None]
    img_w = img_size[:, 1].float()[:, None, None, None]
    boxes = torch.stack([(bx - bw / 2.0) * img_w, (by - bh / 2.0) * img_h,
                         (bx + bw / 2.0) * img_w, (by + bh / 2.0) * img_h],
                        dim=-1) * keep[..., None]
    scores = (probs * keep[:, :, None]).permute(0, 1, 3, 4, 2)
    return {"Boxes": [boxes.reshape(n, na * h * w, 4)],
            "Scores": [scores.reshape(n, na * h * w, class_num)]}


# ------------------------------------------------------ greedy suppression

def greedy_keep(iou, thresh):
    """Greedy NMS over boxes sorted by score: iou [..., K, K] -> keep
    [..., K] bool, K trips of the JAX ``fori_loop`` (box i, if kept,
    suppresses every later box j with iou[i, j] > thresh)."""
    k = iou.shape[-1]
    spared = ~((iou > thresh) & torch.ones(k, k, dtype=torch.bool,
                                           device=iou.device).triu(1))
    keep = torch.ones(iou.shape[:-1], dtype=torch.bool, device=iou.device)
    if iou.device.type == "meta":          # shape inference: no values
        return keep
    for i in range(k):                     # two launches a trip
        keep = torch.where(keep[..., i:i + 1], keep & spared[..., i, :],
                           keep)
    return keep


@register_lowering("multiclass_nms", no_grad=True)
def _multiclass_nms(ctx, inputs, attrs):
    """Per class greedy suppression among the nms_top_k best boxes, then
    the keep_top_k best of all classes: Out [N, keep_top_k, 6] rows
    (label, score, x1, y1, x2, y2), label -1 on padding rows."""
    bboxes = one(inputs, "BBoxes")    # [N, M, 4]
    scores = one(inputs, "Scores")    # [N, C, M]
    score_thresh = attrs.get("score_threshold", 0.0)
    nms_thresh = attrs.get("nms_threshold", 0.3)
    n, c, m = scores.shape
    k = min(attrs.get("nms_top_k", 64), m)
    vals, idx = top_k(scores, k)                                # [N, C, K]
    sel = _gather_rows(bboxes[:, None].expand(n, c, m, 4), idx)
    keep = greedy_keep(iou_matrix(sel, sel), nms_thresh) & \
        (vals > score_thresh)
    flat_scores = (vals * keep).reshape(n, c * k)
    flat_boxes = sel.reshape(n, c * k, 4)
    top_vals, top_i = top_k(flat_scores,
                            min(attrs.get("keep_top_k", 16), c * k))
    label = torch.where(top_vals > 0, torch.div(top_i, k,
                                                rounding_mode="floor"), -1)
    out = torch.cat([label[..., None].to(top_vals.dtype), top_vals[..., None],
                     _gather_rows(flat_boxes, top_i)], dim=-1)
    return {"Out": [out]}


# ------------------------------------------------------------ RoI pooling

def _roi_batch_ids(inputs, n_rois, device):
    bid = one(inputs, "BatchId")
    if bid is None:
        return torch.zeros((n_rois,), dtype=torch.long, device=device)
    return bid.reshape(-1).long()


def _bin_masks(start, end, size):
    """[R, P, size] bool: position p of the grid lies in [start, end)."""
    grid = torch.arange(size, dtype=start.dtype, device=start.device)
    return (grid >= start[..., None]) & (grid < end[..., None])


def _roi_chunks(r, per_roi):
    step = max(1, _ROI_CHUNK_ELEMENTS // max(per_roi, 1))
    return [(r0, min(r0 + step, r)) for r0 in range(0, r, step)]


def _roi_max_forward(x, bids, ymask, xmask):
    """The max of each RoI bin, a chunk of RoIs at a time and separably:
    for each bin row the column maxima over its rows (and the first row
    holding each), then for each bin their max over its columns. Out
    [R, C, ph, pw] (0 in an empty bin) and Argmax int64, the first maximum
    in row-major order as a flat index into the map (-1 in an empty
    bin)."""
    _, c, h, w = x.shape
    r, ph, pw = ymask.shape[0], ymask.shape[1], xmask.shape[1]
    neg = torch.finfo(x.dtype).min
    col = torch.arange(w, device=x.device)
    out = x.new_zeros((r, c, ph, pw))
    arg = torch.full((r, c, ph, pw), -1, dtype=torch.long, device=x.device)
    for r0, r1 in _roi_chunks(r, c * h * w):
        feat = x[bids[r0:r1]]                                 # [rc, C, H, W]
        for i in range(ph):
            ym = ymask[r0:r1, i]
            rv, ry = torch.where(ym[:, None, :, None], feat, neg).max(dim=2)
            for j in range(pw):
                xm = xmask[r0:r1, j, None, :]                 # [rc, 1, W]
                cv = torch.where(xm, rv, neg)
                v = cv.amax(dim=-1)
                first = torch.where(xm & (cv == v[..., None]), ry * w + col,
                                    h * w).amin(dim=-1)
                filled = (ym.any(dim=1) & xm[:, 0].any(dim=1))[:, None]
                out[r0:r1, :, i, j] = torch.where(filled, v, 0.0)
                arg[r0:r1, :, i, j] = torch.where(filled, first, -1)
    return out, arg


def _roi_max_backward(x, bids, ymask, xmask, out, dout):
    """dX of roi_pool's max, bin by bin: each bin's gradient split evenly
    among its tied maxima, as ``jnp.max``'s is."""
    _, c, h, w = x.shape
    r, ph, pw = ymask.shape[0], ymask.shape[1], xmask.shape[1]
    dx = torch.zeros_like(x)
    for r0, r1 in _roi_chunks(r, c * h * w):
        feat = x[bids[r0:r1]]
        for i in range(ph):
            for j in range(pw):
                mask = ymask[r0:r1, i, :, None] & xmask[r0:r1, j, None, :]
                tied = (feat == out[r0:r1, :, i, j, None, None]) & \
                    mask[:, None]
                share = dout[r0:r1, :, i, j] / tied.sum(dim=(2, 3)).clamp(
                    min=1)
                dx.index_add_(0, bids[r0:r1], tied * share[..., None, None])
    return dx


class _RoiMaxPool(torch.autograd.Function):
    """roi_pool's max with a backward that recomputes each bin (no
    [R, C, H, W] tensor is saved)."""

    @staticmethod
    def forward(ctx, x, bids, ymask, xmask):
        out, arg = _roi_max_forward(x, bids, ymask, xmask)
        ctx.save_for_backward(x, bids, ymask, xmask, out)
        ctx.mark_non_differentiable(arg)
        return out, arg

    @staticmethod
    def backward(ctx, dout, _darg):
        x, bids, ymask, xmask, out = ctx.saved_tensors
        return _roi_max_backward(x, bids, ymask, xmask, out, dout), \
            None, None, None


@register_lowering("roi_pool")
def _roi_pool(ctx, inputs, attrs):
    """Quantized max pooling per RoI bin (reference roi_pool_op.h:103-116):
    Out [R, C, ph, pw] and Argmax, -1 (and Out 0) for an empty bin."""
    x = one(inputs, "X")               # [N, C, H, W]
    rois = one(inputs, "ROIs")         # [R, 4] x1, y1, x2, y2
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    scale = float(attrs.get("spatial_scale", 1.0))
    h, w = x.shape[2], x.shape[3]
    bids = _roi_batch_ids(inputs, rois.shape[0], x.device)
    x1, y1, x2, y2 = (torch.round(rois[:, k] * scale) for k in range(4))
    bin_h = true_div((y2 - y1 + 1.0).clamp(min=1.0), ph)
    bin_w = true_div((x2 - x1 + 1.0).clamp(min=1.0), pw)
    iy = torch.arange(ph, dtype=rois.dtype, device=rois.device)
    ix = torch.arange(pw, dtype=rois.dtype, device=rois.device)
    hstart = (torch.floor(iy * bin_h[:, None]) + y1[:, None]).clamp(0, h)
    hend = (torch.ceil((iy + 1) * bin_h[:, None]) + y1[:, None]).clamp(0, h)
    wstart = (torch.floor(ix * bin_w[:, None]) + x1[:, None]).clamp(0, w)
    wend = (torch.ceil((ix + 1) * bin_w[:, None]) + x1[:, None]).clamp(0, w)
    out, arg = _RoiMaxPool.apply(x, bids, _bin_masks(hstart, hend, h),
                                 _bin_masks(wstart, wend, w))
    return {"Out": [out], "Argmax": [arg]}


def sample_offsets(n, dtype, device):
    """Where roi_align's n samples lie along one axis of a bin, as
    fractions of the bin: the centres of n equal parts."""
    return true_div(torch.arange(n, dtype=dtype, device=device) + 0.5, n)


def _sample_weights(coords, size):
    """Bilinear weights of the samples `coords` [R, P, S] on a grid of
    `size`, averaged over the S samples: [R, P, size]. A sample is clipped
    to [0, size - 1] and reads rows floor(c) and min(floor(c) + 1,
    size - 1), as the JAX lowering's ``bilinear`` does."""
    c = coords.clamp(0.0, size - 1.0)
    lo = torch.floor(c)
    frac = c - lo
    lo = lo.long()
    hi = (lo + 1).clamp(max=size - 1)
    grid = torch.arange(size, device=c.device)
    wts = (grid == lo[..., None]) * (1.0 - frac)[..., None] + \
        (grid == hi[..., None]) * frac[..., None]
    return true_div(wts.sum(dim=2), coords.shape[2])


@register_lowering("roi_align")
def _roi_align(ctx, inputs, attrs):
    """Bilinear RoI align (reference roi_align_op.h): each bin averages
    sry x srx bilinear samples. Computed as two products with per-RoI
    weights, rows then columns: Out[r] = Wy[r] X[b_r] Wx[r]^T."""
    x = one(inputs, "X")
    rois = one(inputs, "ROIs")
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    scale = float(attrs.get("spatial_scale", 1.0))
    sr = int(attrs.get("sampling_ratio", -1))
    n, c, h, w = x.shape
    r = rois.shape[0]
    bids = _roi_batch_ids(inputs, r, x.device)
    x1 = rois[:, 0] * scale
    y1 = rois[:, 1] * scale
    bin_w = true_div((rois[:, 2] * scale - x1).clamp(min=1.0), pw)
    bin_h = true_div((rois[:, 3] * scale - y1).clamp(min=1.0), ph)
    sry = sr if sr > 0 else int(math.ceil(h / ph))
    srx = sr if sr > 0 else int(math.ceil(w / pw))
    dt, dev = rois.dtype, rois.device
    iy = torch.arange(ph, dtype=dt, device=dev)[None, :, None]
    ix = torch.arange(pw, dtype=dt, device=dev)[None, :, None]
    sy = sample_offsets(sry, dt, dev)
    sx = sample_offsets(srx, dt, dev)
    ys = y1[:, None, None] + (iy + sy) * bin_h[:, None, None]
    xs = x1[:, None, None] + (ix + sx) * bin_w[:, None, None]
    wy = _sample_weights(ys, h).to(x.dtype)                    # [R, ph, H]
    wx = _sample_weights(xs, w).to(x.dtype)                    # [R, pw, W]
    image = (bids[:, None] == torch.arange(n, device=x.device)).to(
        x.dtype)                                               # [R, N]
    rows = (wy[:, :, None, :] * image[:, None, :, None]).reshape(
        r * ph, n * h)
    a = rows @ x.permute(0, 2, 1, 3).reshape(n * h, c * w)     # [R*ph, C*W]
    out = a.reshape(r, ph * c, w) @ wx.transpose(1, 2)         # [R, ph*C, pw]
    return {"Out": [out.reshape(r, ph, c, pw).permute(0, 2, 1, 3)
                    .contiguous()]}


@register_lowering("psroi_pool")
def _psroi_pool(ctx, inputs, attrs):
    """Position-sensitive RoI average pooling (reference psroi_pool_op.h):
    bin (i, j) of output channel c averages input channel
    c * ph * pw + i * pw + j over the bin, image by image."""
    x = one(inputs, "X")               # [N, OC*ph*pw, H, W]
    rois = one(inputs, "ROIs")
    oc = int(attrs["output_channels"])
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    scale = float(attrs.get("spatial_scale", 1.0))
    n, _, h, w = x.shape
    bids = _roi_batch_ids(inputs, rois.shape[0], x.device)
    # round the raw coordinates first, then scale (starts stay fractional)
    x1 = torch.round(rois[:, 0]) * scale
    y1 = torch.round(rois[:, 1]) * scale
    x2 = (torch.round(rois[:, 2]) + 1.0) * scale
    y2 = (torch.round(rois[:, 3]) + 1.0) * scale
    bin_h = true_div((y2 - y1).clamp(min=0.1), ph)
    bin_w = true_div((x2 - x1).clamp(min=0.1), pw)
    iy = torch.arange(ph, dtype=rois.dtype, device=rois.device)
    ix = torch.arange(pw, dtype=rois.dtype, device=rois.device)
    hstart = torch.floor(iy * bin_h[:, None] + y1[:, None]).clamp(0, h)
    hend = torch.ceil((iy + 1) * bin_h[:, None] + y1[:, None]).clamp(0, h)
    wstart = torch.floor(ix * bin_w[:, None] + x1[:, None]).clamp(0, w)
    wend = torch.ceil((ix + 1) * bin_w[:, None] + x1[:, None]).clamp(0, w)
    ymask = _bin_masks(hstart, hend, h).to(x.dtype)          # [R, ph, H]
    xmask = _bin_masks(wstart, wend, w).to(x.dtype)          # [R, pw, W]
    area = (ymask.sum(-1)[:, :, None] * xmask.sum(-1)[:, None, :]).clamp(
        min=1.0)
    feat = x.reshape(n, oc, ph, pw, h, w)
    out = None
    for b in range(n):
        cols = torch.einsum("cijyx,rjx->rcijy", feat[b], xmask)
        s = torch.einsum("rcijy,riy->rcij", cols, ymask)
        s = torch.where((bids == b)[:, None, None, None], s, 0.0)
        out = s if out is None else out + s
    return {"Out": [out / area[:, None]]}


@register_lowering("roi_perspective_transform")
def _roi_perspective_transform(ctx, inputs, attrs):
    """Perspective-warp quadrilateral RoIs [R, 8] (clockwise from top-left)
    to a th x tw grid (roi_perspective_transform_op.cc:531-560): the four
    bilinear taps gathered from the map at each grid point, 0 outside."""
    x = one(inputs, "X")               # [N, C, H, W]
    rois = one(inputs, "ROIs")         # [R, 8]
    th = int(attrs["transformed_height"])
    tw = int(attrs["transformed_width"])
    scale = float(attrs.get("spatial_scale", 1.0))
    h, w = x.shape[2], x.shape[3]
    r = rois.shape[0]
    bids = _roi_batch_ids(inputs, r, x.device)
    q = rois.reshape(r, 4, 2) * scale
    p0, p1, p2, p3 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    s = p0 - p1 + p2 - p3
    d1 = p1 - p2
    d2 = p3 - p2
    den = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    den = torch.where(den.abs() < 1e-8, torch.full_like(den, 1e-8), den)
    g = (s[:, 0] * d2[:, 1] - s[:, 1] * d2[:, 0]) / den
    hh = (d1[:, 0] * s[:, 1] - d1[:, 1] * s[:, 0]) / den
    a = p1 - p0 + g[:, None] * p1
    b = p3 - p0 + hh[:, None] * p3
    u = true_div(torch.arange(tw, dtype=rois.dtype, device=rois.device),
                 max(tw - 1, 1))
    v = true_div(torch.arange(th, dtype=rois.dtype, device=rois.device),
                 max(th - 1, 1))
    gv, gu = torch.meshgrid(v, u, indexing="ij")               # [th, tw]

    def per_roi(t):
        return t[:, None, None]
    denom = per_roi(g) * gu + per_roi(hh) * gv + 1.0
    px = (per_roi(a[:, 0]) * gu + per_roi(b[:, 0]) * gv +
          per_roi(p0[:, 0]) * denom) / denom
    py = (per_roi(a[:, 1]) * gu + per_roi(b[:, 1]) * gv +
          per_roi(p0[:, 1]) * denom) / denom
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    valid = (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)
    xi0 = x0.clamp(0, w - 1).long()
    yi0 = y0.clamp(0, h - 1).long()
    xi1 = (xi0 + 1).clamp(0, w - 1)
    yi1 = (yi0 + 1).clamp(0, h - 1)
    bi = bids[:, None, None]

    def tap(yi, xi):                                   # [C, R, th, tw]
        return x[bi, :, yi, xi].permute(3, 0, 1, 2)
    out = (tap(yi0, xi0) * (1 - fx) * (1 - fy) + tap(yi0, xi1) * fx *
           (1 - fy) + tap(yi1, xi0) * (1 - fx) * fy + tap(yi1, xi1) * fx * fy)
    out = torch.where(valid, out, 0.0).permute(1, 0, 2, 3)
    return {"Out": [out.to(x.dtype).contiguous()]}


# ------------------------------------------ matching / target assignment

def bipartite_match(dist, match_type, thresh):
    """Greedy global-max matching (bipartite_match_op.cc:66-138) over
    dist [B, M, N], one trip a ground-truth row: (col_to_row [B, N] int32,
    col_dist [B, N]); per_prediction then fills each unmatched column whose
    best row reaches `thresh`."""
    b, m, n_col = dist.shape
    eps = 1e-6
    dev = dist.device
    cols = torch.arange(n_col, device=dev)
    rows = torch.arange(m, device=dev)
    col_match = torch.full((b, n_col), -1, dtype=torch.int32, device=dev)
    col_dist = torch.zeros((b, n_col), dtype=dist.dtype, device=dev)
    row_used = torch.zeros((b, m), dtype=torch.bool, device=dev)
    usable = dist >= eps
    for _ in range(m):
        avail = ~row_used[:, :, None] & (col_match[:, None, :] == -1) & usable
        masked = torch.where(avail, dist, -1.0).reshape(b, m * n_col)
        flat = masked.argmax(dim=1)
        best = masked.gather(1, flat[:, None])[:, 0]
        i = torch.div(flat, n_col, rounding_mode="floor")
        j = flat - i * n_col
        ok = best > 0
        at_j = ok[:, None] & (cols == j[:, None])
        col_match = torch.where(at_j, i[:, None].int(), col_match)
        col_dist = torch.where(at_j, best[:, None], col_dist)
        row_used = row_used | (ok[:, None] & (rows == i[:, None]))
    if match_type == "per_prediction":
        best_row = dist.argmax(dim=1).int()
        best = dist.amax(dim=1)
        fill = (col_match == -1) & (best >= thresh) & (best >= eps)
        col_match = torch.where(fill, best_row, col_match)
        col_dist = torch.where(fill, best, col_dist)
    return col_match, col_dist


@register_lowering("bipartite_match", no_grad=True)
def _bipartite_match(ctx, inputs, attrs):
    dist = one(inputs, "DistMat")       # [M, N] or [B, M, N]
    if dist.ndim == 2:
        dist = dist[None]
    cm, cd = bipartite_match(dist, attrs.get("match_type", "bipartite"),
                             float(attrs.get("dist_threshold", 0.5)))
    return {"ColToRowMatchIndices": [cm], "ColToRowMatchDist": [cd]}


@register_lowering("target_assign", no_grad=True)
def _target_assign(ctx, inputs, attrs):
    """Per-column targets gathered by match index; a mismatch takes
    mismatch_value and weight 0, a listed negative weight 1
    (target_assign_op.h)."""
    x = one(inputs, "X")                 # [B, M, K] (or [B, M, N, K])
    match = one(inputs, "MatchIndices")  # [B, N]
    neg = one(inputs, "NegIndices")
    mismatch_value = attrs.get("mismatch_value", 0)
    if x.ndim == 2:
        x = x[None]
    b, n_col = match.shape
    k = x.shape[-1]
    safe = match.clamp(min=0).long()
    if x.ndim == 4:                      # out[col] = x[match[col], col]
        gathered = torch.gather(x.expand(b, *x.shape[1:]), 1,
                                safe[:, None, :, None].expand(b, 1, n_col,
                                                              k))[:, 0]
    else:
        gathered = torch.gather(x.expand(b, *x.shape[1:]), 1,
                                safe[:, :, None].expand(b, n_col, k))
    matched = (match >= 0)[:, :, None]
    out = torch.where(matched, gathered,
                      torch.full_like(gathered, mismatch_value))
    wt = matched.to(x.dtype if x.is_floating_point() else torch.float32)
    if neg is not None:
        neg = neg.reshape(b, -1)
        neg_mask = torch.zeros((b, n_col), dtype=torch.int32,
                               device=x.device).scatter_reduce(
            1, neg.clamp(min=0).long(), (neg >= 0).int(), reduce="amax")
        wt = torch.maximum(wt, neg_mask[:, :, None].to(wt.dtype))
    return {"Out": [out], "OutWeight": [wt]}


@register_lowering("box_clip", no_grad=True)
def _box_clip(ctx, inputs, attrs):
    boxes = one(inputs, "Input")         # [M, 4] or [B, M, 4]
    im_info = one(inputs, "ImInfo")      # [B, 3] (h, w, scale)
    info = im_info[:, None] if boxes.ndim == 3 else im_info[0]
    h = info[..., 0:1] - 1.0
    w = info[..., 1:2] - 1.0
    zero = torch.zeros_like(h)
    lo = torch.cat([zero, zero, zero, zero], dim=-1)
    hi = torch.cat([w, h, w, h], dim=-1)
    return {"Output": [torch.minimum(torch.maximum(boxes, lo), hi)]}


@register_lowering("polygon_box_transform", no_grad=True)
def _polygon_box_transform(ctx, inputs, attrs):
    """Offset maps to absolute quad coordinates
    (polygon_box_transform_op.cc:39-50): even channels 4 w - in, odd
    channels 4 h - in."""
    x = one(inputs, "Input")             # [N, 2k, H, W]
    _, c, h, w = x.shape
    xs = torch.arange(w, dtype=x.dtype, device=x.device) * 4.0
    ys = torch.arange(h, dtype=x.dtype, device=x.device)[:, None] * 4.0
    is_even = (torch.arange(c, device=x.device) % 2 == 0)[:, None, None]
    return {"Output": [torch.where(is_even, xs - x, ys - x)]}


@register_lowering("mine_hard_examples", no_grad=True)
def _mine_hard_examples(ctx, inputs, attrs):
    """mine_hard_examples_op.cc:88-135. max_negative: the hardest
    num_pos * neg_pos_ratio unmatched priors below neg_dist_threshold;
    hard_example: the hardest sample_size of all, unselected positives
    unmatched. NegIndices [B, P] int32, ascending, padded with -1."""
    cls_loss = one(inputs, "ClsLoss")       # [B, P]
    loc_loss = one(inputs, "LocLoss")
    match = one(inputs, "MatchIndices")     # [B, P]
    dist = one(inputs, "MatchDist")
    mining = attrs.get("mining_type", "max_negative")
    sample_size = int(attrs.get("sample_size", 0))
    b, p = cls_loss.shape
    if mining == "hard_example":
        if sample_size <= 0:
            raise ValueError("mining_type='hard_example' requires a positive "
                             "sample_size attribute")
        loss = cls_loss if loc_loss is None else cls_loss + loc_loss
        eligible = torch.ones_like(match, dtype=torch.bool)
        num_neg = torch.full((b,), min(sample_size, p), dtype=torch.int32,
                             device=match.device)
    else:
        loss = cls_loss
        eligible = match < 0
        if dist is not None:
            eligible = eligible & (dist < float(attrs.get(
                "neg_dist_threshold", 0.5)))
        num_pos = (match >= 0).sum(dim=1)
        num_neg = torch.minimum(
            (num_pos * float(attrs.get("neg_pos_ratio", 3.0))).int(),
            eligible.sum(dim=1).int())
    masked = torch.where(eligible, loss, -math.inf)
    order = argsort(-masked, dim=1)        # hardest first
    rank = torch.arange(p, device=match.device)
    selected = torch.zeros((b, p), dtype=torch.bool,
                           device=match.device).scatter(
        1, order, rank < num_neg[:, None])
    if mining == "hard_example":
        neg_sel = selected & (match < 0)
        upd = torch.where((match >= 0) & ~selected, -1, match)
    else:
        neg_sel, upd = selected, match
    neg_sorted = torch.sort(torch.where(neg_sel, rank, p), dim=1)[0]
    neg_idx = torch.where(neg_sorted < p, neg_sorted, -1).int()
    return {"NegIndices": [neg_idx], "UpdatedMatchIndices": [upd]}


# ------------------------------------------------- RPN / FPN proposals

def _decode_anchor_deltas(anchors, deltas, variances):
    """anchors [..., 4] + deltas [..., 4] -> boxes (the reference's
    generate_proposals_op.cc BoxCoder, dw / dh capped at log(1000 / 16))."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    acx = anchors[..., 0] + aw * 0.5
    acy = anchors[..., 1] + ah * 0.5
    if variances is not None:
        deltas = deltas * variances
    cap = float(np.log(1000.0 / 16.0))
    cx = deltas[..., 0] * aw + acx
    cy = deltas[..., 1] * ah + acy
    w = torch.exp(deltas[..., 2].clamp(max=cap)) * aw
    h = torch.exp(deltas[..., 3].clamp(max=cap)) * ah
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5 - 1.0, cy + h * 0.5 - 1.0], dim=-1)


@register_lowering("generate_proposals", no_grad=True)
def _generate_proposals(ctx, inputs, attrs):
    """RPN proposals per image: the pre_nms_topN best anchors decoded and
    clipped, those under min_size dropped, greedy NMS, the post_nms_topN
    best kept; RpnRois [N * post, 4] and RpnRoiProbs padded with 0,
    RpnRoisNum [N] int32."""
    scores = one(inputs, "Scores")        # [N, A, H, W]
    deltas = one(inputs, "BboxDeltas")    # [N, 4A, H, W]
    im_info = one(inputs, "ImInfo")       # [N, 3]
    anchors = one(inputs, "Anchors")      # [H, W, A, 4]
    variances = one(inputs, "Variances")
    nms_thresh = float(attrs.get("nms_thresh", 0.7))
    min_size = float(attrs.get("min_size", 0.1))
    n, a, h, w = scores.shape
    pre = min(int(attrs.get("pre_nms_topN", 6000)), a * h * w)
    post = min(int(attrs.get("post_nms_topN", 1000)), pre)
    anc = anchors.reshape(-1, 4)
    sc = scores.permute(0, 2, 3, 1).reshape(n, -1)           # HWA order
    dl = deltas.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(
        n, -1, 4)
    top_sc, top_i = top_k(sc, pre)
    var = None if variances is None else variances.reshape(-1, 4)[top_i]
    boxes = _decode_anchor_deltas(anc[top_i], _gather_rows(dl, top_i), var)
    ih, iw = im_info[:, 0, None], im_info[:, 1, None]
    x1 = torch.minimum(boxes[..., 0].clamp(min=0), iw - 1)
    y1 = torch.minimum(boxes[..., 1].clamp(min=0), ih - 1)
    x2 = torch.minimum(boxes[..., 2].clamp(min=0), iw - 1)
    y2 = torch.minimum(boxes[..., 3].clamp(min=0), ih - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    ms = min_size * im_info[:, 2, None]
    alive = ((x2 - x1 + 1.0) >= ms) & ((y2 - y1 + 1.0) >= ms)
    vals, idx = top_k(torch.where(alive, top_sc, -math.inf), pre)
    sel = _gather_rows(boxes, idx)
    keep = greedy_keep(iou_matrix(sel, sel, normalized=False), nms_thresh)
    keep = keep & (vals > -math.inf)
    out_sc, out_i = top_k(torch.where(keep, vals, -math.inf), post)
    rois = _gather_rows(sel, out_i)
    valid = out_sc > -math.inf
    rois = torch.where(valid[..., None], rois, 0.0)
    return {"RpnRois": [rois.reshape(-1, 4)],
            "RpnRoiProbs": [torch.where(valid, out_sc, 0.0).reshape(-1, 1)],
            "RpnRoisNum": [valid.sum(dim=1).int()]}


@register_lowering("rpn_target_assign", no_grad=True)
def _rpn_target_assign(ctx, inputs, attrs):
    """Anchors labelled fg / bg by IoU (rpn_target_assign_op.cc) and
    subsampled to rpn_batch_size_per_im, the hardest first (the JAX
    lowering's top-k in place of the reference's random pick); indices
    padded with -1."""
    anchor = one(inputs, "Anchor")        # [K, 4]
    gt = one(inputs, "GtBoxes")           # [G, 4]
    is_crowd = one(inputs, "IsCrowd")
    im_info = one(inputs, "ImInfo")
    fg_frac = float(attrs.get("rpn_fg_fraction", 0.5))
    pos_thresh = float(attrs.get("rpn_positive_overlap", 0.7))
    neg_thresh = float(attrs.get("rpn_negative_overlap", 0.3))
    straddle = float(attrs.get("rpn_straddle_thresh", 0.0))
    k = anchor.shape[0]
    batch_size = min(int(attrs.get("rpn_batch_size_per_im", 256)), k)
    iou = iou_matrix(gt, anchor, normalized=False)           # [G, K]
    if is_crowd is not None:
        iou = torch.where(is_crowd.reshape(-1, 1) == 0, iou, 0.0)
    if straddle >= 0:
        ih, iw = im_info[0, 0], im_info[0, 1]
        inside = (anchor[:, 0] >= -straddle) & \
            (anchor[:, 1] >= -straddle) & \
            (anchor[:, 2] < iw + straddle) & (anchor[:, 3] < ih + straddle)
        iou = torch.where(inside[None, :], iou, 0.0)
    else:
        inside = torch.ones((k,), dtype=torch.bool, device=anchor.device)
    best_gt = iou.amax(dim=0)
    argmax_gt = iou.argmax(dim=0)
    best_anchor_per_gt = iou.amax(dim=1, keepdim=True)
    is_best = (iou >= best_anchor_per_gt.clamp(min=1e-6)).any(dim=0)
    fg_mask = (is_best | (best_gt >= pos_thresh)) & inside
    bg_mask = ~fg_mask & (best_gt < neg_thresh) & inside
    max_fg = int(batch_size * fg_frac)
    fg_vals, fg_idx = top_k(torch.where(fg_mask, best_gt, -math.inf), max_fg)
    fg_valid = fg_vals > -math.inf
    bg_vals, bg_idx = top_k(torch.where(bg_mask, -best_gt, -math.inf),
                            batch_size - max_fg)
    bg_valid = bg_vals > -math.inf
    loc_index = torch.where(fg_valid, fg_idx, -1).int()
    score_index = torch.cat([loc_index,
                             torch.where(bg_valid, bg_idx, -1).int()])
    tgt_lbl = torch.cat([torch.where(fg_valid, 1, -1),
                         torch.where(bg_valid, 0, -1)]).int()
    matched_gt = gt[argmax_gt[fg_idx]]
    anc_fg = anchor[fg_idx]
    aw = anc_fg[:, 2] - anc_fg[:, 0] + 1.0
    ah = anc_fg[:, 3] - anc_fg[:, 1] + 1.0
    acx = anc_fg[:, 0] + 0.5 * aw
    acy = anc_fg[:, 1] + 0.5 * ah
    gw = matched_gt[:, 2] - matched_gt[:, 0] + 1.0
    gh = matched_gt[:, 3] - matched_gt[:, 1] + 1.0
    gcx = matched_gt[:, 0] + 0.5 * gw
    gcy = matched_gt[:, 1] + 0.5 * gh
    tgt_bbox = torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                            torch.log(gw / aw), torch.log(gh / ah)], dim=-1)
    tgt_bbox = torch.where(fg_valid[:, None], tgt_bbox, 0.0)
    inside_w = fg_valid[:, None].to(tgt_bbox.dtype).expand(-1, 4)
    return {"LocationIndex": [loc_index], "ScoreIndex": [score_index],
            "TargetLabel": [tgt_lbl], "TargetBBox": [tgt_bbox],
            "BBoxInsideWeight": [inside_w.contiguous()]}


@register_lowering("distribute_fpn_proposals", no_grad=True)
def _distribute_fpn_proposals(ctx, inputs, attrs):
    """Each RoI to an FPN level by sqrt(area)
    (distribute_fpn_proposals_op.cc); every level padded to the full RoI
    count, its RoIs first in index order; RestoreIndex [R, 1] int32, each
    RoI's row in the levels' concatenation."""
    rois = one(inputs, "FpnRois")         # [R, 4]
    min_level = int(attrs.get("min_level", 2))
    max_level = int(attrs.get("max_level", 5))
    refer_level = int(attrs.get("refer_level", 4))
    refer_scale = float(attrs.get("refer_scale", 224))
    r = rois.shape[0]
    dev = rois.device
    scale = torch.sqrt(((rois[:, 2] - rois[:, 0] + 1.0) *
                        (rois[:, 3] - rois[:, 1] + 1.0)).clamp(min=1e-6))
    lvl = torch.floor(torch.log2(true_div(scale, refer_scale) + 1e-6)) + \
        refer_level
    lvl = lvl.clamp(min_level, max_level).int()
    ar = torch.arange(r, device=dev)
    outs, counts, slots = [], [], []
    for level in range(min_level, max_level + 1):
        sel = lvl == level
        perm = argsort(torch.where(sel, ar, r + ar))
        kept = sel[perm]
        outs.append(torch.where(kept[:, None], rois[perm], 0.0))
        counts.append(sel.sum().int())
        slots.append(torch.where(kept, perm, -1))
    src = torch.cat(slots)
    pos = torch.arange(src.shape[0], dtype=torch.int32, device=dev)
    restore = torch.full((r,), -1, dtype=torch.int32,
                         device=dev).scatter_reduce(
        0, src.clamp(min=0), torch.where(src >= 0, pos, -1), reduce="amax")
    return {"MultiFpnRois": outs, "MultiLevelRoIsNum": counts,
            "RestoreIndex": [restore.reshape(-1, 1)]}


def _bce(logit, label):
    return logit.clamp(min=0) - logit * label + \
        torch.log1p(torch.exp(-logit.abs()))


@register_lowering("yolov3_loss")
def _yolov3_loss(ctx, inputs, attrs):
    """Per-scale YOLOv3 training loss (yolov3_loss_op.h): each gt box
    matched to its best-shaped anchor and its grid cell; objectness BCE
    with ignore_thresh; box BCE + L1; class BCE. Loss [N]."""
    x = one(inputs, "X")                  # [N, A*(5+C), H, W]
    gt_box = one(inputs, "GTBox")         # [N, B, 4] cx, cy, w, h relative
    gt_label = one(inputs, "GTLabel")     # [N, B]
    gt_score = one(inputs, "GTScore")
    anchors = [float(a) for a in attrs["anchors"]]
    mask = [int(m) for m in attrs.get("anchor_mask",
                                      range(len(anchors) // 2))]
    class_num = int(attrs["class_num"])
    ignore_thresh = float(attrs.get("ignore_thresh", 0.7))
    downsample = int(attrs.get("downsample_ratio", 32))
    n, _, h, w = x.shape
    na = len(mask)
    nb = gt_box.shape[1]
    dev = x.device
    x = x.reshape(n, na, 5 + class_num, h, w)
    input_h, input_w = downsample * h, downsample * w
    anc = device_constant(np.asarray(anchors, np.float32).reshape(-1, 2),
                          dev)
    all_aw, all_ah = anc[:, 0], anc[:, 1]
    mk = device_constant(np.asarray(mask, np.int64), dev)
    m_aw, m_ah = all_aw[mk], all_ah[mk]
    tx, ty, tw, th, tobj = (x[:, :, k] for k in range(5))
    tcls = x[:, :, 5:]                    # [N, A, C, H, W]

    gw = gt_box[..., 2] * input_w         # [N, B]
    gh = gt_box[..., 3] * input_h
    inter = torch.minimum(gw[..., None], all_aw) * \
        torch.minimum(gh[..., None], all_ah)
    union = gw[..., None] * gh[..., None] + all_aw * all_ah - inter
    best_anchor = torch.argmax(inter / union.clamp(min=1e-10), dim=-1)
    in_mask = torch.zeros_like(best_anchor, dtype=torch.bool)
    sel_a = torch.zeros_like(best_anchor)
    for mi, m in enumerate(mask):
        hit = best_anchor == m
        in_mask = in_mask | hit
        sel_a = torch.where(hit, mi, sel_a)
    valid = in_mask & (gw > 0) & (gh > 0)
    gi = (gt_box[..., 0] * w).int().clamp(0, w - 1).long()
    gj = (gt_box[..., 1] * h).int().clamp(0, h - 1).long()
    tgt_x = gt_box[..., 0] * w - gi
    tgt_y = gt_box[..., 1] * h - gj
    tgt_w = torch.log((gw / m_aw[sel_a].clamp(min=1e-6)).clamp(min=1e-9))
    tgt_h = torch.log((gh / m_ah[sel_a].clamp(min=1e-6)).clamp(min=1e-9))
    box_scale = 2.0 - gt_box[..., 2] * gt_box[..., 3]
    batch_idx = torch.arange(n, device=dev)[:, None].expand(n, nb)
    flat = (batch_idx, sel_a, gj, gi)
    score_w = torch.ones((n, nb), device=dev) if gt_score is None \
        else gt_score.float()
    vf = valid.float()
    vw = vf * box_scale * score_w
    loss_xy = (_bce(tx[flat], tgt_x) + _bce(ty[flat], tgt_y)) * vw
    loss_wh = ((tw[flat] - tgt_w).abs() + (th[flat] - tgt_h).abs()) * vw
    cell = ((batch_idx * na + sel_a) * h + gj) * w + gi
    obj_tgt = torch.zeros(n * na * h * w, device=dev).scatter_reduce(
        0, cell.reshape(-1), (vf * score_w).reshape(-1),
        reduce="amax").reshape(n, na, h, w)
    # predicted boxes for the ignore mask (no gradient flows through it)
    grid_x = torch.arange(w, dtype=torch.float32, device=dev)
    grid_y = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    px = true_div(torch.sigmoid(tx) + grid_x, w)
    py = true_div(torch.sigmoid(ty) + grid_y, h)
    pw = true_div(torch.exp(tw.clamp(-10, 10)) * m_aw[:, None, None],
                  input_w)
    ph = true_div(torch.exp(th.clamp(-10, 10)) * m_ah[:, None, None],
                  input_h)
    g = gt_box[:, None, None, None]                        # [N,1,1,1,B,4]
    px1, py1 = (px - pw / 2)[..., None], (py - ph / 2)[..., None]
    px2, py2 = (px + pw / 2)[..., None], (py + ph / 2)[..., None]
    ix = (torch.minimum(px2, g[..., 0] + g[..., 2] / 2) -
          torch.maximum(px1, g[..., 0] - g[..., 2] / 2)).clamp(min=0.0)
    iy = (torch.minimum(py2, g[..., 1] + g[..., 3] / 2) -
          torch.maximum(py1, g[..., 1] - g[..., 3] / 2)).clamp(min=0.0)
    inter = ix * iy
    union = (pw * ph)[..., None] + g[..., 2] * g[..., 3] - inter
    max_iou = (inter / union.clamp(min=1e-10)).amax(dim=-1)  # [N, A, H, W]
    ignore = (max_iou > ignore_thresh) & (obj_tgt == 0)
    obj_w = torch.where(ignore, 0.0, 1.0)
    loss_obj = (_bce(tobj, obj_tgt.clamp(max=1.0)) * obj_w).sum(dim=(1, 2,
                                                                      3))
    # jax.nn.one_hot: a label outside [0, class_num) gives zeros
    cls_tgt = (gt_label.long()[..., None] ==
               torch.arange(class_num, device=dev)).float()
    if attrs.get("use_label_smooth", False):
        delta = min(1.0 / class_num, 1.0 / 40.0)
        cls_tgt = cls_tgt * (1.0 - 2.0 * delta) + delta
    cls_logit = tcls.permute(0, 1, 3, 4, 2)[batch_idx, sel_a, gj, gi]
    loss_cls = (_bce(cls_logit, cls_tgt).sum(-1) * vf * score_w).sum(dim=1)
    loss = loss_xy.sum(dim=1) + loss_wh.sum(dim=1) + loss_obj + loss_cls
    return {"Loss": [loss], "ObjectnessMask": [obj_w],
            "GTMatchMask": [valid.int()]}


def _encode_box_deltas(rois, gts, weights):
    rw = rois[:, 2] - rois[:, 0] + 1.0
    rh = rois[:, 3] - rois[:, 1] + 1.0
    rcx = rois[:, 0] + 0.5 * rw
    rcy = rois[:, 1] + 0.5 * rh
    gw = gts[:, 2] - gts[:, 0] + 1.0
    gh = gts[:, 3] - gts[:, 1] + 1.0
    gcx = gts[:, 0] + 0.5 * gw
    gcy = gts[:, 1] + 0.5 * gh
    wx, wy, ww, wh = weights
    return torch.stack([wx * (gcx - rcx) / rw, wy * (gcy - rcy) / rh,
                        ww * torch.log(gw / rw), wh * torch.log(gh / rh)],
                       dim=1)


@register_lowering("generate_proposal_labels", no_grad=True)
def _generate_proposal_labels(ctx, inputs, attrs):
    """RoIs sampled against the ground truth, with per-class regression
    targets (generate_proposal_labels_op.cc:447-508): exactly
    batch_size_per_im rows, fg first, padding labelled -1."""
    rois = one(inputs, "RpnRois")       # [R, 4]
    gt_cls = one(inputs, "GtClasses").reshape(-1).long()
    is_crowd = one(inputs, "IsCrowd")
    gt = one(inputs, "GtBoxes")         # [G, 4]
    bs = int(attrs.get("batch_size_per_im", 256))
    fg_thresh = attrs.get("fg_thresh", 0.5)
    bg_hi = attrs.get("bg_thresh_hi", 0.5)
    bg_lo = attrs.get("bg_thresh_lo", 0.0)
    weights = attrs.get("bbox_reg_weights", [0.1, 0.1, 0.2, 0.2])
    class_nums = int(attrs.get("class_nums", 81))
    dev = rois.device
    cand = torch.cat([rois[:, :4], gt], dim=0)  # gt boxes join the pool
    nc = cand.shape[0]
    iou = iou_matrix(cand, gt, normalized=False)
    if is_crowd is not None:
        iou = torch.where(is_crowd.reshape(-1).bool()[None, :], 0.0, iou)
    best = iou.amax(dim=1)
    best_gt = iou.argmax(dim=1)
    is_fg = best >= fg_thresh
    is_bg = (best < bg_hi) & (best >= bg_lo)
    fg_cap = int(np.round(attrs.get("fg_fraction", 0.25) * bs))
    score = best
    if attrs.get("use_random", False):
        gen = ctx.next_rng()
        score = best + torch.rand(best.shape, generator=gen, device=dev,
                                  dtype=best.dtype) * 1e-4
    fg_rank = argsort(torch.where(is_fg, -score, math.inf))
    bg_rank = argsort(torch.where(is_bg, -score, math.inf))
    n_fg = is_fg.sum().clamp(max=fg_cap)
    n_bg = torch.minimum(is_bg.sum(), bs - n_fg)
    slots = torch.arange(bs, device=dev)
    take_fg = slots < n_fg
    sel = torch.where(take_fg, fg_rank[slots.clamp(0, nc - 1)],
                      bg_rank[(slots - n_fg).clamp(0, nc - 1)])
    real = slots < n_fg + n_bg
    out_rois = cand[sel]
    labels = torch.where(take_fg, gt_cls[best_gt[sel]], 0)
    labels = torch.where(real, labels, -1).int()
    deltas = _encode_box_deltas(out_rois, gt[best_gt[sel]], weights)
    fg = (labels > 0)[:, None]
    cols = labels.long().clamp(0, class_nums - 1)[:, None] * 4 + \
        torch.arange(4, device=dev)
    tgt = torch.zeros((bs, 4 * class_nums), dtype=deltas.dtype,
                      device=dev).scatter(1, cols,
                                          torch.where(fg, deltas, 0.0))
    inside = torch.zeros_like(tgt).scatter(
        1, cols, fg.to(tgt.dtype).expand(-1, 4))
    outside = torch.where(real[:, None], (inside > 0).to(tgt.dtype), 0.0)
    return {"Rois": [out_rois], "LabelsInt32": [labels],
            "BboxTargets": [tgt], "BboxInsideWeights": [inside],
            "BboxOutsideWeights": [outside]}


@register_lowering("generate_mask_labels", no_grad=True)
def _generate_mask_labels(ctx, inputs, attrs):
    """Mask R-CNN mask targets (generate_mask_labels_op.cc:373-417) from
    padded polygons GtSegms [G, P, 2] (trailing vertices repeat the last):
    each fg RoI matched to the same-class gt whose polygon's box overlaps
    it most, its polygon rasterized on the RoI's res x res grid by the
    crossing number; MaskInt32 [R, num_classes * res * res], -1 outside
    the RoI's class."""
    rois = one(inputs, "Rois")          # [R, 4]
    labels = one(inputs, "LabelsInt32").reshape(-1).long()
    gt_cls = one(inputs, "GtClasses").reshape(-1).long()
    segms = one(inputs, "GtSegms")      # [G, P, 2]
    num_classes = int(attrs.get("num_classes", 81))
    res = int(attrs.get("resolution", 14))
    r = rois.shape[0]
    dev = rois.device
    seg_lo = segms.amin(dim=1)
    seg_hi = segms.amax(dim=1)
    iw = (torch.minimum(rois[:, None, 2], seg_hi[None, :, 0]) -
          torch.maximum(rois[:, None, 0], seg_lo[None, :, 0])).clamp(min=0)
    ih = (torch.minimum(rois[:, None, 3], seg_hi[None, :, 1]) -
          torch.maximum(rois[:, None, 1], seg_lo[None, :, 1])).clamp(min=0)
    same_cls = labels[:, None] == gt_cls[None, :]
    match = torch.where(same_cls, iw * ih, -1.0).argmax(dim=1)
    poly = segms[match]                                  # [R, P, 2]
    centres = true_div(torch.arange(res, dtype=torch.float32, device=dev) +
                       0.5, res)
    h = (rois[:, 3] - rois[:, 1]).clamp(min=1e-6)
    w = (rois[:, 2] - rois[:, 0]).clamp(min=1e-6)
    gy = (rois[:, 1, None] + centres * h[:, None])[:, None, :, None]
    gx = (rois[:, 0, None] + centres * w[:, None])[:, None, None, :]
    vx, vy = poly[..., 0], poly[..., 1]
    nvx, nvy = torch.roll(vx, -1, dims=1), torch.roll(vy, -1, dims=1)
    vx, vy = vx[:, :, None, None], vy[:, :, None, None]
    dy = torch.where(nvy == poly[..., 1], 1e-9, nvy - poly[..., 1])
    cond = (vy > gy) != (nvy[:, :, None, None] > gy)
    t = (gy - vy) / dy[:, :, None, None]
    xint = vx + t * (nvx - poly[..., 0])[:, :, None, None]
    masks = ((cond & (gx < xint)).sum(dim=1) % 2).int()  # [R, res, res]
    fg = labels > 0
    cols = labels.clamp(0, num_classes - 1)[:, None] * res * res + \
        torch.arange(res * res, device=dev)
    out = torch.full((r, num_classes * res * res), -1, dtype=torch.int32,
                     device=dev).scatter(
        1, cols, torch.where(fg[:, None], masks.reshape(r, -1), -1))
    return {"MaskRois": [rois], "RoiHasMaskInt32": [fg.int()],
            "MaskInt32": [out]}


@register_lowering("box_decoder_and_assign", no_grad=True)
def _box_decoder_and_assign(ctx, inputs, attrs):
    """Per-class box decode and the box of the best non-background class
    (box_decoder_and_assign_op.cc, Cascade R-CNN's head): the JAX module's
    second, live definition; dw / dh clipped only for a non-zero box_clip,
    PriorBoxVar [4] or [R, 4]."""
    prior = one(inputs, "PriorBox")            # [R, 4]
    pvar = one(inputs, "PriorBoxVar")          # [4] or [R, 4]
    target = one(inputs, "TargetBox")          # [R, C*4]
    score = one(inputs, "BoxScore")            # [R, C]
    clip = attrs.get("box_clip", 0.0) or 0.0
    r, c = prior.shape[0], score.shape[1]
    if pvar.ndim == 1 or pvar.shape[0] == 1:
        pvar = pvar.reshape(-1, 4)[:1]
    pvar = pvar.expand(r, 4)
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    px = prior[:, 0] + pw * 0.5
    py = prior[:, 1] + ph * 0.5
    t = target.reshape(r, c, 4)
    bound = clip if clip else 1e9
    dx = t[:, :, 0] * pvar[:, None, 0]
    dy = t[:, :, 1] * pvar[:, None, 1]
    dw = (t[:, :, 2] * pvar[:, None, 2]).clamp(-bound, bound)
    dh = (t[:, :, 3] * pvar[:, None, 3]).clamp(-bound, bound)
    cx = dx * pw[:, None] + px[:, None]
    cy = dy * ph[:, None] + py[:, None]
    w = torch.exp(dw) * pw[:, None]
    h = torch.exp(dh) * ph[:, None]
    decoded = torch.stack([cx - w * 0.5, cy - h * 0.5,
                           cx + w * 0.5 - 1.0, cy + h * 0.5 - 1.0], dim=-1)
    best = torch.argmax(score[:, 1:], dim=1) + 1
    assigned = decoded[torch.arange(r, device=prior.device), best]
    return {"DecodeBox": [decoded.reshape(r, c * 4)],
            "OutputAssignBox": [assigned]}
