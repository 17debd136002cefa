"""Metric lowerings: accuracy, auc, precision_recall and mean_iou (the
port's counterpart of ``paddle_tpu/fluid/ops/metric_ops.py``, all 4 of its
lowerings).

precision_recall and mean_iou count by ``index_add`` in float32: the card
adds with atomics in no fixed order, but every addend is 0 or 1, and
counts below 2^24 are exact in float32 in any order, so the counts come
out bit for bit those of any other order. A class id outside [0, n)
counts as JAX's ``.at[ids].add`` counts it: one in [-n, 0) from the end,
any other nowhere (CamVid's void label 11 of 11 classes, say), where a
bare ``index_add`` on the card would stop the process."""
import torch

from .registry import register_lowering
from .common import one


@register_lowering("accuracy", no_grad=True)
def _accuracy(ctx, inputs, attrs):
    """Top-k accuracy from top_k's Indices [N, k] and Label [N, 1]: Correct,
    the rows whose label is among their k indices, and Total, N, as int32
    scalars, and Accuracy = Correct / Total as a float32 scalar. Every
    output stays on the device: N is a fill, not a host copy, so the op
    needs no synchronization."""
    indices, label = one(inputs, "Indices"), one(inputs, "Label")
    label = label.reshape(-1, 1).to(indices.dtype)
    hit = (indices == label).any(dim=1)
    correct = hit.sum(dtype=torch.int32)
    total = indices.shape[0]
    return {"Accuracy": [correct.float() / total],
            "Correct": [correct],
            "Total": [torch.full((), total, dtype=torch.int32,
                                 device=indices.device)]}


@register_lowering("auc", no_grad=True)
def _auc(ctx, inputs, attrs):
    """Streaming ROC AUC over num_thresholds + 1 buckets: the batch's
    positive-class probabilities (the last column of a 2-D Predict) are
    bucketed by floor(p * num_thresholds), clamped; the positives and the
    negatives (label 1 and 0) add into the StatPos and StatNeg histograms,
    and the area under the accumulated curve is sum over buckets of
    neg_i * (positives at or above i - pos_i / 2), over
    max(positives * negatives, 1), in float32."""
    predict, label = one(inputs, "Predict"), one(inputs, "Label")
    stat_pos, stat_neg = one(inputs, "StatPos"), one(inputs, "StatNeg")
    num_thresh = attrs.get("num_thresholds", 4095)
    pos_prob = predict[:, -1] if predict.ndim == 2 else predict.reshape(-1)
    bucket = (pos_prob * num_thresh).long().clamp(0, num_thresh)
    lab = label.reshape(-1).long()
    new_pos = stat_pos.index_add(0, bucket, (lab == 1).to(stat_pos.dtype))
    new_neg = stat_neg.index_add(0, bucket, (lab == 0).to(stat_neg.dtype))
    tot_pos = new_pos.flip(0).cumsum(0).flip(0)
    area = torch.sum(new_neg * (tot_pos - new_pos / 2.0))
    denom = torch.clamp((new_pos.sum() * new_neg.sum()).float(), min=1.0)
    return {"AUC": [(area / denom).float().reshape(())],
            "StatPosOut": [new_pos], "StatNegOut": [new_neg]}


def _class_metrics(s):
    """The macro (mean over classes) and micro (over the summed counts)
    precision, recall and F1 of states [classes, 4] (tp, fp, tn, fn):
    [6] float32."""
    tp, fp, fn = s[:, 0], s[:, 1], s[:, 3]
    prec = torch.where(tp + fp > 0, tp / (tp + fp).clamp(min=1.0), 0.0)
    rec = torch.where(tp + fn > 0, tp / (tp + fn).clamp(min=1.0), 0.0)
    f1 = torch.where(prec + rec > 0, 2 * prec * rec /
                     (prec + rec).clamp(min=1e-12), 0.0)
    tps, fps, fns = tp.sum(), fp.sum(), fn.sum()
    mp = tps / (tps + fps).clamp(min=1.0)
    mr = tps / (tps + fns).clamp(min=1.0)
    mf = 2 * mp * mr / (mp + mr).clamp(min=1e-12)
    return torch.stack([prec.mean(), rec.mean(), f1.mean(), mp, mr, mf])


def _class_counts(n, ids, vals):
    """float32 [n]: the sum of `vals` at each class of `ids`, an id in
    [-n, 0) counted from the end and any other outside [0, n) dropped."""
    ids = torch.where(ids < 0, ids + n, ids)
    inside = (ids >= 0) & (ids < n)
    zeros = torch.zeros((n,), dtype=torch.float32, device=ids.device)
    return zeros.index_add(0, torch.where(inside, ids, 0),
                           torch.where(inside, vals, 0.0))


@register_lowering("precision_recall", no_grad=True)
def _precision_recall(ctx, inputs, attrs):
    """Per-class tp, fp and fn of the top-1 Indices against Labels (tn
    left 0, as the JAX lowering leaves it): BatchMetrics of this batch's
    states, AccumStatesInfo = StatesInfo + them [classes, 4], and
    AccumMetrics of those (macro then micro precision, recall, F1)."""
    indices, labels = one(inputs, "Indices"), one(inputs, "Labels")
    states = one(inputs, "StatesInfo")
    cls_num = attrs["class_number"]
    idx = indices.reshape(-1).long()
    lab = labels.reshape(-1).long()
    hit = (idx == lab).float()
    tp = _class_counts(cls_num, lab, hit)
    fp = _class_counts(cls_num, idx, 1.0 - hit)
    fn = _class_counts(cls_num, lab, 1.0 - hit)
    batch = torch.stack([tp, fp, torch.zeros_like(tp), fn], dim=1)
    accum = batch if states is None else states + batch
    return {"BatchMetrics": [_class_metrics(batch)],
            "AccumMetrics": [_class_metrics(accum)],
            "AccumStatesInfo": [accum]}


@register_lowering("mean_iou", no_grad=True)
def _mean_iou(ctx, inputs, attrs):
    """The mean over the classes present in Predictions or Labels of
    intersection / union (OutMeanIou, a float32 scalar); OutWrong (the
    predictions of each class that miss) and OutCorrect (those that hit)
    as int32 [num_classes]."""
    pred, label = one(inputs, "Predictions"), one(inputs, "Labels")
    n = attrs["num_classes"]
    p = pred.reshape(-1).long()
    lab = label.reshape(-1).long()
    ones = torch.ones(p.shape, dtype=torch.float32, device=pred.device)
    inter = _class_counts(n, lab, (p == lab).float())
    pred_cnt = _class_counts(n, p, ones)
    lab_cnt = _class_counts(n, lab, ones)
    union = pred_cnt + lab_cnt - inter
    valid = union > 0
    iou = torch.where(valid, inter / union.clamp(min=1.0), 0.0)
    miou = iou.sum() / valid.float().sum().clamp(min=1.0)
    return {"OutMeanIou": [miou], "OutWrong": [(pred_cnt - inter).int()],
            "OutCorrect": [inter.int()]}
