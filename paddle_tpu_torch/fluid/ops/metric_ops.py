"""Metric lowerings: accuracy and auc (the port's counterpart of
``paddle_tpu/fluid/ops/metric_ops.py``)."""
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
