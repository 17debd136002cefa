"""Host-side op handlers that need concrete values: the port's counterpart
of ``paddle_tpu/fluid/host_ops.py``. It holds the ``detection_map`` host
op (the reference's detection_map_op.cc, a CPU-only kernel: the VOC mAP
matches detections to ground truth one by one) and its helpers, which
``fluid.metrics.DetectionMAP`` reads too. The handler reads its inputs
back from the card, runs on the host between the device ops, as the JAX
executor runs it between its segments, and puts its outputs on the
executor's device.
"""
import numpy as np
import torch

from .executor import as_numpy, register_host_handler


def _get(st, name):
    v = st.env.get(name)
    if v is None:
        v = st.scope.get(name)
    return as_numpy(v)


def _voc_ap(tp, conf, n_gt, ap_type="11point"):
    order = np.argsort(-conf)
    tp = tp[order]
    fp = 1 - tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    rec = tp_cum / max(n_gt, 1)
    prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    if ap_type == "11point":
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = prec[rec >= t].max() if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return ap
    # integral
    mrec = np.concatenate([[0], rec, [1]])
    mpre = np.concatenate([[0], prec, [0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _detection_batch_stats(det, gt, thresh, eval_difficult):
    """Per-class match stats for one batch: {cls: (n_gt, [(score, tp)])}."""
    stats = {}
    classes = set(int(c) for c in np.unique(gt[..., 0]) if c >= 0)
    for cls in sorted(classes):
        marks, n_gt = [], 0
        for b in range(det.shape[0]):
            g = gt[b]
            gmask = (g[:, 0] == cls)
            # difficult boxes stay in the match pool but count for nothing:
            # a detection matching one is neither a tp nor an fp (the VOC
            # protocol, reference detection_map_op.h)
            difficult = (g[gmask][:, 5] != 0) if (not eval_difficult and
                                                  g.shape[1] > 5) \
                else np.zeros(int(gmask.sum()), bool)
            gboxes = g[gmask][:, 1:5]
            n_gt += int((~difficult).sum())
            d = det[b]
            d = d[d[:, 0] == cls]
            used = np.zeros(gboxes.shape[0], bool)
            for row in d[np.argsort(-d[:, 1])]:
                if gboxes.shape[0] == 0:
                    marks.append((float(row[1]), 0.0))
                    continue
                x1 = np.maximum(gboxes[:, 0], row[2])
                y1 = np.maximum(gboxes[:, 1], row[3])
                x2 = np.minimum(gboxes[:, 2], row[4])
                y2 = np.minimum(gboxes[:, 3], row[5])
                inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
                a1 = (row[4] - row[2]) * (row[5] - row[3])
                a2 = (gboxes[:, 2] - gboxes[:, 0]) * \
                    (gboxes[:, 3] - gboxes[:, 1])
                iou = inter / np.maximum(a1 + a2 - inter, 1e-12)
                j = int(np.argmax(iou))
                if iou[j] >= thresh:
                    if difficult[j]:
                        continue             # ignored, not tp or fp
                    if not used[j]:
                        used[j] = True
                        marks.append((float(row[1]), 1.0))
                    else:
                        marks.append((float(row[1]), 0.0))
                else:
                    marks.append((float(row[1]), 0.0))
        stats[cls] = (n_gt, marks)
    return stats


def _map_from_stats(stats, ap_type):
    aps = []
    for cls in sorted(stats):
        n_gt, marks = stats[cls]
        if n_gt == 0:
            continue
        confs = np.asarray([m[0] for m in marks])
        tps = np.asarray([m[1] for m in marks])
        aps.append(_voc_ap(tps, confs, n_gt, ap_type))
    return float(np.mean(aps)) if aps else 0.0


@register_host_handler("detection_map")
def _handle_detection_map(exe, op, st):
    """VOC mAP (detection_map_op.h). Dense layout: DetectRes [B, N, 6]
    (label, score, x1, y1, x2, y2; label < 0 = padding), Label [B, M, 6]
    (label, x1, y1, x2, y2, difficult; label < 0 = padding).

    Accumulation (the evaluator path): with PosCount/TruePos/FalsePos
    inputs and HasState set, this batch's stats merge with the carried
    state, which the op writes back to the scope (it persists across
    runs). State layout: PosCount [C, 2] float32 rows (class, n_gt);
    TruePos/FalsePos [K, 2] float32 rows (class, score)."""
    det = _get(st, op.input("DetectRes")[0])
    gt = _get(st, op.input("Label")[0])
    thresh = op.attr("overlap_threshold", 0.5)
    eval_difficult = op.attr("evaluate_difficult", True)
    ap_type = op.attr("ap_type", "integral")
    if det.ndim == 2:
        det = det[None]
        gt = gt[None]
    stats = _detection_batch_stats(det, gt, thresh, eval_difficult)

    if op.input("PosCount"):
        has_state = 0
        if op.input("HasState"):
            has_state = int(_get(st, op.input("HasState")[0]).reshape(-1)[0])
        if has_state:
            pos = _get(st, op.input("PosCount")[0]).reshape(-1, 2)
            tp = _get(st, op.input("TruePos")[0]).reshape(-1, 2)
            fp = _get(st, op.input("FalsePos")[0]).reshape(-1, 2)
            for cls, n in pos:
                cls = int(cls)
                n_gt, marks = stats.get(cls, (0, []))
                stats[cls] = (n_gt + int(n), marks)
            for cls, score in tp:
                stats.setdefault(int(cls), (0, []))[1].append(
                    (float(score), 1.0))
            for cls, score in fp:
                stats.setdefault(int(cls), (0, []))[1].append(
                    (float(score), 0.0))
        pos_out = np.asarray([[c, stats[c][0]] for c in sorted(stats)],
                             np.float32).reshape(-1, 2)
        tp_out = np.asarray([[c, s] for c in sorted(stats)
                             for s, flag in stats[c][1] if flag],
                            np.float32).reshape(-1, 2)
        fp_out = np.asarray([[c, s] for c in sorted(stats)
                             for s, flag in stats[c][1] if not flag],
                            np.float32).reshape(-1, 2)
        for slot, val in (("AccumPosCount", pos_out),
                          ("AccumTruePos", tp_out),
                          ("AccumFalsePos", fp_out)):
            if op.output(slot):
                name = op.output(slot)[0]
                val = torch.from_numpy(val).to(exe.device)
                st.env[name] = val
                st.scope.set(name, val)

    m = _map_from_stats(stats, ap_type)
    st.env[op.output("MAP")[0]] = torch.tensor([m], dtype=torch.float32,
                                               device=exe.device)
