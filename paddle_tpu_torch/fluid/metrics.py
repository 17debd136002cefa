"""Python-side metric accumulators (the port's counterpart of
``paddle_tpu/fluid/metrics.py``; reference: python/paddle/fluid/metrics.py):
MetricBase, CompositeMetric, Precision, Recall, Accuracy, ChunkEvaluator,
EditDistance, Auc and DetectionMAP, each host-side numpy state fed from
fetched outputs (numpy arrays, or tensors on any device)."""
import numpy as np

from .executor import as_numpy
from .host_ops import _detection_batch_stats, _map_from_stats

__all__ = ["MetricBase", "CompositeMetric", "Precision", "Recall", "Accuracy",
           "ChunkEvaluator", "EditDistance", "Auc", "DetectionMAP"]


class MetricBase(object):
    def __init__(self, name):
        self._name = str(name) if name is not None else self.__class__.__name__

    def __str__(self):
        return self._name

    def reset(self):
        for attr, value in self.__dict__.items():
            if attr.startswith("_"):
                continue
            if isinstance(value, int):
                setattr(self, attr, 0)
            elif isinstance(value, float):
                setattr(self, attr, 0.0)
            elif isinstance(value, (np.ndarray,)):
                setattr(self, attr, np.zeros_like(value))
            elif isinstance(value, list):
                setattr(self, attr, [])

    def update(self, preds, labels):
        raise NotImplementedError()

    def eval(self):
        raise NotImplementedError()


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super(CompositeMetric, self).__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, MetricBase):
            raise TypeError("add_metric expects a MetricBase")
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    def __init__(self, name=None):
        super(Precision, self).__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(as_numpy(preds)).astype(np.int64).reshape(-1)
        labels = as_numpy(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap != 0 else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super(Recall, self).__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(as_numpy(preds)).astype(np.int64).reshape(-1)
        labels = as_numpy(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        recall = self.tp + self.fn
        return float(self.tp) / recall if recall != 0 else 0.0


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super(Accuracy, self).__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(as_numpy(value).reshape(())) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("Accuracy has no accumulated data")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super(ChunkEvaluator, self).__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(as_numpy(num_infer_chunks).reshape(()))
        self.num_label_chunks += int(as_numpy(num_label_chunks).reshape(()))
        self.num_correct_chunks += int(
            as_numpy(num_correct_chunks).reshape(()))

    def eval(self):
        precision = float(self.num_correct_chunks) / self.num_infer_chunks \
            if self.num_infer_chunks else 0.0
        recall = float(self.num_correct_chunks) / self.num_label_chunks \
            if self.num_label_chunks else 0.0
        f1 = 2 * precision * recall / (precision + recall) \
            if self.num_correct_chunks else 0.0
        return precision, recall, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super(EditDistance, self).__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = as_numpy(distances)
        self.total_distance += float(np.sum(distances))
        self.seq_num += int(as_numpy(seq_num))
        self.instance_error += int(np.sum(distances != 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("EditDistance has no accumulated data")
        return (self.total_distance / self.seq_num,
                float(self.instance_error) / self.seq_num)


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super(Auc, self).__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1, dtype=np.int64)
        self._stat_neg = np.zeros(num_thresholds + 1, dtype=np.int64)

    def update(self, preds, labels):
        preds = as_numpy(preds)
        labels = as_numpy(labels).reshape(-1)
        pos_prob = preds[:, -1] if preds.ndim == 2 else preds.reshape(-1)
        bucket = np.clip((pos_prob * self._num_thresholds).astype(np.int64),
                         0, self._num_thresholds)
        for b, l in zip(bucket, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def eval(self):
        tot_pos = np.cumsum(self._stat_pos[::-1])[::-1].astype(np.float64)
        area = float(np.sum(self._stat_neg *
                            (tot_pos - self._stat_pos / 2.0)))
        denom = float(self._stat_pos.sum()) * float(self._stat_neg.sum())
        return area / denom if denom > 0 else 0.0


class DetectionMAP(object):
    """Host-side VOC mAP accumulator (reference metrics.py DetectionMAP):
    update() takes the fetched detections and ground truth, eval() returns
    the mAP accumulated so far. The in-program accumulating variant is
    evaluator.DetectionMAP over the detection_map op's state slots.

    Layouts match the detection_map host op: detections [B, N, 6]
    (label, score, x1, y1, x2, y2; label < 0 = padding), ground truth
    [B, M, 5/6] (label, x1, y1, x2, y2[, difficult])."""

    def __init__(self, overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version="integral"):
        if ap_version not in ("integral", "11point"):
            raise ValueError("ap_version must be integral or 11point")
        self.overlap_threshold = overlap_threshold
        self.evaluate_difficult = evaluate_difficult
        self.ap_version = ap_version
        self.reset()

    def reset(self):
        self._stats = {}

    def update(self, detections, gt):
        det = as_numpy(detections).astype("float32")
        gt = as_numpy(gt).astype("float32")
        if det.ndim == 2:
            det = det[None]
            gt = gt[None]
        batch = _detection_batch_stats(det, gt, self.overlap_threshold,
                                       self.evaluate_difficult)
        for cls, (n_gt, marks) in batch.items():
            old_n, old_marks = self._stats.get(cls, (0, []))
            self._stats[cls] = (old_n + n_gt, old_marks + marks)

    def eval(self):
        return _map_from_stats(self._stats, self.ap_version)
