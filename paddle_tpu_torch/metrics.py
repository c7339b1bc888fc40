"""Python-side streaming metrics. Reference:

The port's copy of ``paddle_tpu/metrics.py``: host numpy metrics over
fetched values.
python/paddle/fluid/metrics.py (~1000 LoC: MetricBase, CompositeMetric,
Precision, Recall, Accuracy, ChunkEvaluator, EditDistance, Auc,
DetectionMAP)."""

from __future__ import annotations

import numpy as np

__all__ = [
    "ChunkEvaluator", "DetectionMAP",
    "MetricBase",
    "CompositeMetric",
    "Precision",
    "Recall",
    "Accuracy",
    "Auc",
    "EditDistance",
]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for k, v in self.__dict__.items():
            if k.startswith("_"):
                continue
            if isinstance(v, (int, float)):
                setattr(self, k, 0)
            elif isinstance(v, np.ndarray):
                setattr(self, k, np.zeros_like(v))

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError

    def get_config(self):
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        return self.tp / max(self.tp + self.fp, 1)


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        return self.tp / max(self.tp + self.fn, 1)


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(value) * float(weight)
        self.weight += float(weight)

    def eval(self):
        if self.weight == 0:
            raise ValueError("Accuracy has no accumulated data")
        return self.value / self.weight


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1)
        self._stat_neg = np.zeros(num_thresholds + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        bucket = np.clip(
            (pos_prob * self._num_thresholds).astype(np.int64), 0, self._num_thresholds
        )
        for b, l in zip(bucket, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def eval(self):
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tp_prev = np.concatenate([[0.0], tp[:-1]])
        fp_prev = np.concatenate([[0.0], fp[:-1]])
        area = np.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
        denom = tp[-1] * fp[-1]
        return float(area / denom) if denom > 0 else 0.0


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances).reshape(-1)
        self.total_distance += float(np.sum(distances))
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(distances > 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("EditDistance has no accumulated data")
        return (
            self.total_distance / self.seq_num,
            self.instance_error / self.seq_num,
        )


class ChunkEvaluator(MetricBase):
    """Host-side accumulated chunk P/R/F1 (reference metrics.py
    ChunkEvaluator; feed it the chunk_eval op's count outputs)."""

    def __init__(self, name=None):
        super().__init__(name or "chunk")
        self.reset()

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).sum())
        self.num_label_chunks += int(np.asarray(num_label_chunks).sum())
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).sum())
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if precision + recall else 0.0)
        return precision, recall, f1

    def eval(self):
        return self.update(0, 0, 0)


class DetectionMAP(MetricBase):
    """Host-side streaming mean of per-batch mAP values (reference
    metrics.py DetectionMAP over the detection_map op's MAP output)."""

    def __init__(self, name=None):
        super().__init__(name or "map")
        self.reset()

    def reset(self):
        self._sum = 0.0
        self._count = 0

    def update(self, value, weight=1):
        self._sum += float(np.asarray(value).sum()) * weight
        self._count += weight

    def eval(self):
        if not self._count:
            raise ValueError("DetectionMAP.eval() before any update()")
        return self._sum / self._count
