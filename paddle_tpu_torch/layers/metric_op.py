"""Metric layers: ``accuracy``, the port's copy of
``paddle_tpu/layers/metric_op.py:9`` (Fluid's layers/metric_op.py)."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import _out, topk

__all__ = ["accuracy"]


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    _, idx = topk(input, k)
    acc = _out(helper, input, shape=(1,), stop_gradient=True)
    correct = correct or _out(helper, input, shape=(1,), dtype="int32", stop_gradient=True)
    total = total or _out(helper, input, shape=(1,), dtype="int32", stop_gradient=True)
    helper.append_op(
        type="accuracy",
        inputs={"Out": [input], "Indices": [idx], "Label": [label]},
        outputs={"Accuracy": [acc], "Correct": [correct], "Total": [total]},
    )
    return acc
