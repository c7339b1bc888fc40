"""Metric layers: ``accuracy`` and ``auc``, the port's copies of
``paddle_tpu/layers/metric_op.py`` (Fluid's layers/metric_op.py)."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import _out, topk

__all__ = ["accuracy", "auc"]


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


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """:23: the streaming AUC over two persistable histograms of
    ``num_thresholds`` + 1 bins (zeros at startup), which the op writes
    back each run. Returns (auc, [stat_pos, stat_neg])."""
    from ..initializer import ConstantInitializer

    helper = LayerHelper("auc")
    stat_pos = helper.create_global_variable(
        persistable=True, dtype="float32", shape=[1, num_thresholds + 1])
    stat_neg = helper.create_global_variable(
        persistable=True, dtype="float32", shape=[1, num_thresholds + 1])
    for v in (stat_pos, stat_neg):
        v.persistable = True
        helper.set_variable_initializer(v, ConstantInitializer(0.0))
    auc_out = _out(helper, input, shape=(), stop_gradient=True)
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"curve": curve, "num_thresholds": num_thresholds},
    )
    return auc_out, [stat_pos, stat_neg]
