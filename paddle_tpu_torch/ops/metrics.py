"""Metric ops: ``accuracy``, ``auc`` and ``precision_recall``, the torch
lowerings of ``paddle_tpu/ops/metrics.py:11-104`` (Fluid's
operators/metrics/). The streaming ops thread their state through their
outputs (StatPosOut, AccumStatesInfo), as JAX's do."""

from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("accuracy", inputs=("Out", "Indices", "Label"),
             outputs=("Accuracy", "Correct", "Total"), stop_gradient=True)
def _accuracy(ctx, op, ins):
    """Indices [N, k] are the top-k classes, Label [N, 1]: a row is
    correct when its label is among them. Accuracy float32 [1], Correct
    and Total int32 [1]."""
    idx, label = ins["Indices"][0], ins["Label"][0]
    if label.dim() == 1:
        label = label[:, None]
    correct = torch.sum(torch.any(idx == label, dim=1).to(torch.int32))
    total = torch.full((1,), idx.shape[0], dtype=torch.int32,
                       device=idx.device)
    acc = correct.float() / total.float()
    return {"Accuracy": [acc.reshape(1)], "Correct": [correct.reshape(1)],
            "Total": [total]}


@register_op("auc", inputs=("Predict", "Label", "StatPos", "StatNeg"),
             outputs=("AUC", "StatPosOut", "StatNegOut"), stop_gradient=True)
def _auc(ctx, op, ins):
    """``paddle_tpu/ops/metrics.py:32`` (auc_op.h): the positive score
    (column 1 of a [N, 2] Predict) bucketed into ``num_thresholds`` + 1
    bins added to StatPos / StatNeg (the carried state), and the ROC area
    by the trapezoid rule walking the bins from the top."""
    pred, label = ins["Predict"][0], ins["Label"][0]
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    nt = stat_pos.shape[-1] - 1
    pos_score = (pred[:, 1] if pred.dim() == 2 and pred.shape[1] == 2
                 else pred.reshape(-1))
    lbl = label.reshape(-1).to(torch.float32)
    bucket = torch.clamp((pos_score * nt).to(torch.int32), 0, nt).long()
    sp = stat_pos.reshape(-1).index_add(0, bucket, lbl.to(stat_pos.dtype))
    sn = stat_neg.reshape(-1).index_add(0, bucket,
                                        (1.0 - lbl).to(stat_neg.dtype))
    tp = torch.cumsum(torch.flip(sp, (0,)), 0)
    fp = torch.cumsum(torch.flip(sn, (0,)), 0)
    zero = tp.new_zeros(1)
    tp_prev = torch.cat([zero, tp[:-1]])
    fp_prev = torch.cat([zero, fp[:-1]])
    area = torch.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
    denom = tp[-1] * fp[-1]
    auc = torch.where(denom > 0, area / torch.clamp(denom, min=1.0),
                      torch.zeros((), dtype=area.dtype, device=area.device))
    return {"AUC": [auc.reshape(())],
            "StatPosOut": [sp.reshape(stat_pos.shape)],
            "StatNegOut": [sn.reshape(stat_neg.shape)]}


def _pr_metrics(st):
    """Macro precision, recall and F1, then their micro forms, from [C,
    4] states (tp, fp, tn, fn); a class with no prediction (or no label)
    has precision (recall) 1."""
    tp, fp, fn = st[:, 0], st[:, 1], st[:, 3]
    one = torch.ones((), dtype=st.dtype, device=st.device)
    zero = torch.zeros((), dtype=st.dtype, device=st.device)
    prec = torch.where(tp + fp > 0, tp / torch.clamp(tp + fp, min=1.0), one)
    rec = torch.where(tp + fn > 0, tp / torch.clamp(tp + fn, min=1.0), one)
    f1 = torch.where(prec + rec > 0, 2 * prec * rec / torch.clamp(
        prec + rec, min=1e-6), zero)
    micro_p = torch.sum(tp) / torch.clamp(torch.sum(tp + fp), min=1.0)
    micro_r = torch.sum(tp) / torch.clamp(torch.sum(tp + fn), min=1.0)
    micro_f = 2 * micro_p * micro_r / torch.clamp(micro_p + micro_r,
                                                  min=1e-6)
    return torch.stack([torch.mean(prec), torch.mean(rec), torch.mean(f1),
                        micro_p, micro_r, micro_f])


@register_op("precision_recall",
             inputs=("MaxProbs", "Indices", "Labels", "Weights",
                     "StatesInfo"),
             outputs=("BatchMetrics", "AccumMetrics", "AccumStatesInfo"),
             stop_gradient=True)
def _precision_recall(ctx, op, ins):
    """:68 (precision_recall_op.h): the batch's per-class (tp, fp, tn,
    fn) from the predicted Indices and Labels, added to StatesInfo (the
    carried state), and the six metrics of each. Weights and MaxProbs
    are not read, as in JAX."""
    idx = ins["Indices"][0].reshape(-1).long()
    labels = ins["Labels"][0].reshape(-1).long()
    cls = int(op.attrs["class_number"])
    dev = idx.device
    states = (ins["StatesInfo"][0] if ins.get("StatesInfo")
              else torch.zeros((cls, 4), device=dev))
    eye = torch.eye(cls, device=dev)
    oh_pred, oh_lbl = eye[idx], eye[labels]
    tp = torch.sum(oh_pred * oh_lbl, dim=0)
    fp = torch.sum(oh_pred * (1 - oh_lbl), dim=0)
    fn = torch.sum((1 - oh_pred) * oh_lbl, dim=0)
    tn = torch.sum((1 - oh_pred) * (1 - oh_lbl), dim=0)
    batch = torch.stack([tp, fp, tn, fn], dim=1)
    acc = states + batch
    return {"BatchMetrics": [_pr_metrics(batch)],
            "AccumMetrics": [_pr_metrics(acc)],
            "AccumStatesInfo": [acc]}
