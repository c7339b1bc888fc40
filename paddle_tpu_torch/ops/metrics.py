"""Metric ops: ``accuracy``, the torch lowering of
``paddle_tpu/ops/metrics.py:11`` (Fluid's operators/metrics/accuracy_op)."""

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
