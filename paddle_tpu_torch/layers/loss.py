"""Loss layers: the port's copy of ``softmax_with_cross_entropy`` of
``paddle_tpu/layers/loss.py``."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import _out

__all__ = ["softmax_with_cross_entropy"]


def softmax_with_cross_entropy(
    logits,
    label,
    soft_label=False,
    ignore_index=-100,
    numeric_stable_mode=True,
    return_softmax=False,
    axis=-1,
):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = _out(helper, logits, shape=logits.shape)
    loss_shape = list(logits.shape or ())
    if loss_shape:
        loss_shape[axis] = 1
    loss = _out(helper, logits, shape=tuple(loss_shape))
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax], "Loss": [loss]},
        attrs={
            "soft_label": soft_label,
            "ignore_index": ignore_index,
            "numeric_stable_mode": numeric_stable_mode,
            "axis": axis,
        },
    )
    if return_softmax:
        return loss, softmax
    return loss
