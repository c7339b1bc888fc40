"""Loss layers: the port's copies of ``softmax_with_cross_entropy``,
``square_error_cost`` and ``sigmoid_cross_entropy_with_logits`` of
``paddle_tpu/layers/loss.py``."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import _out

__all__ = ["softmax_with_cross_entropy", "square_error_cost",
           "sigmoid_cross_entropy_with_logits"]


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


def square_error_cost(input, label):
    """(input - label)^2 (``paddle_tpu/layers/loss.py:67``)."""
    from .nn import elementwise_sub, square

    return square(elementwise_sub(input, label))


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits")
    out = _out(helper, x, shape=x.shape)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x], "Label": [label]},
        outputs={"Out": [out]},
        attrs={"ignore_index": ignore_index, "normalize": normalize},
    )
    return out
