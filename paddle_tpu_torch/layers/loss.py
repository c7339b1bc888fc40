"""Loss layers: the port's copies of the layers of
``paddle_tpu/layers/loss.py`` (Fluid's layers/nn.py loss section)."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import _out

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "square_error_cost",
           "sigmoid_cross_entropy_with_logits", "log_loss", "huber_loss",
           "smooth_l1", "kldiv_loss", "mse_loss"]


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """``paddle_tpu/layers/loss.py:23``: over probabilities, a trailing
    1."""
    helper = LayerHelper("cross_entropy")
    shp = tuple(input.shape[:-1] or ()) + (1,)
    out = _out(helper, input, shape=shp)
    helper.append_op(
        type="cross_entropy",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out


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


def mse_loss(input, label):
    """:74: the mean of ``square_error_cost``."""
    from .nn import mean

    return mean(square_error_cost(input, label))


def log_loss(input, label, epsilon=1e-4):
    """:92."""
    helper = LayerHelper("log_loss")
    out = _out(helper, input, shape=input.shape)
    helper.append_op(
        type="log_loss",
        inputs={"Predicted": [input], "Labels": [label]},
        outputs={"Loss": [out]},
        attrs={"epsilon": epsilon},
    )
    return out


def huber_loss(input, label, delta):
    """:104."""
    helper = LayerHelper("huber_loss")
    out = _out(helper, input, shape=input.shape)
    residual = _out(helper, input, shape=input.shape, stop_gradient=True)
    helper.append_op(
        type="huber_loss",
        inputs={"X": [input], "Y": [label]},
        outputs={"Out": [out], "Residual": [residual]},
        attrs={"delta": delta},
    )
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    """:117: a row's loss, [N, 1]."""
    helper = LayerHelper("smooth_l1_loss")
    out = _out(helper, x, shape=(x.shape[0] if x.shape else -1, 1))
    diff = _out(helper, x, shape=x.shape, stop_gradient=True)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(
        type="smooth_l1_loss",
        inputs=inputs,
        outputs={"Out": [out], "Diff": [diff]},
        attrs={"sigma": sigma or 1.0},
    )
    return out


def kldiv_loss(x, target, reduction="mean", name=None):
    """:135: a 0-dim loss unless ``reduction`` is "none"."""
    helper = LayerHelper("kldiv_loss", name=name)
    shp = () if reduction in ("mean", "sum", "batchmean") else x.shape
    out = _out(helper, x, shape=shp)
    helper.append_op(
        type="kldiv_loss",
        inputs={"X": [x], "Target": [target]},
        outputs={"Loss": [out]},
        attrs={"reduction": reduction},
    )
    return out
