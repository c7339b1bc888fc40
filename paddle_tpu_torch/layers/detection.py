"""Detection layer wrappers: the port's copy of
``paddle_tpu/layers/detection.py`` (reference
python/paddle/fluid/layers/detection.py); the other detection layers
are rows of ``layers/auto.py``."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import _out

__all__ = ["iou_similarity", "box_coder", "prior_box"]


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    n = x.shape[0] if x.shape else -1
    m = y.shape[0] if y.shape else -1
    out = _out(helper, x, shape=(n, m))
    helper.append_op(type="iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, name=None,
              axis=0):
    helper = LayerHelper("box_coder", name=name)
    out = _out(helper, target_box, shape=target_box.shape)
    inputs = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    if prior_box_var is not None and hasattr(prior_box_var, "name"):
        inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op(type="box_coder", inputs=inputs,
                     outputs={"OutputBox": [out]},
                     attrs={"code_type": code_type,
                            "box_normalized": box_normalized, "axis": axis})
    return out


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    """Boxes and variances [H, W, priors, 4]; their Variables carry the
    input's shape, as JAX's (``_out`` with no shape)."""
    helper = LayerHelper("prior_box", name=name)
    boxes = _out(helper, input, shape=None, stop_gradient=True)
    variances = _out(helper, input, shape=None, stop_gradient=True)
    helper.append_op(
        type="prior_box", inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [variances]},
        attrs={"min_sizes": list(min_sizes),
               "max_sizes": list(max_sizes or []),
               "aspect_ratios": list(aspect_ratios),
               "variances": list(variance), "flip": flip, "clip": clip,
               "offset": offset})
    return boxes, variances
