"""Control-flow layers: the port's copies of ``increment`` and
``less_than`` (``paddle_tpu/layers/control_flow.py:53``, :65), what the
learning-rate schedules emit. ``While``, ``cond``, the tensor arrays
and the other comparisons wait for the sub-block Executor
(``core/control_flow.py``, ROADMAP A1)."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["increment", "less_than"]


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                        shape=x.shape)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def less_than(x, y, force_cpu=None, cond=None):
    helper = LayerHelper("less_than")
    if cond is None:
        cond = helper.create_variable_for_type_inference(
            dtype="bool", shape=x.shape, stop_gradient=True)
    helper.append_op(type="less_than", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond
