"""``flatten``: the port's copy of the one op of
``paddle_tpu/ops/misc.py`` (:22) that the everyday layers reach."""

from __future__ import annotations

import math

from ..core.registry import register_op


@register_op("flatten", inputs=("X",), outputs=("Out",))
def _flatten(ctx, op, ins):
    """Fluid's flatten_op.cc: the dims before ``axis`` into one, the
    rest into the other (``flatten2`` without the XShape slot)."""
    x = ins["X"][0]
    axis = int(op.attrs.get("axis", 1))
    lead = math.prod(x.shape[:axis]) if axis else 1
    return {"Out": [x.reshape(lead, -1)]}
