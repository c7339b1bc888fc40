"""``layers.ops``: the activation layers under the module name of
``paddle_tpu/layers/ops.py`` (Fluid's autogenerated layers/ops.py)."""

from .nn import (  # noqa: F401
    abs,
    ceil,
    cos,
    exp,
    floor,
    hard_shrink,
    logsigmoid,
    reciprocal,
    round,
    rsqrt,
    sigmoid,
    sin,
    softplus,
    softsign,
    sqrt,
    square,
    tanh,
    thresholded_relu,
)
