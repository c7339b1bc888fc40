"""AMP: the port's copy of ``paddle_tpu/contrib/mixed_precision``
(Fluid's contrib/mixed_precision)."""

from .decorator import OptimizerWithMixedPrecision, decorate  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
