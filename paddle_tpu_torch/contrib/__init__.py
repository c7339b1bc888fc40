"""Contrib: the part of ``paddle_tpu/contrib/`` the port has, mixed
precision (AMP) and the quantization-aware training passes of slim."""

from . import mixed_precision, slim  # noqa: F401
from .mixed_precision import (AutoMixedPrecisionLists,  # noqa: F401
                              OptimizerWithMixedPrecision, decorate)
