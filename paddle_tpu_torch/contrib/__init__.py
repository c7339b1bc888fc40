"""Contrib: the part of ``paddle_tpu/contrib/`` the port has, mixed
precision (AMP)."""

from . import mixed_precision  # noqa: F401
from .mixed_precision import (AutoMixedPrecisionLists,  # noqa: F401
                              OptimizerWithMixedPrecision, decorate)
