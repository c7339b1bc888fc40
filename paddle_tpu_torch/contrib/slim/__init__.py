"""Model compression: the quantization-aware training passes of
``paddle_tpu/contrib/slim/`` (Fluid's contrib/slim/quantization)."""

from . import quantization  # noqa: F401
from .quantization import (QuantizationFreezePass,  # noqa: F401
                           QuantizationTransformPass, quant_aware)
