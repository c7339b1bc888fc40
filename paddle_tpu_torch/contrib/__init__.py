"""Contrib: the part of ``paddle_tpu/contrib/`` the port has: mixed
precision (AMP), the quantization-aware training passes of slim, the
RNN stacks and cells of ``layers/rnn_impl.py`` and the beam search
decoder."""

from . import decoder, layers, mixed_precision, slim  # noqa: F401
from .mixed_precision import (AutoMixedPrecisionLists,  # noqa: F401
                              OptimizerWithMixedPrecision, decorate)
