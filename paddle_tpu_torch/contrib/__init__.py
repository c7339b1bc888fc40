"""Contrib: the part of ``paddle_tpu/contrib/`` the port has: mixed
precision (AMP), the quantization-aware training passes of slim, the
RNN stacks and cells of ``layers/rnn_impl.py``, the beam search
decoder, decoupled weight decay (``extend_optimizer``) and the Program
statistics ``memory_usage``, ``summary`` and ``op_freq_statistic``."""

from . import (decoder, extend_optimizer, layers,  # noqa: F401
               memory_usage_calc, mixed_precision, model_stat, op_frequence,
               slim)
from .extend_optimizer import (DecoupledWeightDecay,  # noqa: F401
                               extend_with_decoupled_weight_decay)
from .memory_usage_calc import memory_usage  # noqa: F401
from .model_stat import summary  # noqa: F401
from .op_frequence import op_freq_statistic  # noqa: F401
from .mixed_precision import (AutoMixedPrecisionLists,  # noqa: F401
                              OptimizerWithMixedPrecision, decorate)
