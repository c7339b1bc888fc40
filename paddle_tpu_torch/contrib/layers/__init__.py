"""fluid.contrib.layers (reference
python/paddle/fluid/contrib/layers/__init__.py): the 11 layers of
``nn.py`` (``fused_elemwise_activation`` among them), the RNN stacks and
cells of ``rnn_impl.py`` and ``metric_op.ctr_metric_bundle``, as the
JAX package's ``paddle_tpu/contrib/layers``."""

from .nn import *  # noqa: F401,F403
from .rnn_impl import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403

from . import metric_op, nn, rnn_impl

__all__ = nn.__all__ + rnn_impl.__all__ + metric_op.__all__
