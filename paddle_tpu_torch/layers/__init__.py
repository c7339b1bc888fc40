"""Layer functions that append ops to the default main program: the
part of ``paddle_tpu/layers/`` the training paths call."""

from .io import data
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
