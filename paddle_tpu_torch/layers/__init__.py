"""Layer functions that append ops to the default main program: the
part of ``paddle_tpu/layers/`` the training paths call."""

from .control_flow import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .io import data
from .learning_rate_scheduler import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from . import ops  # noqa: F401
