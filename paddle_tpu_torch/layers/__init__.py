"""Layer functions that append ops to the default main program: the
port's ``paddle_tpu/layers/``."""

from .control_flow import *  # noqa: F401,F403
from .detection import box_coder, iou_similarity, prior_box
from .extras import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .io import data
from .learning_rate_scheduler import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .py_func_registry import py_func
from . import ops  # noqa: F401
from . import distributions  # noqa: F401

from .auto import *  # noqa: F401,F403
