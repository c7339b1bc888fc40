"""Core runtime of the port: program IR, op registry, executor, autodiff.

  - ``framework.py``: the Program IR (a copy of the JAX package's)
  - ``registry.py``: op type -> torch lowering, automatic grads
  - ``executor.py``: Scope and the eager Executor
  - ``backward.py``: ``append_backward`` and its recompute variant
  - ``control_flow.py``: while, conditional_block, recompute segments
  - ``selected_rows.py``: the sparse row-slice gradient
  - ``places.py``: ``CPUPlace``, ``CUDAPlace``
  - ``dygraph.py``: the imperative mode's flag and eager device
"""

from . import framework
from . import registry
from . import places
from . import executor
from . import control_flow
from . import backward
from . import dygraph
