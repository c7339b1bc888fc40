"""Core runtime of the port: program IR, op registry, executor, autodiff.

  - ``framework.py``: the Program IR (a copy of the JAX package's)
  - ``registry.py``: op type -> torch lowering, automatic grads
  - ``executor.py``: Scope and the eager Executor
  - ``backward.py``: ``append_backward``
  - ``places.py``: ``CPUPlace``, ``CUDAPlace``
"""

from . import framework
from . import registry
from . import places
from . import executor
from . import backward
