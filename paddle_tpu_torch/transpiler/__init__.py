"""Program transpilers: the collective ones (``collective.py``,
GradAllReduce and LocalSGD) and the parameter server's
(``DistributeTranspiler`` in pserver mode over ``ps/``, and
``GeoSgdTranspiler``)."""

from .collective import (Collective, GradAllReduce, LocalSGD,
                         SingleProcessMultiThread)
from .distribute_transpiler import (DistributeTranspiler,
                                    DistributeTranspilerConfig)
from .geo_sgd_transpiler import GeoSgdTranspiler

__all__ = ["Collective", "GradAllReduce", "LocalSGD",
           "SingleProcessMultiThread", "DistributeTranspiler",
           "DistributeTranspilerConfig", "GeoSgdTranspiler"]
