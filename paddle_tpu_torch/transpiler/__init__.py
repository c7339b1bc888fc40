"""Program transpilers: the collective ones (``collective.py``,
GradAllReduce and LocalSGD), the parameter server's
(``DistributeTranspiler`` in pserver mode over ``ps/``, and
``GeoSgdTranspiler``) and the NCHW -> NHWC layout pass ``auto_nhwc``
(``layout.py``)."""

from .collective import (Collective, GradAllReduce, LocalSGD,
                         SingleProcessMultiThread)
from .distribute_transpiler import (DistributeTranspiler,
                                    DistributeTranspilerConfig)
from .geo_sgd_transpiler import GeoSgdTranspiler
from .layout import auto_nhwc

__all__ = ["Collective", "GradAllReduce", "LocalSGD",
           "SingleProcessMultiThread", "DistributeTranspiler",
           "DistributeTranspilerConfig", "GeoSgdTranspiler", "auto_nhwc"]
