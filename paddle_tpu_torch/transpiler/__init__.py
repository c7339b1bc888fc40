"""Program transpilers: the collective ones (``collective.py``,
GradAllReduce and LocalSGD). The parameter-server transpilers
(``DistributeTranspiler``, ``GeoSgdTranspiler``) are ROADMAP A11."""

from .collective import (Collective, GradAllReduce, LocalSGD,
                         SingleProcessMultiThread)

__all__ = ["Collective", "GradAllReduce", "LocalSGD",
           "SingleProcessMultiThread"]
