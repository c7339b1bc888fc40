"""Serving-layer errors shared by the generation engine.

``ServingEngine`` and the HTTP front end are later slices of the port.
"""

from .engine import (DeadlineExceeded, EngineClosed, Overloaded,
                     RequestCancelled, ServingError)
from .metrics import StreamingHistogram

__all__ = ["ServingError", "Overloaded", "DeadlineExceeded", "EngineClosed",
           "RequestCancelled", "StreamingHistogram"]
