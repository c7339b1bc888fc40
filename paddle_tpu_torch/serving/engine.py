"""The serving error classes (counterpart of the exception classes of
``paddle_tpu/serving/engine.py``). The dynamic-batching
``ServingEngine`` itself is not ported yet."""

from __future__ import annotations

__all__ = ["ServingError", "Overloaded", "DeadlineExceeded", "EngineClosed",
           "RequestCancelled"]


class ServingError(RuntimeError):
    """Base class for serving-layer failures."""


class Overloaded(ServingError):
    """Admission queue full, or a request that can never fit: the
    request was rejected, not queued."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before it was served."""


class EngineClosed(ServingError):
    """submit() after close(), or queued work failed by a hard close."""


class RequestCancelled(ServingError):
    """The caller cancelled the request."""
