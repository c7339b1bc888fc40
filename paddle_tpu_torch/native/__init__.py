"""Native (C++) host components of the port, loaded with ctypes: the
MultiSlot datafeed parser (``datafeed``), the port's copy of
``paddle_tpu/native/``."""

from . import datafeed  # noqa: F401
