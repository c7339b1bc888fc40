from . import utils  # noqa: F401
