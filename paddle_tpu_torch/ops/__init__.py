"""Op lowerings of the port: importing this package registers them with
``core/registry.py``. Each module mirrors the JAX package's module of
the same name; only the ops the training path runs are here."""

from . import (collective, control, lod, math, metrics,  # noqa: F401
               misc, moe, nn, optim, quant, random, tensor)
