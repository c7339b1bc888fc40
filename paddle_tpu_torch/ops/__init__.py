"""Op lowerings of the port: importing this package registers them with
``core/registry.py``. Each module mirrors the JAX package's module of
the same name."""

from . import (beam, collective, control, detection,  # noqa: F401
               detection2, fused, lod, loss_ext, math, metrics, misc, moe,
               nn, optim, persist, quant, random, rnn, sequence, tensor,
               vision3d)
