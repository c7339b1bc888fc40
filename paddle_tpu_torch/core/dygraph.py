"""Imperative (dygraph) mode: the flag and the eager device.

The port's counterpart of ``paddle_tpu/core/dygraph.py``. The JAX
package only tracks the flag (JAX places arrays itself); the port also
keeps the torch device that eager tensors live on, which
``dygraph_guard(place)`` / ``enable_dygraph(place)`` set. ``place=None``
means ``CUDAPlace(0)``, which raises when there is no GPU: the CPU runs
only where a caller names ``CPUPlace()``. The full layer library is
``paddle_tpu_torch/dygraph/``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_in_dygraph = False
_device: Optional[torch.device] = None
# the parameter generator of the current mode: made at its first draw
# from the default startup program's random_seed, dropped on each entry
_param_generator: Optional[torch.Generator] = None


def in_dygraph_mode() -> bool:
    return _in_dygraph


def place_device(place=None) -> torch.device:
    """The torch device of a place (``CPUPlace()``, ``CUDAPlace(i)``, a
    device string); ``None`` is ``CUDAPlace(0)``."""
    from ..device import resolve_device

    if place is None:
        return resolve_device("cuda:0")
    if hasattr(place, "torch_device"):
        return place.torch_device()
    return resolve_device(place)


def eager_device() -> torch.device:
    """Where eager tensors go: the mode's device, else ``cuda:0`` (which
    raises with no GPU)."""
    return _device if _device is not None else place_device(None)


def _enter(place):
    global _in_dygraph, _device, _param_generator
    dev = place_device(place)
    prev = (_in_dygraph, _device, _param_generator)
    _in_dygraph, _device, _param_generator = True, dev, None
    return prev


def _restore(prev):
    global _in_dygraph, _device, _param_generator
    _in_dygraph, _device, _param_generator = prev


def param_generator() -> torch.Generator:
    """The mode's one generator for parameter initializers, seeded from
    ``default_startup_program().random_seed`` at its first draw and
    advanced by every parameter after."""
    global _param_generator
    if _param_generator is None:
        from .framework import default_startup_program

        dev = eager_device()
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(default_startup_program().random_seed))
        _param_generator = gen
    return _param_generator


@contextlib.contextmanager
def dygraph_guard(place=None):
    prev = _enter(place)
    try:
        yield
    finally:
        _restore(prev)


guard = dygraph_guard


def enable(place=None):
    _enter(place)


def disable():
    global _in_dygraph
    _in_dygraph = False
