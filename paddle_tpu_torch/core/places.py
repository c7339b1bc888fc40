"""Device places (reference platform/place.h: CPUPlace, CUDAPlace)
and the reference framework.py's place helpers.

The JAX package's places pick a JAX backend; the port's pick a torch
device. ``CUDAPlace`` raises when there is no GPU instead of moving to
the CPU: the CPU runs only where a caller names ``CPUPlace()``. JAX's
``Place.jax_device`` has its counterpart in ``Place.torch_device``, and
JAX's ``TPUPlace`` none: the package refuses it by name, naming
``CUDAPlace``.
"""

from __future__ import annotations

import contextlib

import torch

from ..device import resolve_device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "cpu_places", "cuda_places",
           "cuda_pinned_places", "device_guard", "is_compiled_with_cuda",
           "is_compiled_with_tpu", "TPU_PLACE_REFUSAL"]

TPU_PLACE_REFUSAL = (
    "TPUPlace is the JAX package's TPU device; paddle_tpu_torch runs on "
    "CUDA: use CUDAPlace(i) (or CPUPlace())")


class Place:
    """Base device identity."""

    _device_type = "cpu"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def torch_device(self) -> torch.device:
        if self._device_type == "cpu":
            return resolve_device("cpu")
        return resolve_device(f"cuda:{self.device_id}")


class CPUPlace(Place):
    _device_type = "cpu"

    def __init__(self):
        super().__init__(0)


class CUDAPlace(Place):
    _device_type = "cuda"


def cpu_places(device_count=None):
    """Reference framework.py ``cpu_places``: ``device_count`` host
    places (1 by default, as JAX's)."""
    return [CPUPlace() for _ in range(device_count or 1)]


def cuda_places(device_ids=None):
    """Reference framework.py ``cuda_places``: ``CUDAPlace(i)`` for the
    given ids, or for every visible CUDA device."""
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in device_ids]


def cuda_pinned_places(device_count=None):
    """Host places, as JAX's: the port stages pinned host memory itself
    where it copies a batch to the card (``reader.GeneratorLoader``)."""
    return cpu_places(device_count)


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def is_compiled_with_tpu() -> bool:
    return False


@contextlib.contextmanager
def device_guard(device=None):
    """Reference ``device_guard`` pins the ops built inside it to a
    device. Accepted and does nothing, as JAX's: the port's Executor runs
    every op of a program on its own place."""
    yield
