"""Device places (reference platform/place.h: CPUPlace, CUDAPlace).

The JAX package's places pick a JAX backend; the port's pick a torch
device. ``CUDAPlace`` raises when there is no GPU instead of moving to
the CPU: the CPU runs only where a caller names ``CPUPlace()``.
"""

from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["Place", "CPUPlace", "CUDAPlace"]


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
