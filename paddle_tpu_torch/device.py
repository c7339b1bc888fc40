"""Device resolution for the port's entry points.

The JAX package places work through ``TPUPlace`` and its backend; the
port takes an explicit torch ``device``. The default is CUDA, and a
missing GPU is an error, never a silent move to the CPU: the CPU runs
only where a caller (a test, say) asks for it by name.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["concrete_device", "resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``. Raises ``RuntimeError`` when a CUDA
    device is asked for (explicitly or by default) and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev


def concrete_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` with its index, as a tensor's ``.device`` gives it:
    ``"cuda"`` names the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
