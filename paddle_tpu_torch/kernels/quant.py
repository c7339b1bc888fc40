"""Blockwise int8 quantization helpers (a copy in torch of
``paddle_tpu/kernels/quant.py:34-64``; no kernel).

The unit is a BLOCK of consecutive elements sharing one float32 scale,
``max|x| / 127`` (1.0 for an all-zero block so dequantizing never
divides by zero). The int8 KV pages use it with one block per
``[head_dim]`` row (``quantized_kv_cache_write``); the tests gate the
quantized attention on ``blockwise_error_bound``. ``quantized_mean``
belongs to the collectives and is not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["blockwise_quantize", "blockwise_dequantize",
           "blockwise_error_bound"]

_QMAX = 127.0


def blockwise_quantize(blocks: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[nb, block] float32 -> (int8 [nb, block], float32 scales [nb]):
    symmetric, round half to even, clipped to [-127, 127]."""
    amax = blocks.abs().amax(dim=-1)
    # divided by a device tensor, not a Python scalar: torch on CUDA
    # would multiply by the reciprocal (one bit off the CPU's division).
    # new_full fills on the device: no host copy, no stream sync
    qmax = amax.new_full((), _QMAX)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(blocks / scale[:, None]), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def blockwise_dequantize(q: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    """int8 [..., nb, block] * float32 scales [..., nb] -> float32."""
    return q.float() * scale[..., None]


def blockwise_error_bound(x, block: int) -> float:
    """Half a quantization step of the worst block, ``max_b scale_b /
    2``: the per-element round-trip error bound of one quantize stage
    (host-side numpy, for tests and checks)."""
    flat = np.asarray(x, dtype=np.float32).reshape(-1)
    m = flat.shape[0]
    nb = -(-m // block)
    flat = np.pad(flat, (0, nb * block - m))
    amax = np.abs(flat.reshape(nb, block)).max(axis=-1)
    scale = np.where(amax > 0, amax / _QMAX, 1.0)
    return float(scale.max() / 2.0)
