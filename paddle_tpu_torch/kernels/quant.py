"""Blockwise int8 quantization helpers (a copy in torch of
``paddle_tpu/kernels/quant.py``; no kernel: the JAX functions are
``jnp`` too).

The unit is a BLOCK of consecutive elements sharing one float32 scale,
``max|x| / 127`` (1.0 for an all-zero block so dequantizing never
divides by zero). The int8 KV pages use it with one block per
``[head_dim]`` row (``quantized_kv_cache_write``); the tests gate the
quantized attention on ``blockwise_error_bound``. ``quantized_mean``
is the int8 form of a data-parallel gradient bucket's mean
(``collective_bucket_reduce`` with ``quantization="int8"``): the
EQuARX two-shot exchange over a process group (``parallel/comm.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["blockwise_quantize", "blockwise_dequantize",
           "blockwise_error_bound", "quantized_mean",
           "quantized_payload_bytes"]

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


def quantized_mean(x: torch.Tensor, group, block: int,
                   exchange: bool = True) -> torch.Tensor:
    """Two-shot blockwise-int8 mean of ``x`` over the ranks of
    ``group`` (``paddle_tpu/kernels/quant.py:66``):

      1. every rank quantizes its own value blockwise, and an all-to-all
         delivers rank r chunk r of every rank's int8 blocks and scales;
         rank r dequantizes and averages its chunk in float32;
      2. the averaged chunk is quantized again, an all-gather hands every
         rank every chunk, and each dequantizes all of them, its own
         included, so the result is the same bits on every rank.

    ``exchange=False`` is the psum form: the same quantize, mean and
    requantize, with the exchange an all-reduce of the dequantized
    payload. With no group (or a group of one) the blocks still
    round-trip, as the JAX function does at an axis of size 1."""
    from ..parallel import comm

    n = comm.group_size(group)
    shape, dtype = x.shape, x.dtype
    flat = x.float().reshape(-1)
    m = flat.shape[0]
    nb = -(-m // block)
    nb = -(-nb // n) * n
    pad = nb * block - m
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    q, s = blockwise_quantize(flat.reshape(nb, block))
    size = torch.full((), float(n), dtype=torch.float32, device=x.device)
    if exchange:
        qx = comm.all_to_all(q, group)
        sx = comm.all_to_all(s, group)
        chunk = nb // n
        reduced = blockwise_dequantize(qx.reshape(n, chunk, block),
                                       sx.reshape(n, chunk)).sum(0) / size
        q2, s2 = blockwise_quantize(reduced)
        qg = comm.all_gather(q2, group)
        sg = comm.all_gather(s2, group)
        out = blockwise_dequantize(qg, sg).reshape(nb * block)
    else:
        deq = blockwise_dequantize(q, s)
        comm.all_reduce(deq, group=group)
        q2, s2 = blockwise_quantize(deq / size)
        out = blockwise_dequantize(q2, s2).reshape(nb * block)
    if pad:
        out = out[:m]
    return out.reshape(shape).to(dtype)


def quantized_payload_bytes(numel: int, block: int) -> int:
    """Wire payload of one quantized exchange direction for ``numel``
    elements: the int8 body and one float32 scale a block, padding
    included."""
    nb = -(-numel // block)
    return nb * block + 4 * nb
