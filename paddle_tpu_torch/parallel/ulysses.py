"""Ulysses sequence parallelism: the port's counterpart of
``paddle_tpu/parallel/ulysses.py`` (the DeepSpeed-Ulysses recipe).

One all-to-all over the ``sp`` group turns the sequence-split
[B, H, S/sp, D] layout into a head-split [B, H/sp, S, D] one; each rank
runs whole-sequence attention on its heads through the port's flash
kernels (K6 / K7 forward, K8 / K9 backward on the card), and a second
all-to-all restores the sequence split. Both exchanges are
``comm.all_to_all_autograd``, so the backward runs the same two the
other way.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import comm

__all__ = ["ulysses_attention"]


def _seq_to_heads(x: torch.Tensor, n: int, group) -> torch.Tensor:
    B, H, S, D = x.shape
    parts = x.reshape(B, n, H // n, S, D).permute(1, 0, 2, 3, 4)
    got = comm.all_to_all_autograd(parts.contiguous(), group)
    # [source rank = sequence slice, B, H/n, S_local, D]
    return got.permute(1, 2, 0, 3, 4).reshape(B, H // n, n * S, D)


def _heads_to_seq(x: torch.Tensor, n: int, group) -> torch.Tensor:
    B, Hn, S, D = x.shape
    parts = x.reshape(B, Hn, n, S // n, D).permute(2, 0, 1, 3, 4)
    got = comm.all_to_all_autograd(parts.contiguous(), group)
    # [source rank = head slice, B, H/n, S_local, D]
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * Hn, S // n, D)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, causal: bool = False,
                      sm_scale: Optional[float] = None,
                      mask: Optional[torch.Tensor] = None,
                      attention_fn=None) -> torch.Tensor:
    """q, k, v: [B, H, S_local, D], the rank's slice of the sequence;
    mask: optional additive [B, S] key mask over the WHOLE sequence
    (whole-sequence attention reads every key's mask). H must divide
    by the group's size. ``attention_fn(q, k, v, causal, sm_scale,
    mask)`` runs the local attention; the flash kernels by default.
    Every rank of ``group`` calls it together."""
    from ..kernels.flash_attention import flash_attention

    B, H, S_loc, D = q.shape
    n = comm.group_size(group)
    if H % n:
        raise ValueError(
            f"ulysses: num_heads {H} must be divisible by the sequence "
            f"axis size {n} (use mode='ring' otherwise)")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qh, kh, vh = (_seq_to_heads(t, n, group) for t in (q, k, v))
    if attention_fn is None:
        o = flash_attention(qh, kh, vh, causal=causal, sm_scale=scale,
                            mask=mask)
    else:
        o = attention_fn(qh, kh, vh, causal, scale, mask)
    return _heads_to_seq(o.to(q.dtype), n, group)
