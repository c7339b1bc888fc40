"""Ring attention: the port's counterpart of
``paddle_tpu/parallel/ring_attention.py``, sequence (context)
parallelism for long sequences.

Each rank of an ``sp`` group holds its slice of the sequence of q, k
and v. The k/v slices (and the key mask) travel around the ring
(``comm.permute_autograd``, ``sp - 1`` steps) while each rank folds
blockwise softmax(QKᵀ)V into a running max and denominator
(log-sum-exp merging), so the whole [S, S] score matrix never exists.
As in the JAX package the block attention is plain arithmetic (there
``jnp`` outside any Pallas kernel, here ``torch.matmul`` in float32),
and the backward is autograd through the loop: each permute's backward
sends the k/v gradients back around the ring to the rank that owns
them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import comm

__all__ = ["ring_attention"]

_NEG = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = False,
                   sm_scale: Optional[float] = None,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: [B, H, S_local, D], this rank's slice of the sequence
    (rank i holds positions [i * S_local, (i + 1) * S_local)). mask:
    optional additive key mask [B, S_local] (0 valid / -inf masked), the
    rank's slice like k; it rotates with its keys. Returns
    [B, H, S_local, D] in q's dtype. Every rank of ``group`` calls it
    together; with no group it is plain attention."""
    B, H, S, D = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    n = comm.group_size(group)
    my_idx = comm.group_rank(group)
    q32 = q.float()
    rows = my_idx * S + torch.arange(S, device=q.device)[:, None]
    o = torch.zeros_like(q32)
    m = torch.full_like(q32[..., :1], float("-inf"))
    l = torch.zeros_like(q32[..., :1])
    k_cur, v_cur, mask_cur, kv_idx = k, v, mask, my_idx
    for step in range(n):
        s = torch.matmul(q32, k_cur.float().transpose(-1, -2)) * scale
        if mask_cur is not None:
            s = s + mask_cur[:, None, None, :].float()
        if causal:
            # global positions: row = my_idx*S + i, col = kv_idx*S + j
            cols = kv_idx * S + torch.arange(S, device=q.device)[None, :]
            s = torch.where(rows >= cols, s,
                            torch.full((), _NEG, device=s.device))
        m_blk = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m_blk)
        l_blk = p.sum(dim=-1, keepdim=True)
        o_blk = torch.matmul(p, v_cur.float())
        m_new = torch.maximum(m, m_blk)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_blk - m_new)
        l = l * alpha + l_blk * beta
        o = o * alpha + o_blk * beta
        m = m_new
        if step < n - 1:
            k_cur = comm.permute_autograd(k_cur, group)
            v_cur = comm.permute_autograd(v_cur, group)
            if mask_cur is not None:
                mask_cur = comm.permute(mask_cur, group)
            kv_idx = (kv_idx - 1) % n
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)
