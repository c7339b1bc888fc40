"""KV page-pool write (``kv_cache_write``), in place.

Counterpart of ``paddle_tpu/kernels/paged_attention.py:153-184``, a
plain XLA scatter there and plain ``index_put_`` here: neither is a
kernel. The JAX version is functional (the step returns new pools and
the engine swaps them in); this one WRITES THE POOL IN PLACE, which
saves a copy of every layer's pool each step. Rows past ``num_valid``
(batch padding, idle lanes) are routed to slot 0 of the junk page 0,
exactly as in JAX, so they can never touch a live sequence's page.

(The two_lane ``paged_attention`` read, TPU kernel K13 in PERF.md, is
not ported yet.)
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["kv_cache_write", "kv_write_targets"]


def kv_write_targets(page_indices: torch.Tensor, positions: torch.Tensor,
                     num_valid: torch.Tensor, S: int, page_size: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page, slot) [B, S] int64 for the S new rows of each sequence:
    row j of b lands at absolute position positions[b] + j; invalid
    rows go to (page 0, slot 0). Shared by every layer of a step."""
    dev = page_indices.device
    ar = torch.arange(S, device=dev)
    offs = positions.long()[:, None] + ar[None, :]
    valid = ar[None, :] < num_valid.long()[:, None]
    col = torch.clamp(offs // page_size, 0, page_indices.shape[1] - 1)
    page = torch.gather(page_indices.long(), 1, col)
    zero = torch.zeros_like(page)
    page = torch.where(valid, page, zero)
    slot = torch.where(valid, offs % page_size, zero)
    return page, slot


def kv_cache_write(k_pages: torch.Tensor, v_pages: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   page_indices: torch.Tensor, positions: torch.Tensor,
                   num_valid: torch.Tensor, targets=None) -> None:
    """Scatter k_new/v_new [B, S, KVH, D] into the pools [KVH, P, ps, D]
    in place. ``targets`` (from ``kv_write_targets``) skips recomputing
    the destinations when several layers share them."""
    B, S, KVH, D = k_new.shape
    if targets is None:
        targets = kv_write_targets(page_indices, positions, num_valid, S,
                                   int(k_pages.shape[2]))
    page, slot = targets
    k_pages[:, page, slot, :] = k_new.permute(2, 0, 1, 3).to(k_pages.dtype)
    v_pages[:, page, slot, :] = v_new.permute(2, 0, 1, 3).to(v_pages.dtype)
