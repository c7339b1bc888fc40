"""Paged decode attention (K13) and the KV page-pool write
(``kv_cache_write``, in place).

``paged_attention`` replaces ``paddle_tpu/kernels/paged_attention.py``
``paged_attention`` (:104), the two_lane engine's decode read, which on
a TPU wraps JAX's library Pallas kernel
``jax.experimental.pallas.ops.tpu.paged_attention`` (:127). Here it is
the CUDA kernel of ``csrc/paged_attention.cu`` beside its plain PyTorch
version. One query row per sequence, q [B, H, D], attends the first
``lengths[b]`` keys of its sequence through the block table
``page_indices[b]`` over pools [KVH, P, ps, D]; grouped-query heads read
kv head ``h // (H // KVH)``; a length-0 row gives zeros. The JAX
wrapper's fallback (a Mosaic failure logs a warning and returns the
reference) is not carried over: a build or launch failure raises.

Bound on the H100: memory, the K/V rows the lengths attend
(``sum_b min(len_b, maxp * ps) * D * itemsize * 2 * KVH`` bytes) plus
q and out. The kernel splits each row's key walk across blocks
(flash-decoding): ``split_geometry`` cuts ``maxp * ps`` keys into chunks
of whole pages, a block per (row, kv head, chunk) writes a float32
partial (m, l, acc) into a workspace sized once a call, and a merge
kernel combines a row's partials in split order (one K13 call, one
count). The geometry depends on ``maxp * ps`` alone, never on the
lengths (device data), so a row's result does not depend on the rows
beside it and two calls give the same bits. The design is described in
the CUDA source.

Counterpart of ``paddle_tpu/kernels/paged_attention.py:153-184``, a
plain XLA scatter there and plain ``index_put_`` here: neither is a
kernel. The JAX version is functional (the step returns new pools and
the engine swaps them in); this one WRITES THE POOL IN PLACE, which
saves a copy of every layer's pool each step. Rows past ``num_valid``
(batch padding, idle lanes) are routed to slot 0 of the junk page 0,
exactly as in JAX, so they can never touch a live sequence's page.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from . import _build

__all__ = ["kv_cache_write", "kv_write_targets", "paged_attention",
           "paged_attention_plain", "split_geometry", "split_key_ranges"]

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK_KEYS = 64   # the most keys a block of the kernel holds (kMaxChunk)


def split_geometry(maxp: int, ps: int) -> Tuple[int, int]:
    """(chunk, nsplit) of the kernel's split key walk over a block table
    of ``maxp`` pages of ``ps`` keys: chunks of whole pages, at most
    ``CHUNK_KEYS`` keys (one piece of a page when a page is longer), and
    as many as cover ``maxp * ps`` keys. A function of the table's shape
    alone: the lengths live on the device and are never read here."""
    chunk = ps * (CHUNK_KEYS // ps) if ps <= CHUNK_KEYS else CHUNK_KEYS
    return chunk, -(-(maxp * ps) // chunk)


def split_key_ranges(length: int, maxp: int, ps: int
                     ) -> List[Tuple[int, int]]:
    """The keys [start, end) each split of a row of ``length`` attends,
    in split order: split j takes chunk j of ``split_geometry``, clipped
    to the keys the row attends (``min(length, maxp * ps)``; an empty
    range where the chunk starts at or past it)."""
    chunk, nsplit = split_geometry(maxp, ps)
    n = max(0, min(int(length), maxp * ps))
    return [(min(j * chunk, n), min((j + 1) * chunk, n))
            for j in range(nsplit)]


def paged_attention_plain(q, k_pages, v_pages, lengths, page_indices,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version, op for op the reference's
    ``_reference_paged_attention`` (:56-85): gather each sequence's
    pages into a contiguous window, scale q in float32, mask keys at or
    past the length with -1e30, float32 softmax; a length-0 row is
    zeros."""
    B, H, D = q.shape
    KVH, _P, ps, _ = k_pages.shape
    maxp = page_indices.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    idx = page_indices.long()
    # [KVH, B, maxp, ps, D] -> [B, KVH, maxp * ps, D]
    k = k_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(B, KVH, maxp * ps, D)
    v = v_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(B, KVH, maxp * ps, D)
    if KVH != H:   # grouped-query: repeat KV heads over the query groups
        k = k.repeat_interleave(H // KVH, dim=1)
        v = v.repeat_interleave(H // KVH, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float() * scale, k.float())
    valid = (torch.arange(maxp * ps, device=q.device)[None, :]
             < lengths.long()[:, None])                           # [B, K]
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhk,bhkd->bhd", p, v.float())
    o = torch.where(lengths[:, None, None] > 0, o, torch.zeros_like(o))
    return o.to(q.dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, lengths: torch.Tensor,
                    page_indices: torch.Tensor, *,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Decode-step attention over paged K/V.

    q: [B, H, D]; k_pages, v_pages: [KVH, P, ps, D] (q's dtype, float32
    or bfloat16); lengths: [B] int32, the keys each row attends (the row
    just written included); page_indices: [B, maxp] int32. Returns
    [B, H, D] in q's dtype; the default scale is 1/sqrt(D). CPU tensors
    run ``paged_attention_plain``; CUDA tensors run K13 (its split pass
    and its merge), counted once in ``paged_attention.launches``."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("paged_attention takes q [B, H, D] and pages "
                         "[KVH, P, ps, D]")
    B, H, D = q.shape
    KVH, P, ps, _ = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape) or k_pages.shape[3] != D:
        raise ValueError(
            f"pages {tuple(k_pages.shape)} / {tuple(v_pages.shape)} do not "
            f"match q {tuple(q.shape)}")
    if KVH < 1 or H % KVH:
        raise ValueError(f"{H} query heads are not a multiple of {KVH} kv "
                         "heads")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [B] = [{B}], got "
                         f"{tuple(lengths.shape)}")
    if page_indices.dim() != 2 or page_indices.shape[0] != B:
        raise ValueError("page_indices must be [B, max_pages]")
    for name, t in (("lengths", lengths), ("page_indices", page_indices)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for t in (k_pages, v_pages, lengths, page_indices):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}; one is on "
                             f"{t.device}")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, lengths,
                                     page_indices, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    code = _DTYPES.get(q.dtype)
    if code is None or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"paged_attention kernel takes float32 or bfloat16 q and pages "
            f"of one dtype; got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention kernel takes D <= {MAX_HEAD_DIM}, "
                         f"got {D}")
    if not all(t.is_contiguous()
               for t in (q, k_pages, v_pages, lengths, page_indices)):
        raise ValueError("paged_attention kernel takes contiguous tensors")
    maxp = page_indices.shape[1]
    chunk, nsplit = split_geometry(maxp, ps)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    # the partials: acc [B, H, nsplit, D], then (m, l) [B, H, nsplit, 2]
    work = torch.empty(B * H * nsplit * (D + 2), dtype=torch.float32,
                       device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(),
            work.data_ptr(), work[B * H * nsplit * D:].data_ptr(),
            B, H, D, KVH, P, ps, maxp, chunk, nsplit, float(scale), code,
            stream)
    _build.check(err, "paged_attention")
    _build.count(paged_attention)
    return out


paged_attention.launches = 0


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
