"""Ragged paged attention: the CUDA kernel
``csrc/ragged_paged_attention.cu`` and its plain PyTorch version.

Replaces ``paddle_tpu/kernels/ragged_paged_attention.py``
``_ragged_pallas`` (``pallas_call`` at :232): K2, over float32 or
bfloat16 pages, and K2q (``ragged_paged_attention_q``, the same
function with quantized=True), over int8 pages with per-(kv head, slot)
float32 scale planes ``[KVH, P, ps]``.
One call attends a ragged batch of new-token chunks over the paged
K/V pool: row b holds up to C new tokens of one sequence (a prefill
chunk, a decode token, or nothing: an idle lane), query j sits at
absolute position ``start_pos[b] + j`` and attends keys
``0 .. start_pos[b] + j`` of its sequence through the block table
``page_indices[b]``. Rows ``j >= num_valid[b]`` are exactly 0, never
NaN. The chunk's own K/V has been written into the pool
(``kv_cache_write``, or ``quantized_kv_cache_write`` for int8 pages)
before the call.

Bound on the H100: memory, the K/V pages the rows need
(``sum_b ceil((start_b + num_valid_b) / ps) * ps * D * itemsize * 2 *
KVH`` bytes) plus q and out. The kernel splits each row's page walk
across blocks (flash-decoding, as K13): ``split_geometry`` of
``paged_attention.py`` cuts the table's ``maxp * ps`` keys into chunks
of whole pages; a block per (chunk, kv head, row) serves every query
head of its kv head and every query of the row, on the tensor cores
(``DOT_ROWS`` or fewer query rows, a decode row: dot products from
shared memory), and writes float32 partials (m, l, acc) into a
workspace sized once a call; a merge kernel combines each query's
partials in split order and writes every element of the output (one K2
call, one count). The geometry depends on the table's shape alone,
never on the lengths (device data), so a row's result does not depend
on the rows beside it and two calls give the same bits. The design is
described in the CUDA source.

``quantized_kv_cache_write`` (:294-327 there, an XLA scatter, not a
Pallas kernel) quantizes each new [D] row to int8 with one
``max|row| / 127`` scale (``kernels/quant.py``) and writes rows and
scales into the pools in place; invalid rows go to slot 0 of the junk
page 0, as in ``kv_cache_write``.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .paged_attention import kv_write_targets, split_geometry
from .quant import blockwise_quantize

__all__ = ["ragged_paged_attention", "ragged_paged_attention_plain",
           "ragged_paged_attention_q", "quantized_kv_cache_write",
           "MAX_HEAD_DIM", "MAX_CHUNK", "DOT_ROWS"]

NEG_INF = -1e30
MAX_HEAD_DIM = 256
MAX_CHUNK = 64
# blocks with at most this many query rows (num_valid x query heads a kv
# head) take the kernel's dot-product path, the rest its mma path
DOT_ROWS = 1
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ragged_paged_attention_plain(q, k_pages, v_pages, start_pos, num_valid,
                                 page_indices, sm_scale: Optional[float] = None,
                                 k_scales=None, v_scales=None):
    """The plain PyTorch version (the counterpart of the JAX package's
    ``_reference_ragged`` with ``_gather_kv``): gather each row's pages
    into a dense float32 window (int8 pages times their scales), mask
    ``key_pos <= start + j``, float32 softmax."""
    B, C, H, D = q.shape
    KVH, _P, ps, _ = k_pages.shape
    maxp = page_indices.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    idx = page_indices.long()

    def window(pages, scales):   # -> [B, H, maxp * ps, D] float32
        w = pages[:, idx].permute(1, 0, 2, 3, 4).float()
        w = w.reshape(B, KVH, maxp * ps, D)
        if scales is not None:
            s = scales[:, idx].permute(1, 0, 2, 3).reshape(B, KVH, maxp * ps)
            w = w * s[..., None]
        return w.repeat_interleave(H // KVH, dim=1) if KVH != H else w

    k, v = window(k_pages, k_scales), window(v_pages, v_scales)
    s = torch.einsum("bchd,bhkd->bhck", q.float() * scale, k)
    dev = q.device
    kpos = torch.arange(maxp * ps, device=dev)
    qpos = start_pos.long()[:, None] + torch.arange(C, device=dev)[None, :]
    mask = kpos[None, None, :] <= qpos[:, :, None]                # [B, C, K]
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    o = torch.einsum("bhck,bhkd->bchd", torch.softmax(s, dim=-1), v)
    row_ok = (torch.arange(C, device=dev)[None, :]
              < num_valid.long()[:, None])                        # [B, C]
    return torch.where(row_ok[..., None, None], o,
                       torch.zeros_like(o)).to(q.dtype)


def _check(q, k_pages, v_pages, start_pos, num_valid, page_indices):
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("ragged_paged_attention takes q [B, C, H, D] and "
                         "pages [KVH, P, ps, D]")
    B, C, H, D = q.shape
    KVH = k_pages.shape[0]
    if tuple(v_pages.shape) != tuple(k_pages.shape) or k_pages.shape[3] != D:
        raise ValueError(
            f"pages {tuple(k_pages.shape)} / {tuple(v_pages.shape)} do not "
            f"match q {tuple(q.shape)}")
    if KVH < 1 or H % KVH:
        raise ValueError(f"{H} query heads are not a multiple of {KVH} kv heads")
    if tuple(start_pos.shape) != (B,) or tuple(num_valid.shape) != (B,):
        raise ValueError("start_pos and num_valid must be [B]")
    if page_indices.dim() != 2 or page_indices.shape[0] != B:
        raise ValueError("page_indices must be [B, max_pages]")
    for name, t in (("start_pos", start_pos), ("num_valid", num_valid),
                    ("page_indices", page_indices)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for t in (k_pages, v_pages, start_pos, num_valid, page_indices):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}; one is on "
                             f"{t.device}")


def ragged_paged_attention(q, k_pages, v_pages, start_pos, num_valid,
                           page_indices, sm_scale: Optional[float] = None, *,
                           k_scales=None, v_scales=None):
    """Attend a ragged batch of new-token chunks over paged K/V.

    q: [B, C, H, D]; k_pages, v_pages: [KVH, P, ps, D] (float32 or
    bfloat16, one dtype; int8 with ``k_scales`` / ``v_scales`` [KVH, P,
    ps] float32, which routes to ``ragged_paged_attention_q``);
    start_pos, num_valid: [B] int32; page_indices: [B, maxp] int32.
    Returns [B, C, H, D] in q's dtype. CPU tensors run
    ``ragged_paged_attention_plain``; CUDA tensors run K2, counted in
    ``ragged_paged_attention.launches``."""
    if k_scales is not None or v_scales is not None:
        return ragged_paged_attention_q(q, k_pages, v_pages, k_scales,
                                        v_scales, start_pos, num_valid,
                                        page_indices, sm_scale)
    _check(q, k_pages, v_pages, start_pos, num_valid, page_indices)
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_pages, v_pages, start_pos,
                                            num_valid, page_indices, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention: unsupported device "
                         f"{q.device}")
    code = _DTYPES.get(q.dtype)
    if code is None or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"ragged_paged_attention kernel takes float32 or bfloat16 q and "
            f"pages of one dtype; got {q.dtype}, {k_pages.dtype}, "
            f"{v_pages.dtype}")
    _check_kernel_geometry(q, (q, k_pages, v_pages, start_pos, num_valid,
                               page_indices))
    out = _launch("pt_ragged_paged_attention", q, k_pages, v_pages, (),
                  start_pos, num_valid, page_indices, sm_scale, code)
    _build.count(ragged_paged_attention)
    return out


ragged_paged_attention.launches = 0


def _check_kernel_geometry(q, tensors):
    # the block's shared memory is the C launcher's to size: a size the
    # card refuses comes back from the launch as an error
    _B, C, _H, D = q.shape
    if D > MAX_HEAD_DIM or C > MAX_CHUNK:
        raise ValueError(
            f"ragged_paged_attention kernel takes D <= {MAX_HEAD_DIM} and "
            f"C <= {MAX_CHUNK}; got D={D}, C={C}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ragged_paged_attention kernel takes contiguous "
                         "tensors")


def _launch(entry, q, k_pages, v_pages, scales, start_pos, num_valid,
            page_indices, sm_scale, code):
    """One K2 or K2q call (its split pass and its merge): the partials'
    workspace, acc [B, C, H, nsplit, D] then (m, l) [B, C, H, nsplit,
    2], is allocated here and only its live rows are touched."""
    B, C, H, D = q.shape
    KVH, P, ps, _ = k_pages.shape
    maxp = page_indices.shape[1]
    chunk, nsplit = split_geometry(maxp, ps)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    rows = B * C * H * nsplit
    work = torch.empty(rows * (D + 2), dtype=torch.float32, device=q.device)
    fn = getattr(_build.library(), entry)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 *[t.data_ptr() for t in scales], start_pos.data_ptr(),
                 num_valid.data_ptr(), page_indices.data_ptr(),
                 out.data_ptr(), work.data_ptr(), work[rows * D:].data_ptr(),
                 B, C, H, D, KVH, P, ps, maxp, chunk, nsplit, float(scale),
                 DOT_ROWS, code, stream)
    _build.check(err, entry.removeprefix("pt_"))
    return out


def ragged_paged_attention_q(q, k_pages, v_pages, k_scales, v_scales,
                             start_pos, num_valid, page_indices,
                             sm_scale: Optional[float] = None):
    """K2q: ``ragged_paged_attention`` over int8 pages [KVH, P, ps, D]
    whose rows (kv head, page, slot) carry the float32 scales
    ``k_scales`` / ``v_scales`` [KVH, P, ps]. CPU tensors run the plain
    version; CUDA tensors run the kernel, counted in
    ``ragged_paged_attention_q.launches``."""
    _check(q, k_pages, v_pages, start_pos, num_valid, page_indices)
    KVH, P, ps, _ = k_pages.shape
    if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
        raise TypeError(f"ragged_paged_attention_q takes int8 pages; got "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        if t is None or tuple(t.shape) != (KVH, P, ps):
            raise ValueError(f"{name} must be [KVH, P, ps] = "
                             f"{(KVH, P, ps)}")
        if t.dtype != torch.float32 or t.device != q.device:
            raise TypeError(f"{name} must be float32 on {q.device}")
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_pages, v_pages, start_pos,
                                            num_valid, page_indices, sm_scale,
                                            k_scales, v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention_q: unsupported device "
                         f"{q.device}")
    code = _DTYPES.get(q.dtype)
    if code is None:
        raise TypeError(f"ragged_paged_attention_q kernel takes float32 or "
                        f"bfloat16 q; got {q.dtype}")
    _check_kernel_geometry(q, (q, k_pages, v_pages, k_scales, v_scales,
                               start_pos, num_valid, page_indices))
    out = _launch("pt_ragged_paged_attention_q", q, k_pages, v_pages,
                  (k_scales, v_scales), start_pos, num_valid, page_indices,
                  sm_scale, code)
    _build.count(ragged_paged_attention_q)
    return out


ragged_paged_attention_q.launches = 0


def quantized_kv_cache_write(k_pages: torch.Tensor, v_pages: torch.Tensor,
                             k_scales: torch.Tensor, v_scales: torch.Tensor,
                             k_new: torch.Tensor, v_new: torch.Tensor,
                             page_indices: torch.Tensor,
                             positions: torch.Tensor, num_valid: torch.Tensor,
                             targets=None) -> None:
    """The int8 twin of ``kv_cache_write``, in place: each new [D] row
    of k_new / v_new [B, S, KVH, D] quantizes to int8 with one
    ``max|row| / 127`` scale, and rows and scales scatter into the
    int8 pools [KVH, P, ps, D] and the scale planes [KVH, P, ps].
    ``targets`` (from ``kv_write_targets``) is shared by every layer of
    a step."""
    B, S, KVH, D = k_new.shape
    if targets is None:
        targets = kv_write_targets(page_indices, positions, num_valid, S,
                                   int(k_pages.shape[2]))
    page, slot = targets
    for pages, scales, new in ((k_pages, k_scales, k_new),
                               (v_pages, v_scales, v_new)):
        rows = new.permute(2, 0, 1, 3).float().reshape(KVH * B * S, D)
        q, s = blockwise_quantize(rows)
        pages[:, page, slot, :] = q.reshape(KVH, B, S, D)
        scales[:, page, slot] = s.reshape(KVH, B, S)
