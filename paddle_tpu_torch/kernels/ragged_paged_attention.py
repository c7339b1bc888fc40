"""Ragged paged attention: the CUDA kernel
``csrc/ragged_paged_attention.cu`` and its plain PyTorch version.

Replaces ``paddle_tpu/kernels/ragged_paged_attention.py``
``_ragged_pallas`` (``pallas_call`` at :232; the non-quantized form).
One call attends a ragged batch of new-token chunks over the paged
K/V pool: row b holds up to C new tokens of one sequence (a prefill
chunk, a decode token, or nothing: an idle lane), query j sits at
absolute position ``start_pos[b] + j`` and attends keys
``0 .. start_pos[b] + j`` of its sequence through the block table
``page_indices[b]``. Rows ``j >= num_valid[b]`` are exactly 0, never
NaN. The chunk's own K/V has been written into the pool
(``kv_cache_write``) before the call.

Bound on the H100: memory, the K/V pages the rows need
(``sum_b ceil((start_b + num_valid_b) / ps) * ps * D * itemsize * 2 *
KVH`` bytes) plus q and out. The kernel's design (one block per
(row, head), a loop over the pages in the block in place of the TPU's
sequential grid axis, K/V tiles staged in shared memory, online softmax
in float32 registers, a warp per query row) is described in the CUDA
source; at the slice's 8 lanes x 16 heads its grid of 128 blocks does
not fill the 132 SMs.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

__all__ = ["ragged_paged_attention", "ragged_paged_attention_plain",
           "MAX_HEAD_DIM", "MAX_CHUNK"]

NEG_INF = -1e30
MAX_HEAD_DIM = 256
MAX_CHUNK = 64
_SMEM_FLOATS = 48 * 1024 // 4          # both [ps, D] float32 tiles
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ragged_paged_attention_plain(q, k_pages, v_pages, start_pos, num_valid,
                                 page_indices, sm_scale: Optional[float] = None):
    """The plain PyTorch version (the counterpart of the JAX package's
    ``_reference_ragged``): gather each row's pages into a dense window,
    mask ``key_pos <= start + j``, float32 softmax."""
    B, C, H, D = q.shape
    KVH, _P, ps, _ = k_pages.shape
    maxp = page_indices.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    idx = page_indices.long()

    def window(pages):   # [KVH, P, ps, D] -> [B, H, maxp * ps, D] float32
        w = pages[:, idx].permute(1, 0, 2, 3, 4).float()
        w = w.reshape(B, KVH, maxp * ps, D)
        return w.repeat_interleave(H // KVH, dim=1) if KVH != H else w

    k, v = window(k_pages), window(v_pages)
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
                           page_indices, sm_scale: Optional[float] = None):
    """Attend a ragged batch of new-token chunks over paged K/V.

    q: [B, C, H, D]; k_pages, v_pages: [KVH, P, ps, D] (float32 or
    bfloat16, one dtype); start_pos, num_valid: [B] int32; page_indices:
    [B, maxp] int32. Returns [B, C, H, D] in q's dtype. CPU tensors run
    ``ragged_paged_attention_plain``; CUDA tensors run the kernel,
    counted in ``ragged_paged_attention.launches``."""
    _check(q, k_pages, v_pages, start_pos, num_valid, page_indices)
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_pages, v_pages, start_pos,
                                            num_valid, page_indices, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention: unsupported device "
                         f"{q.device}")
    B, C, H, D = q.shape
    KVH, P, ps, _ = k_pages.shape
    maxp = page_indices.shape[1]
    code = _DTYPES.get(q.dtype)
    if code is None or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"ragged_paged_attention kernel takes float32 or bfloat16 q and "
            f"pages of one dtype; got {q.dtype}, {k_pages.dtype}, "
            f"{v_pages.dtype}")
    if D > MAX_HEAD_DIM or C > MAX_CHUNK or 2 * ps * D > _SMEM_FLOATS:
        raise ValueError(
            f"ragged_paged_attention kernel takes D <= {MAX_HEAD_DIM}, "
            f"C <= {MAX_CHUNK} and page_size * D <= {_SMEM_FLOATS // 2}; got "
            f"D={D}, C={C}, page_size={ps}")
    if not all(t.is_contiguous() for t in (q, k_pages, v_pages, start_pos,
                                           num_valid, page_indices)):
        raise ValueError("ragged_paged_attention kernel takes contiguous "
                         "tensors")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_ragged_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            start_pos.data_ptr(), num_valid.data_ptr(),
            page_indices.data_ptr(), out.data_ptr(),
            B, C, H, D, KVH, P, ps, maxp, float(scale), code, stream)
    _build.check(err, "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
