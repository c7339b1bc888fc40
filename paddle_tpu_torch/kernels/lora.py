"""Batched LoRA (K12): per-row adapter deltas over rank-bucketed factor
pools, the CUDA kernel ``csrc/lora.cu`` and its plain PyTorch version.

Replaces ``paddle_tpu/kernels/lora.py`` ``_lora_delta_pallas`` (:168,
body ``_make_lora_kernel`` :129). Each batch row adds its own adapter's
low-rank delta to the base product:

    y_m = base(x_m)  +  (x_m @ A[slot_m]) @ B[slot_m] * scale[slot_m]

with one (A [S, K, r], B [S, r, N], scale [S]) pool triple per rank
bucket. Slot 0 of every bucket is the zero adapter (zero factors, scale
0): base-only rows, rows of another bucket and idle lanes point there.
``slots [R, n_buckets]`` names each of R rows' slot per bucket; with M
activation rows a multiple of R (the ragged step's [lanes, chunk]
rows), a row's slots cover its chunk.

``batched_lora_matmul`` runs the base product (``x @ W`` for a dense
weight, or the exact ``quantized_matmul`` call for an int8, int8_block
or fp8 base: the delta applies to the dequantized product), then adds
the buckets' deltas in bucket order. The plain version adds every
bucket's delta to every row, as the JAX reference does (+0.0 for a
slot-0 row). The kernel adds into the base product in place and only
for a nonzero slot, so a slot-0 row is bitwise the base output.

Kernel design. The TPU kernel loops every slot on its grid and masks
rows (S-fold work); here only the rows of a nonzero slot (a ragged lane:
its C activation rows share the slot) do anything, in two kernels a call
(``csrc/lora.cu``): a "shrink" block per (lane pass of 16 rows, slice of
K) computes that slice's partial u = x·A[slot] (r values a row) for
every live bucket; the slices of a lane pass form one thread-block
cluster, whose first block sums the partials in slice order from the
others' shared memory. An "expand" block per (lane pass, 128 columns),
launched as a programmatic dependent of the shrink, stages its out rows
and B[slot] rows in shared memory, waits for the shrink and adds
u·B[slot]·scale[slot] to its columns, every bucket in bucket order, so
ONE call a target covers both rank buckets of the serving store.
``lora_geometry(K, N, r)`` fixes the slices and tiles from the shape
alone and the wrapper passes it to the kernels: a row's result depends
on its own x and slot alone. Any rank >= 1 works (16 at a time) up to
``MAX_RANK_SUM`` over a call's buckets (the blocks' shared memory); the
TPU's rank-multiple-of-8 rule (``lora_rank_geometry_issue`` :82) is a
Mosaic sublane rule with no CUDA counterpart.

Bound on the H100: memory, the factors of the slots present (A and B of
each distinct slot once) plus x and the output rows read and written.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build
from .quant_matmul import DEFAULT_BLOCK, quantized_matmul

__all__ = ["LORA_BASE_KINDS", "MAX_BUCKETS", "MAX_RANK_SUM",
           "LoraGeometry", "lora_geometry", "lora_pool_shapes",
           "lora_slot_bytes", "batched_lora_delta_plain",
           "batched_lora_delta", "batched_lora_add_",
           "batched_lora_add_plain_", "batched_lora_matmul"]

LORA_BASE_KINDS = ("dense", "int8", "int8_block", "fp8")
MAX_BUCKETS = 4          # the kernel's per-launch bucket table
ROWS = 16                # activation rows a lane pass of both kernels
K_LANES = 16             # shrink: threads across K a row (k = c + 16 t)
MAX_SLICES = 16          # shrink: slices of K a cluster (the H100's most)
STAGE_ROWS = (128, 256)  # shrink: rows of K staged at a time
RANK_CHUNK = 16          # ranks a pass of both kernels
CHUNK_COLS = 128         # expand: columns a block (a warp's 32 vectors)
# the shrink's partials and the expand's u, 16 rows of float32 a rank,
# sit in shared memory beside each kernel's staging (at most 37 KB),
# within the H100's 227 KB a block
MAX_RANK_SUM = 2048


class LoraGeometry(NamedTuple):
    """K12's launch for x [M, K] -> [M, N] at rank r: shrink blocks take
    ``slice_rows`` rows of K, ``stage_rows`` at a time (``splits``
    slices, one cluster; the partials a (row, rank), summed in slice
    order) in ``rank_chunks`` passes of RANK_CHUNK ranks; ``tiles``
    expand blocks of CHUNK_COLS columns a lane pass."""
    slice_rows: int
    stage_rows: int
    splits: int
    rank_chunks: int
    tiles: int


def lora_geometry(K: int, N: int, r: int) -> LoraGeometry:
    """K12's geometry, a function of (K, N, r) alone (never of M, the
    slots or the card). The slices, and so every sum's order, depend on
    K alone: K cut into at most MAX_SLICES slices of whole stages, a
    stage the smallest kernel variant that holds a slice, else the
    largest. Thread c of a row takes k = k0 + c + K_LANES * t of its
    slice, t in order across the stages."""
    K, N, r = int(K), int(N), int(r)
    need = -(-K // MAX_SLICES)
    stage = next((s for s in STAGE_ROWS if s >= need), STAGE_ROWS[-1])
    slice_rows = stage * -(-need // stage)
    return LoraGeometry(slice_rows, stage, -(-K // slice_rows),
                        -(-r // RANK_CHUNK), -(-N // CHUNK_COLS))


def lora_pool_shapes(K: int, N: int, rank: int, slots: int
                     ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(A pool, B pool) shapes for one target weight [K, N] in a
    ``rank`` bucket of ``slots`` slots (slot 0 = the zero adapter)."""
    return (slots, int(K), int(rank)), (slots, int(rank), int(N))


def lora_slot_bytes(K: int, N: int, rank: int, itemsize: int = 4) -> int:
    """Device bytes one adapter slot costs for one [K, N] target: A [K,
    r] + B [r, N] and its scale entry."""
    return (int(K) * int(rank) + int(rank) * int(N)) * itemsize + 4


def batched_lora_delta_plain(x2: torch.Tensor, a: torch.Tensor,
                             b: torch.Tensor, scale: torch.Tensor,
                             slots: torch.Tensor) -> torch.Tensor:
    """The plain version (the JAX ``_reference_lora_delta``): per-row
    gathered factors, float32 einsums; delta [M, N] in x2's dtype."""
    idx = slots.long()
    u = torch.einsum("mk,mkr->mr", x2.float(), a[idx].float())
    d = torch.einsum("mr,mrn->mn", u, b[idx].float())
    return (d * scale[idx].float()[:, None]).to(x2.dtype)


def _row_slots(slots: torch.Tensor, M: int) -> Tuple[torch.Tensor, int]:
    slots = slots.to(torch.int32)
    if slots.dim() == 1:
        slots = slots[:, None]
    R = slots.shape[0]
    if R == 0 or M % R:
        raise ValueError(
            f"batched_lora: {M} activation rows do not broadcast over {R} "
            f"slot rows (chunked rows must be a whole multiple)")
    return slots, M // R


def batched_lora_add_plain_(out: torch.Tensor, x2: torch.Tensor,
                            a_pools: Sequence, b_pools: Sequence,
                            scales: Sequence, slots: torch.Tensor
                            ) -> torch.Tensor:
    """The plain version of ``batched_lora_add_``: ``out = out + delta``
    for each bucket in order, every row included."""
    slots, rep = _row_slots(slots, x2.shape[0])
    row_slots = slots.repeat_interleave(rep, dim=0) if rep > 1 else slots
    n = min(slots.shape[1], len(a_pools), len(b_pools), len(scales))
    for j in range(n):
        out += batched_lora_delta_plain(x2, a_pools[j], b_pools[j],
                                        scales[j], row_slots[:, j]
                                        ).to(out.dtype)
    return out


def _check_pools(x2, out, a_pools, b_pools, scales, n):
    M, K = x2.shape
    N = out.shape[1]
    for j in range(n):
        a, b, sc = a_pools[j], b_pools[j], scales[j]
        S, r = a.shape[0], a.shape[2]
        if (a.dim() != 3 or tuple(a.shape[:2]) != (S, K)
                or tuple(b.shape) != (S, r, N) or tuple(sc.shape) != (S,)):
            raise ValueError(
                f"batched_lora: bucket {j} pools A {tuple(a.shape)}, B "
                f"{tuple(b.shape)}, scale {tuple(sc.shape)} do not fit x "
                f"[{M}, {K}] -> [{M}, {N}]")
        for t in (a, b, sc):
            if t.dtype != torch.float32 or t.device != x2.device \
                    or not t.is_contiguous():
                raise TypeError("batched_lora kernel takes contiguous "
                                f"float32 pools on {x2.device}")
    if sum(int(a_pools[j].shape[2]) for j in range(n)) > MAX_RANK_SUM:
        raise ValueError(f"batched_lora kernel takes ranks summing to at "
                         f"most {MAX_RANK_SUM} a call")


# pool sets already checked, with their ctypes tables: the engine passes
# the same pools 4 L + 1 times a step
_POOL_SETS: Dict[tuple, tuple] = {}
_POOL_SETS_MAX = 256
_SAME_DEVICE = contextlib.nullcontext()


def _pool_set(x2, out, a_pools, b_pools, scales, n):
    """(A, B, scale pointer tables, ranks, slot counts, rank sum, the
    geometry) of a pool set on x2's device, checked the first time it is
    seen. The key holds what the checks read of every pool (pointer,
    shape, strides, dtype; a device pointer names its device), so a pool
    that matches it passes them."""
    key = (x2.device.index, x2.shape[1], out.shape[1], n) + tuple(
        (t.data_ptr(), t.shape, t.stride(), t.dtype)
        for j in range(n) for t in (a_pools[j], b_pools[j], scales[j]))
    hit = _POOL_SETS.get(key)
    if hit is None:
        _check_pools(x2, out, a_pools, b_pools, scales, n)
        ptrs = (ctypes.c_void_p * MAX_BUCKETS)
        ints = (ctypes.c_int * MAX_BUCKETS)
        ranks = [int(a_pools[j].shape[2]) for j in range(n)]
        hit = (ptrs(*[a_pools[j].data_ptr() for j in range(n)]),
               ptrs(*[b_pools[j].data_ptr() for j in range(n)]),
               ptrs(*[scales[j].data_ptr() for j in range(n)]),
               ints(*ranks),
               ints(*[int(a_pools[j].shape[0]) for j in range(n)]),
               sum(ranks), lora_geometry(x2.shape[1], out.shape[1],
                                         max(ranks)))
        if len(_POOL_SETS) >= _POOL_SETS_MAX:
            _POOL_SETS.clear()
        _POOL_SETS[key] = hit
    return hit


def batched_lora_add_(out: torch.Tensor, x2: torch.Tensor,
                      a_pools: Sequence, b_pools: Sequence,
                      scales: Sequence, slots: torch.Tensor) -> torch.Tensor:
    """In place: ``out [M, N] += per-row LoRA deltas of x2 [M, K]`` over
    every bucket (``slots [R, n_buckets]``, M a multiple of R). CPU
    tensors run ``batched_lora_add_plain_``; CUDA tensors run K12 (its
    shrink and expand kernels) once for all buckets, counted once a call
    in ``batched_lora_add_.launches``."""
    if x2.dim() != 2 or out.dim() != 2 or out.shape[0] != x2.shape[0]:
        raise ValueError(f"batched_lora: x {tuple(x2.shape)} and out "
                         f"{tuple(out.shape)} must be [M, K] and [M, N]")
    if x2.device.type == "cpu":
        return batched_lora_add_plain_(out, x2, a_pools, b_pools, scales,
                                       slots)
    if x2.device.type != "cuda":
        raise ValueError(f"batched_lora: unsupported device {x2.device}")
    slots, rep = _row_slots(slots, x2.shape[0])
    n = min(slots.shape[1], len(a_pools), len(b_pools), len(scales))
    if n > MAX_BUCKETS:
        raise ValueError(f"batched_lora kernel takes at most {MAX_BUCKETS} "
                         f"rank buckets, got {n}")
    if x2.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError("batched_lora kernel takes float32 x and out")
    if not (x2.is_contiguous() and out.is_contiguous()):
        raise ValueError("batched_lora kernel takes contiguous x and out")
    a_p, b_p, s_p, ranks, nslots, rsum, geo = _pool_set(
        x2, out, a_pools, b_pools, scales, n)
    if slots.device != x2.device or not slots.is_contiguous():
        slots = slots.to(x2.device).contiguous()
    M, K = x2.shape
    N = out.shape[1]
    lib = _build.library()
    # every bucket's u [M, r], the shrink's sums (rows of slot 0 are never
    # written nor read)
    scratch = torch.empty(M * rsum, device=x2.device)
    with torch.cuda.device(x2.device) if (
            x2.device.index != torch.cuda.current_device()) else _SAME_DEVICE:
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pt_batched_lora_add(
            x2.data_ptr(), out.data_ptr(), slots.data_ptr(),
            scratch.data_ptr(), a_p, b_p, s_p, ranks, nslots, n,
            int(slots.shape[1]), M, K, N, rep, geo.slice_rows,
            geo.stage_rows, geo.splits, geo.tiles, stream)
    _build.check(err, "batched_lora_add_")
    _build.count(batched_lora_add_)
    return out


batched_lora_add_.launches = 0


def batched_lora_delta(x2: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       scale: torch.Tensor, slots: torch.Tensor
                       ) -> torch.Tensor:
    """The per-row delta [M, N] over ONE bucket's pools (``slots [M]``),
    the JAX package's public ``batched_lora_delta``; slot-0 rows are
    exactly 0."""
    if x2.device.type == "cpu":
        return batched_lora_delta_plain(x2, a, b, scale, slots)
    out = torch.zeros((x2.shape[0], b.shape[2]), device=x2.device,
                      dtype=x2.dtype)
    return batched_lora_add_(out, x2.contiguous(), [a], [b], [scale],
                             slots.reshape(-1, 1))


def batched_lora_matmul(x: torch.Tensor, weight: torch.Tensor,
                        a_pools: Sequence, b_pools: Sequence,
                        adapter_scales: Sequence, slots: torch.Tensor, *,
                        base_kind: str = "dense",
                        weight_scale: Optional[torch.Tensor] = None,
                        quant_block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """``x [..., K]`` through the base matmul plus per-row adapter
    deltas -> ``[..., N]`` (no bias: the caller adds it after, as the
    JAX program's ``elementwise_add`` does). ``base_kind`` "dense" takes
    ``weight`` [K, N] float; the quant modes take it as the quantized
    weight with ``weight_scale``."""
    if base_kind not in LORA_BASE_KINDS:
        raise ValueError(f"batched_lora_matmul: base_kind must be one of "
                         f"{LORA_BASE_KINDS}, got {base_kind!r}")
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if base_kind == "dense":
        out = x2 @ weight
    else:
        out = quantized_matmul(x2, weight, weight_scale, mode=base_kind,
                               block=int(quant_block))
    out = batched_lora_add_(out, x2.contiguous(), a_pools, b_pools,
                            adapter_scales, slots)
    return out.reshape(*lead, out.shape[-1])
