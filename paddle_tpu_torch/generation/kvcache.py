"""PagedKVCache: the page pool + block tables behind continuous
batching (counterpart of ``paddle_tpu/generation/kvcache.py:115``).

K/V live in fixed-size pages inside ONE preallocated device tensor per
layer, ``[num_kv_heads, num_pages, page_size, head_dim]`` (the JAX
layout); each sequence owns a block table (ordered page ids) and a true
length. Growing a sequence never reallocates: at worst it pops one page
off the free list. The pools are written IN PLACE by the engine's step
(``kernels.kv_cache_write``); the JAX package's functional
``set_buffers`` swap has no counterpart here.

The host side (block tables, lengths, free list, slots) stays in numpy
and is mutated only by the engine's loop thread; the lock guards the
readers (``stats()`` from other threads).

Page 0 is permanently reserved as the JUNK page: idle lanes and padding
rows point their tables at it, so their writes never touch a live
sequence.

``dtype="int8"`` (the engine's ``kv_dtype="int8"``,
``kvcache.py:133-229, :250-255`` there) keeps int8 pools plus one
float32 scale per (kv head, page, slot): ``k_scales`` / ``v_scales``
``[KVH, P, ps]``, initialised to 1.0 so an unwritten slot dequantizes
to 0.0. A page then costs ``2 * (KVH * ps * D + 4 * KVH * ps)`` bytes
a layer: 67,584 against 262,144 in float32 at 16 heads x 16 slots x
128.

Not ported yet (later slices, see ROADMAP): the radix prefix trie and
refcounted sharing (A4), page export/ingest (A9). With no sharing,
every in-use page belongs to exactly one chain.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

__all__ = ["PagedKVCache", "PagePoolExhausted"]


def _torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """A pool dtype given as a torch dtype or as its JAX-side name
    ("float32", "bfloat16", "int8")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"KV pool dtype must be float32, bfloat16 or "
                         f"int8; got {dtype!r}")
    return getattr(torch, dtype)


class PagePoolExhausted(RuntimeError):
    """No free pages (or slots) for the requested growth — admission
    backpressure or eviction must resolve it; never an allocation."""


class PagedKVCache:
    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int, *,
                 num_pages: int, page_size: int, max_seqs: int,
                 max_pages_per_seq: int,
                 device: Union[str, torch.device] = "cuda",
                 dtype: Union[str, torch.dtype] = torch.float32):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        if page_size < 1 or max_seqs < 1 or max_pages_per_seq < 1:
            raise ValueError("page_size/max_seqs/max_pages_per_seq >= 1")
        self.num_layers = int(num_layers)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_seqs = int(max_seqs)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self.device = torch.device(device)
        self.dtype = _torch_dtype(dtype)
        self.quantized = self.dtype == torch.int8
        self._lock = threading.Lock()
        # device pools, one K + one V per layer (lazy: the first access
        # allocates, so constructing a cache costs nothing); int8 pools
        # carry float32 scale planes [KVH, P, ps] beside them
        self._k_pages: Optional[List[torch.Tensor]] = None
        self._v_pages: Optional[List[torch.Tensor]] = None
        self._k_scales: Optional[List[torch.Tensor]] = None
        self._v_scales: Optional[List[torch.Tensor]] = None
        # host bookkeeping
        self.block_tables = np.zeros((max_seqs, max_pages_per_seq), np.int32)
        self.lengths = np.zeros(max_seqs, np.int32)
        self._pages_of: List[List[int]] = [[] for _ in range(max_seqs)]
        self._active = [False] * max_seqs
        # page 0 = junk page, never on the free list
        self._free = list(range(num_pages - 1, 0, -1))
        self.evictions_total = 0
        self.allocations_total = 0

    # -- device buffers ------------------------------------------------------
    def _ensure_buffers(self):
        if self._k_pages is None:
            shape = (self.num_kv_heads, self.num_pages, self.page_size,
                     self.head_dim)
            self._k_pages = [torch.zeros(shape, device=self.device,
                                         dtype=self.dtype)
                             for _ in range(self.num_layers)]
            self._v_pages = [torch.zeros(shape, device=self.device,
                                         dtype=self.dtype)
                             for _ in range(self.num_layers)]
            if self.quantized:
                # scale 1.0 everywhere: an unwritten slot (the junk page
                # included) dequantizes to 0.0, never to garbage
                self._k_scales = [torch.ones(shape[:3], device=self.device)
                                  for _ in range(self.num_layers)]
                self._v_scales = [torch.ones(shape[:3], device=self.device)
                                  for _ in range(self.num_layers)]

    @property
    def k_pages(self) -> List[torch.Tensor]:
        self._ensure_buffers()
        return self._k_pages

    @property
    def v_pages(self) -> List[torch.Tensor]:
        self._ensure_buffers()
        return self._v_pages

    @property
    def k_scales(self) -> Optional[List[torch.Tensor]]:
        """The int8 pools' K scale planes (None for a float pool)."""
        self._ensure_buffers()
        return self._k_scales

    @property
    def v_scales(self) -> Optional[List[torch.Tensor]]:
        self._ensure_buffers()
        return self._v_scales

    @staticmethod
    def page_bytes(num_kv_heads: int, head_dim: int, page_size: int,
                   dtype: Union[str, torch.dtype]) -> int:
        """Device bytes ONE page costs per layer (K + V, and for int8
        the scale planes)."""
        dtype = _torch_dtype(dtype)
        slots = num_kv_heads * page_size
        if dtype == torch.int8:
            return 2 * (slots * head_dim + 4 * slots)
        item = torch.empty((), dtype=dtype).element_size()
        return 2 * slots * head_dim * item

    def pool_bytes(self) -> int:
        """Total device bytes of the page pools across layers."""
        return (self.num_layers * self.num_pages
                * self.page_bytes(self.num_kv_heads, self.head_dim,
                                  self.page_size, self.dtype))

    # -- capacity accounting -------------------------------------------------
    def pages_needed(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 0) // self.page_size)

    @property
    def usable_pages(self) -> int:
        """Pool capacity available to sequences (junk page excluded)."""
        return self.num_pages - 1

    def can_fit_ever(self, n_tokens: int) -> bool:
        """Could a sequence of n_tokens EVER be served by this pool —
        the admission-time check (Overloaded before any prefill)."""
        need = self.pages_needed(n_tokens)
        return (need <= self.usable_pages
                and need <= self.max_pages_per_seq
                and n_tokens <= self.max_pages_per_seq * self.page_size)

    def can_allocate(self, n_tokens: int) -> bool:
        return self.pages_needed(n_tokens) <= len(self._free)

    def free_slots(self) -> int:
        return sum(1 for a in self._active if not a)

    def reclaimable_pages(self, slot: int) -> int:
        """Pages that evicting ``slot`` would return (all of its chain:
        nothing is shared in this slice)."""
        return len(self._pages_of[slot])

    # -- sequence lifecycle --------------------------------------------------
    def _pop_page_locked(self) -> int:
        if not self._free:
            raise PagePoolExhausted("page pool dry")
        return self._free.pop()

    def allocate_slot(self, n_tokens: int) -> int:
        """Claim a batch slot + pages for an n_tokens prompt. Returns the
        slot id; raises PagePoolExhausted when pages or slots are not
        available *right now* (backpressure, not rejection)."""
        need = self.pages_needed(n_tokens)
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"{n_tokens} tokens need {need} pages > max_pages_per_seq="
                f"{self.max_pages_per_seq}")
        with self._lock:
            slot = next((i for i, a in enumerate(self._active) if not a),
                        None)
            if slot is None:
                raise PagePoolExhausted("no free decode slots")
            if need > len(self._free):
                raise PagePoolExhausted(
                    f"{need} pages needed, {len(self._free)} free")
            pages = [self._pop_page_locked() for _ in range(need)]
            self._pages_of[slot] = pages
            row = self.block_tables[slot]
            row[:] = 0
            row[:len(pages)] = pages
            self.lengths[slot] = 0
            self._active[slot] = True
            self.allocations_total += need
            return slot

    def ensure_capacity(self, slot: int, new_len: int) -> None:
        """Grow slot's page chain to cover new_len tokens; raises
        PagePoolExhausted when the pool is dry (the engine evicts)."""
        need = self.pages_needed(new_len)
        if new_len > self.max_pages_per_seq * self.page_size:
            raise ValueError(
                f"sequence of {new_len} tokens exceeds max_pages_per_seq="
                f"{self.max_pages_per_seq} x page_size={self.page_size}")
        with self._lock:
            pages = self._pages_of[slot]
            while len(pages) < need:
                p = self._pop_page_locked()
                self.block_tables[slot, len(pages)] = p
                pages.append(p)
                self.allocations_total += 1

    def advance(self, slot: int, n: int = 1) -> int:
        self.lengths[slot] += n
        return int(self.lengths[slot])

    def release(self, slot: int) -> None:
        """Sequence done: its pages return to the free list, its table
        row points back at the junk page, the slot is reusable."""
        with self._lock:
            self._free.extend(self._pages_of[slot])
            self._pages_of[slot] = []
            self.block_tables[slot, :] = 0
            self.lengths[slot] = 0
            self._active[slot] = False

    def evict(self, slot: int) -> None:
        """Preemption: release, but counted — the engine re-queues the
        victim's request for re-prefill."""
        self.release(slot)
        with self._lock:
            self.evictions_total += 1

    def is_active(self, slot: int) -> bool:
        return self._active[slot]

    # -- introspection -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            in_use = self.usable_pages - len(self._free)
            return {
                "pages_total": self.usable_pages,
                "pages_free": len(self._free),
                "pages_in_use": in_use,
                "page_utilization": (round(in_use / self.usable_pages, 4)
                                     if self.usable_pages else 0.0),
                "active_seqs": sum(1 for a in self._active if a),
                "max_seqs": self.max_seqs,
                "evictions_total": self.evictions_total,
                "page_allocations_total": self.allocations_total,
                "pool_bytes": self.pool_bytes(),
            }

    def check_integrity(self) -> None:
        """Invariant audit: chains and tables mirror each other, no page
        sits in two chains or in a chain and the free list, the junk
        page is never in a chain, free + in-use covers the pool."""
        with self._lock:
            owner: Dict[int, int] = {}
            for slot in range(self.max_seqs):
                pages = self._pages_of[slot]
                if not self._active[slot] and pages:
                    raise AssertionError(f"inactive slot {slot} holds pages")
                for j, p in enumerate(pages):
                    if p == 0:
                        raise AssertionError("junk page 0 inside a chain")
                    if p in owner:
                        raise AssertionError(
                            f"page {p} in slots {owner[p]} and {slot}")
                    owner[p] = slot
                    if int(self.block_tables[slot, j]) != p:
                        raise AssertionError(
                            f"table/chain mismatch at slot {slot} idx {j}")
                if np.any(self.block_tables[slot, len(pages):] != 0):
                    raise AssertionError(
                        f"slot {slot} table points past its chain")
                covered = len(pages) * self.page_size
                if self._active[slot] and int(self.lengths[slot]) > covered:
                    raise AssertionError(
                        f"slot {slot} length {self.lengths[slot]} > "
                        f"allocated {covered}")
            fs = set(self._free)
            if len(fs) != len(self._free):
                raise AssertionError("free list holds duplicates")
            if 0 in fs:
                raise AssertionError("junk page 0 on the free list")
            dup = fs & set(owner)
            if dup:
                raise AssertionError(f"pages both free and in use: {dup}")
            if len(fs) + len(owner) != self.usable_pages:
                raise AssertionError(
                    f"pool leak: {len(fs)} free + {len(owner)} in use != "
                    f"{self.usable_pages}")
