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

**Radix prefix cache** (``prefix_cache=True``, ragged engine only;
``kvcache.py:36-50, :95-510, :681-1000`` there): every page carries a
REFCOUNT (one per sequence chain holding it, plus one if the page is
trie-resident), and full page-aligned token runs are published into a
prefix TRIE keyed by the exact page_size-token tuple each page holds.
``acquire(prompt)`` walks the trie and attaches the matched prefix pages
to the new sequence's block table BY REFERENCE, so a shared prompt
prefills once, while the unmatched suffix gets private pages.
Copy-on-write is structural: the engine only writes positions >= the
sequence length and growth always pops FRESH pages, so a full shared
page is never written. ``release`` returns a page to the free list only
at refcount zero; pool pressure evicts trie-only leaves first (LRU over
a deterministic tick) before admission backpressures or a live sequence
is preempted. The int8 scale planes ride the same page indirection, so a
shared page is a shared quantized page too. The free list pops in the
JAX package's order, so the same operations give the same block tables.

The page-store splice (``kvcache.py:513-676`` there, the disaggregated
tiers' seam): ``export_run(tokens)`` reads the trie-resident pages along
a prompt out of the pools, ``ingest_run`` splices pages fetched from a
store into the pool and the trie, and ``trie_leaf_runs`` names every
root-to-leaf token run (the drain spill). Where the JAX package rebinds
its pool buffers after a jitted scatter, the port writes IN PLACE with
``index_copy_`` into the same tensors (a captured CUDA graph keeps
replaying them), from the engine's loop thread, between steps, after
one pinned H2D copy of the whole run. An export from another thread
waits on the event the loop records after each step
(``mark_written``) before it reads, so it never sees a page whose write
is still in flight on another stream.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple, Union

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


class _TrieNode:
    """One published page: ``key`` is the exact page_size-token tuple
    the page holds, ``page`` the pool page id. Children extend the token
    run by one more full page. ``last_used`` is a monotonic tick (not
    wall time: a deterministic LRU). ``tenant`` is the identity that
    published the page, the per-tenant quota's unit."""

    __slots__ = ("key", "page", "parent", "children", "last_used",
                 "tenant")

    def __init__(self, key, page, parent, tenant="default"):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[tuple, "_TrieNode"] = {}
        self.last_used = 0
        self.tenant = tenant


class PagedKVCache:
    def __init__(self, num_layers: int, num_kv_heads: int, head_dim: int, *,
                 num_pages: int, page_size: int, max_seqs: int,
                 max_pages_per_seq: int,
                 device: Union[str, torch.device] = "cuda",
                 dtype: Union[str, torch.dtype] = torch.float32,
                 prefix_cache: bool = False, prefix_min_pages: int = 1,
                 trie_max_pages: int = 0, tenant_quota_pages: int = 0):
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
        self.prefix_cache = bool(prefix_cache)
        self.prefix_min_pages = max(1, int(prefix_min_pages))
        self.trie_max_pages = max(0, int(trie_max_pages))
        self.tenant_quota_pages = max(0, int(tenant_quota_pages))
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
        # refcounts: one per sequence chain holding the page, plus one if
        # the page is trie-resident; a page is free only at zero
        self._ref = np.zeros(num_pages, np.int64)
        # the prefix trie: the root holds no page; each child edge is
        # one full page keyed by its exact token tuple
        self._root = _TrieNode(None, None, None)
        self._node_of_page: Dict[int, _TrieNode] = {}
        self._tick = 0
        # per-slot publish cursor: how many leading chain pages are
        # trie-resident, and the node at that depth (a publish resumes
        # there instead of re-keying from the root every step)
        self._published_of = [0] * max_seqs
        self._pub_node: List[Optional[_TrieNode]] = [None] * max_seqs
        # a sibling published the same token run onto a DIFFERENT page
        # first: this chain stays private from that depth on
        self._pub_dead = [False] * max_seqs
        self.evictions_total = 0
        self.allocations_total = 0
        # radix counters (radix_stats)
        self.prefix_lookups_total = 0
        self.prefix_hits_total = 0
        self.prefix_hit_tokens_total = 0
        self.prefix_requested_tokens_total = 0
        self.cow_forks_total = 0
        self.leaf_evictions_total = 0
        self.published_pages_total = 0
        # per-tenant trie accounting: pages resident, leaf evictions
        # forced by the tenant's own quota, publishes refused at quota
        self._tenant_pages: Dict[str, int] = {}
        self._tenant_evictions: Dict[str, int] = {}
        self.tenant_quota_rejections_total = 0
        # the page-store splice counters (radix_stats)
        self.exported_pages_total = 0
        self.ingested_pages_total = 0
        # recorded after each step's writes (mark_written): an export on
        # another thread orders its reads after it
        self._written: Optional[torch.cuda.Event] = None

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

    def can_acquire(self, n_tokens: int, prompt=None) -> bool:
        """Could ``n_tokens`` of pages be allocated now: the free list
        and the trie-only pages the allocator may reclaim (LRU leaf
        eviction), the admission check. With ``prompt``, the trie-only
        pages on the prompt's OWN match path are left out: ``acquire``
        attaches them (no longer evictable) while it still pops
        ``n_tokens`` worth of suffix pages."""
        with self._lock:
            excl = set()
            if prompt is not None:
                excl = {nd.page for nd in self._match_nodes(prompt)
                        if int(self._ref[nd.page]) == 1}
            budget = len(self._free) + sum(
                1 for p in self._node_of_page
                if int(self._ref[p]) == 1 and p not in excl)
        return self.pages_needed(n_tokens) <= budget

    def free_slots(self) -> int:
        return sum(1 for a in self._active if not a)

    # -- the prefix trie (radix cache) ---------------------------------------
    def _touch(self, node: _TrieNode) -> None:
        self._tick += 1
        node.last_used = self._tick

    def _page_key(self, tokens, i: int) -> tuple:
        ps = self.page_size
        return tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])

    def _match_nodes(self, tokens) -> List[_TrieNode]:
        """Trie path of the longest page-aligned prefix of ``tokens``,
        capped so that at least one prompt token is left to prefill (the
        step that samples the first output token), and floored at
        ``prefix_min_pages``."""
        if not self.prefix_cache:
            return []
        cap = (len(tokens) - 1) // self.page_size
        nodes: List[_TrieNode] = []
        node = self._root
        for i in range(cap):
            child = node.children.get(self._page_key(tokens, i))
            if child is None:
                break
            nodes.append(child)
            node = child
        if len(nodes) < self.prefix_min_pages:
            return []
        return nodes

    def match_len(self, tokens) -> int:
        """The matched prefix IN TOKENS a prompt would get now. A pure
        peek: no refcount, no LRU touch, no counter."""
        with self._lock:
            return len(self._match_nodes(np.asarray(tokens).reshape(-1))) \
                * self.page_size

    @staticmethod
    def _tenant_key(tenant) -> str:
        return str(tenant) if tenant else "default"

    def _evict_leaf_locked(self, tenant: Optional[str] = None) -> bool:
        """Reclaim ONE trie-only page: the least recently used leaf that
        no live sequence holds (refcount 1, the trie's own). Interior
        nodes and shared pages are never touched. With ``tenant``, only
        that tenant's leaves are candidates."""
        best: Optional[_TrieNode] = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.children:
                    stack.append(child)
                elif (int(self._ref[child.page]) == 1
                      and (tenant is None or child.tenant == tenant)):
                    if best is None or child.last_used < best.last_used:
                        best = child
        if best is None:
            return False
        del best.parent.children[best.key]
        del self._node_of_page[best.page]
        self._ref[best.page] = 0
        self._free.append(best.page)
        self.leaf_evictions_total += 1
        left = self._tenant_pages.get(best.tenant, 0) - 1
        if left > 0:
            self._tenant_pages[best.tenant] = left
        else:
            self._tenant_pages.pop(best.tenant, None)
        if tenant is not None:
            self._tenant_evictions[tenant] = \
                self._tenant_evictions.get(tenant, 0) + 1
        return True

    def _pop_page_locked(self) -> int:
        """One page off the free list; a dry list reclaims trie-only
        leaves (LRU) before it surfaces backpressure."""
        if not self._free and not self._evict_leaf_locked():
            raise PagePoolExhausted("page pool dry (no evictable "
                                    "trie leaves)")
        return self._free.pop()

    def _quota_room_locked(self, tenant: str) -> bool:
        """True once ``tenant`` may insert one more trie page: under its
        quota, or after an LRU leaf of its OWN was evicted. A refusal is
        counted."""
        if not self.tenant_quota_pages:
            return True
        if self._tenant_pages.get(tenant, 0) < self.tenant_quota_pages:
            return True
        if self._evict_leaf_locked(tenant=tenant):
            return True
        self.tenant_quota_rejections_total += 1
        return False

    def publish(self, slot: int, context_tokens, tenant=None) -> int:
        """Insert ``slot``'s full pages into the trie. ``context_tokens``
        covers the sequence's cached context (prompt + emitted); only the
        pages fully below ``lengths[slot]`` publish (positions past the
        length may hold rejected drafts; full pages below it are never
        written again). ``tenant`` attributes the new pages. Returns the
        count of newly published pages; a no-op unless prefix_cache."""
        if not self.prefix_cache:
            return 0
        tn = self._tenant_key(tenant)
        with self._lock:
            if not self._active[slot] or self._pub_dead[slot]:
                return 0
            tokens = np.asarray(context_tokens).reshape(-1)
            full = min(int(self.lengths[slot]),
                       int(tokens.size)) // self.page_size
            idx = self._published_of[slot]
            if full <= idx:
                return 0
            node = self._pub_node[slot] or self._root
            chain = self._pages_of[slot]
            new = 0
            while idx < full:
                key = self._page_key(tokens, idx)
                child = node.children.get(key)
                if child is not None:
                    if child.page != chain[idx]:
                        # a sibling that prefilled the same run published
                        # first; ours stays private (live tables are
                        # never re-pointed)
                        self._pub_dead[slot] = True
                        break
                    self._touch(child)
                else:
                    if (self.trie_max_pages
                            and len(self._node_of_page) >= self.trie_max_pages
                            and not self._evict_leaf_locked()):
                        break   # cap reached, nothing evictable
                    if not self._quota_room_locked(tn):
                        break   # tenant at quota, nothing of its own to evict
                    child = _TrieNode(key, chain[idx], node, tn)
                    node.children[key] = child
                    self._node_of_page[chain[idx]] = child
                    self._ref[chain[idx]] += 1
                    self._touch(child)
                    self._tenant_pages[tn] = self._tenant_pages.get(tn, 0) + 1
                    new += 1
                node = child
                idx += 1
            self._published_of[slot] = idx
            self._pub_node[slot] = node
            self.published_pages_total += new
            return new

    def drop_trie(self) -> int:
        """Flush the whole trie: every trie-resident page loses the
        trie's reference (freed at zero; shared pages survive until
        their sequences release). Live sequences republish from scratch.
        Returns the pages freed. After drop_trie and the release of
        every slot, ``pages_in_use`` is exactly zero."""
        with self._lock:
            freed = 0
            for p in list(self._node_of_page):
                self._ref[p] -= 1
                if self._ref[p] == 0:
                    self._free.append(p)
                    freed += 1
            self._node_of_page.clear()
            self._root.children.clear()
            self._tenant_pages.clear()
            for s in range(self.max_seqs):
                self._published_of[s] = 0
                self._pub_node[s] = self._root if self._active[s] else None
                self._pub_dead[s] = False
            return freed

    def trie_pages(self) -> int:
        with self._lock:
            return len(self._node_of_page)

    def reclaimable_pages(self, slot: int) -> int:
        """Pages that evicting ``slot`` would give back: those only this
        sequence holds, net of the trie's reference (a trie-resident
        page drops to trie-only on release, and leaf eviction reclaims
        it). The engine's victim ranking."""
        with self._lock:
            return sum(
                1 for p in self._pages_of[slot]
                if int(self._ref[p])
                - (1 if p in self._node_of_page else 0) == 1)

    # -- disagg splice path (page store <-> pool) ----------------------------
    def mark_written(self) -> None:
        """Record, on the caller's stream, that the pool writes launched
        so far are ordered before any later export. Called by the
        engine's loop after every step; a no-op off CUDA."""
        if self.device.type == "cuda" and self._k_pages is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._written = ev

    def export_run(self, tokens, max_pages: Optional[int] = None, *,
                   host: bool = True):
        """Read the trie-resident pages along ``tokens``' page-aligned
        prefix out of the pools, uncapped (a spill wants every full
        page). Returns ``(n_pages, k_run, v_run, k_scales, v_scales)``
        with k/v ``[n, L, KVH, ps, hd]`` in the pool dtype and scales
        ``[n, L, KVH, ps]`` (None for float pools): numpy arrays, or
        tensors on the pools' device with ``host=False``. Safe against
        a running step from any thread: full trie-resident pages are
        never written again, and the reads wait on the last step's
        event (``mark_written``)."""
        empty = (0, None, None, None, None)
        if not self.prefix_cache:
            return empty
        tokens = np.asarray(tokens).reshape(-1)
        with self._lock:
            if self._k_pages is None:
                return empty
            pids: List[int] = []
            node = self._root
            for i in range(int(tokens.size) // self.page_size):
                child = node.children.get(self._page_key(tokens, i))
                if child is None:
                    break
                self._touch(child)
                pids.append(child.page)
                node = child
                if max_pages and len(pids) >= max_pages:
                    break
            written = self._written
            self.exported_pages_total += len(pids)
        if not pids:
            return empty
        with torch.no_grad():
            if written is not None:
                torch.cuda.current_stream(self.device).wait_event(written)
            sel = torch.tensor(pids, dtype=torch.long, device=self.device)

            def gather(bufs):
                # [L, KVH, n, ...] -> [n, L, KVH, ...]
                g = torch.stack([b.index_select(1, sel) for b in bufs])
                g = g.movedim(2, 0).contiguous()
                return g.cpu().numpy() if host else g

            k_run, v_run = gather(self._k_pages), gather(self._v_pages)
            k_sc = v_sc = None
            if self.quantized:
                k_sc, v_sc = gather(self._k_scales), gather(self._v_scales)
        return len(pids), k_run, v_run, k_sc, v_sc

    def ingest_run(self, tokens, k_run, v_run, k_scales=None,
                   v_scales=None, *, tenant=None) -> int:
        """Splice externally produced full pages (a page-store fetch)
        into the pool and the trie, so that the next ``acquire``
        attaches them by reference and resumes at the matched length.
        Layouts as ``export_run``'s, already in the POOL dtype (int8
        pools take int8 bodies and float32 scale planes verbatim).
        Pages already trie-resident are skipped; the trie cap, the
        tenant quota and pool pressure truncate the run (a shorter
        match, never a wrong one). Must run on the engine's loop thread
        between steps. Returns the pages ingested."""
        if not self.prefix_cache:
            return 0
        tokens = np.asarray(tokens).reshape(-1)
        k_run = np.asarray(k_run)
        v_run = np.asarray(v_run)
        n_avail = min(int(tokens.size) // self.page_size,
                      int(k_run.shape[0]), int(v_run.shape[0]))
        if n_avail <= 0:
            return 0
        want = (self.num_layers, self.num_kv_heads, self.page_size,
                self.head_dim)
        if k_run.shape[1:] != want or v_run.shape[1:] != want:
            raise ValueError(
                f"ingest_run: page shape {k_run.shape[1:]} != "
                f"[L,KVH,ps,hd] {want}")
        if self.quantized and (k_scales is None or v_scales is None):
            raise ValueError("ingest_run: int8 pool needs scale planes")
        self._ensure_buffers()
        tn = self._tenant_key(tenant)
        fresh: List[Tuple[int, int]] = []   # (run index, page id)
        with self._lock:
            node = self._root
            for i in range(n_avail):
                key = self._page_key(tokens, i)
                child = node.children.get(key)
                if child is not None:
                    self._touch(child)
                    node = child
                    continue
                if (self.trie_max_pages
                        and len(self._node_of_page) >= self.trie_max_pages
                        and not self._evict_leaf_locked()):
                    break
                if not self._quota_room_locked(tn):
                    break
                try:
                    p = self._pop_page_locked()
                except PagePoolExhausted:
                    break   # partial ingest: shorter match, never wrong
                child = _TrieNode(key, p, node, tn)
                node.children[key] = child
                self._node_of_page[p] = child
                self._ref[p] = 1
                self._touch(child)
                self._tenant_pages[tn] = self._tenant_pages.get(tn, 0) + 1
                fresh.append((i, p))
                node = child
            self.ingested_pages_total += len(fresh)
        if not fresh:
            return 0
        idx = [i for i, _ in fresh]
        runs = [(self._k_pages, k_run), (self._v_pages, v_run)]
        if self.quantized:
            runs += [(self._k_scales, np.asarray(k_scales, np.float32)),
                     (self._v_scales, np.asarray(v_scales, np.float32))]
        cuda = self.device.type == "cuda"
        with torch.no_grad():
            sel = torch.tensor([p for _, p in fresh], dtype=torch.long,
                               device=self.device)
            for bufs, run in runs:
                # one (pinned) H2D copy of the fresh pages of the run,
                # then an in-place write per layer into the same tensors
                host = torch.from_numpy(np.ascontiguousarray(run[idx]))
                if cuda:
                    host = host.pin_memory()
                dev = host.to(self.device, bufs[0].dtype, non_blocking=cuda)
                for li, buf in enumerate(bufs):
                    buf.index_copy_(1, sel, dev[:, li].movedim(0, 1))
        # a pinned staging tensor freed here is not reused before its
        # copy ends (the caching host allocator records the stream)
        return len(fresh)

    def trie_leaf_runs(self) -> List[np.ndarray]:
        """Token runs (root-to-leaf concatenated page keys) covering
        every trie leaf: the drain spill's walk."""
        with self._lock:
            runs: List[np.ndarray] = []
            stack: List[Tuple[_TrieNode, List[int]]] = [(self._root, [])]
            while stack:
                node, path = stack.pop()
                if node is not self._root:
                    path = path + list(node.key)
                if node.children:
                    for child in node.children.values():
                        stack.append((child, path))
                elif path:
                    runs.append(np.asarray(path, np.int64))
            return runs

    # -- sequence lifecycle --------------------------------------------------
    def acquire(self, prompt_tokens) -> Tuple[int, int]:
        """Claim a batch slot + pages for a prompt, attaching any
        trie-matched prefix pages BY REFERENCE (prefill starts at the
        fork point). Returns ``(slot, matched_tokens)``, matched_tokens
        page-aligned and < len(prompt). Raises PagePoolExhausted when
        slots or pages are not available *right now* (backpressure, not
        rejection), with every reference rolled back. With prefix_cache
        off this is ``allocate_slot``."""
        tokens = np.asarray(prompt_tokens).reshape(-1)
        return self._claim(int(tokens.size), tokens)

    def allocate_slot(self, n_tokens: int) -> int:
        """Claim a batch slot + pages for an n_tokens prompt with no trie
        lookup. Returns the slot id; raises PagePoolExhausted when pages
        or slots are not available *right now*."""
        return self._claim(int(n_tokens), None)[0]

    def _claim(self, n: int, tokens) -> Tuple[int, int]:
        """``acquire`` (``tokens`` given) and ``allocate_slot`` (None: no
        lookup, no radix counter)."""
        need_total = self.pages_needed(n)
        if need_total > self.max_pages_per_seq:
            raise ValueError(
                f"{n} tokens need {need_total} pages > max_pages_per_seq="
                f"{self.max_pages_per_seq}")
        with self._lock:
            slot = next((i for i, a in enumerate(self._active) if not a),
                        None)
            if slot is None:
                raise PagePoolExhausted("no free decode slots")
            nodes = [] if tokens is None else self._match_nodes(tokens)
            if self.prefix_cache and tokens is not None:
                self.prefix_lookups_total += 1
                self.prefix_requested_tokens_total += n
            # bump the matched path FIRST: refcount >= 2 shields those
            # pages from the leaf eviction the suffix allocation may make
            for nd in nodes:
                self._ref[nd.page] += 1
                self._touch(nd)
            priv: List[int] = []
            try:
                for _ in range(need_total - len(nodes)):
                    p = self._pop_page_locked()
                    self._ref[p] = 1
                    priv.append(p)
            except PagePoolExhausted:
                for p in priv:
                    self._ref[p] = 0
                    self._free.append(p)
                for nd in nodes:
                    self._ref[nd.page] -= 1
                raise
            pages = [nd.page for nd in nodes] + priv
            self._pages_of[slot] = pages
            row = self.block_tables[slot]
            row[:] = 0
            row[:len(pages)] = pages
            # the matched prefix's K/V is resident: the sequence starts
            # at length = matched (the fork point)
            self.lengths[slot] = len(nodes) * self.page_size
            self._active[slot] = True
            self.allocations_total += len(priv)
            self._published_of[slot] = len(nodes)
            self._pub_node[slot] = nodes[-1] if nodes else self._root
            self._pub_dead[slot] = False
            if nodes:
                self.prefix_hits_total += 1
                self.prefix_hit_tokens_total += len(nodes) * self.page_size
                # the first private page past the shared prefix is the
                # copy-on-write fork
                self.cow_forks_total += 1
            return slot, len(nodes) * self.page_size

    def ensure_capacity(self, slot: int, new_len: int) -> None:
        """Grow slot's page chain to cover new_len tokens. Growth pops
        FRESH private pages, never a shared one (what makes
        copy-on-write structural); raises PagePoolExhausted when the pool
        is dry even after trie-leaf reclaim (the engine evicts)."""
        need = self.pages_needed(new_len)
        if new_len > self.max_pages_per_seq * self.page_size:
            raise ValueError(
                f"sequence of {new_len} tokens exceeds max_pages_per_seq="
                f"{self.max_pages_per_seq} x page_size={self.page_size}")
        with self._lock:
            pages = self._pages_of[slot]
            while len(pages) < need:
                p = self._pop_page_locked()
                self._ref[p] = 1
                self.block_tables[slot, len(pages)] = p
                pages.append(p)
                self.allocations_total += 1

    def advance(self, slot: int, n: int = 1) -> int:
        self.lengths[slot] += n
        return int(self.lengths[slot])

    def release(self, slot: int) -> None:
        """Sequence done: every chain page drops one reference and
        reaches the free list only at zero (a page the trie or a sibling
        still holds survives). The table row points back at the junk
        page; the slot is reusable."""
        with self._lock:
            for p in self._pages_of[slot]:
                self._ref[p] -= 1
                if self._ref[p] == 0:
                    self._free.append(p)
            self._pages_of[slot] = []
            self.block_tables[slot, :] = 0
            self.lengths[slot] = 0
            self._active[slot] = False
            self._published_of[slot] = 0
            self._pub_node[slot] = None
            self._pub_dead[slot] = False

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

    def radix_stats(self) -> Dict[str, Any]:
        """The radix gauges (the engine's ``stats()["radix"]``): prefix
        hit volume and rate, the shared / private / trie-resident page
        split, copy-on-write forks, leaf evictions and the per-tenant
        trie accounting."""
        with self._lock:
            chained: Dict[int, int] = {}
            for slot in range(self.max_seqs):
                for p in self._pages_of[slot]:
                    chained[p] = chained.get(p, 0) + 1
            shared = sum(1 for p in chained if int(self._ref[p]) >= 2)
            private = sum(1 for p in chained if int(self._ref[p]) == 1)
            req = self.prefix_requested_tokens_total
            return {
                "enabled": int(self.prefix_cache),
                "prefix_lookups_total": self.prefix_lookups_total,
                "prefix_hits_total": self.prefix_hits_total,
                "prefix_hit_tokens_total": self.prefix_hit_tokens_total,
                "prefix_requested_tokens_total": req,
                "prefix_hit_rate": (
                    round(self.prefix_hit_tokens_total / req, 4)
                    if req else 0.0),
                "shared_pages": shared,
                "private_pages": private,
                "trie_pages": len(self._node_of_page),
                "cow_forks_total": self.cow_forks_total,
                "leaf_evictions_total": self.leaf_evictions_total,
                "published_pages_total": self.published_pages_total,
                "ingested_pages_total": self.ingested_pages_total,
                "exported_pages_total": self.exported_pages_total,
                "tenant_quota_pages": self.tenant_quota_pages,
                "tenant_quota_rejections_total":
                    self.tenant_quota_rejections_total,
                "tenant_pages": dict(self._tenant_pages),
                "tenant_leaf_evictions": dict(self._tenant_evictions),
            }

    def check_integrity(self) -> None:
        """Invariant audit: chains and tables mirror each other (nothing
        past a chain), the trie is structurally sound, every page's
        refcount equals (chains holding it) + (1 if trie-resident), a
        page in two chains is trie-resident, the junk page is in no chain
        and not free, free + in use covers the pool exactly."""
        with self._lock:
            holders: Dict[int, List[int]] = {}
            for slot in range(self.max_seqs):
                pages = self._pages_of[slot]
                if not self._active[slot] and pages:
                    raise AssertionError(f"inactive slot {slot} holds pages")
                if len(set(pages)) != len(pages):
                    raise AssertionError(
                        f"slot {slot} chain repeats a page: {pages}")
                for j, p in enumerate(pages):
                    if p == 0:
                        raise AssertionError("junk page 0 inside a chain")
                    holders.setdefault(p, []).append(slot)
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
            # trie structure: links coherent, a page at most once,
            # node_of_page exactly the trie
            trie: Dict[int, _TrieNode] = {}
            stack = [self._root]
            while stack:
                node = stack.pop()
                for key, child in node.children.items():
                    if child.parent is not node or child.key != key:
                        raise AssertionError(
                            f"trie link broken at page {child.page}")
                    p = child.page
                    if not isinstance(p, int) or p <= 0:
                        raise AssertionError(f"trie node with bad page {p!r}")
                    if p in trie:
                        raise AssertionError(f"page {p} twice in the trie")
                    if len(child.key) != self.page_size:
                        raise AssertionError(
                            f"trie key of {len(child.key)} tokens != "
                            f"page_size {self.page_size}")
                    trie[p] = child
                    stack.append(child)
            if set(trie) != set(self._node_of_page):
                raise AssertionError(
                    "node_of_page desynced from the trie: "
                    f"{set(trie) ^ set(self._node_of_page)}")
            for p, nd in trie.items():
                if self._node_of_page[p] is not nd:
                    raise AssertionError(f"node_of_page[{p}] is a stale node")
            # per-tenant page counts mirror the trie
            tcount: Dict[str, int] = {}
            for nd in trie.values():
                tcount[nd.tenant] = tcount.get(nd.tenant, 0) + 1
            if tcount != self._tenant_pages:
                raise AssertionError(
                    f"tenant page accounting desynced: {tcount} != "
                    f"{self._tenant_pages}")
            # refcounts: chains + trie residency, nothing else
            for p in range(1, self.num_pages):
                expected = len(holders.get(p, ())) + (1 if p in trie else 0)
                if int(self._ref[p]) != expected:
                    raise AssertionError(
                        f"refcount leak: page {p} ref {int(self._ref[p])} "
                        f"!= {expected} (chains {holders.get(p, [])}, "
                        f"trie={p in trie})")
            for p, slots in holders.items():
                if len(slots) > 1 and p not in trie:
                    raise AssertionError(
                        f"page {p} shared by slots {slots} without trie "
                        "residency")
            # publish cursors stay inside the trie
            for slot in range(self.max_seqs):
                if not self._active[slot]:
                    continue
                pub = self._published_of[slot]
                pages = self._pages_of[slot]
                if pub > len(pages):
                    raise AssertionError(
                        f"slot {slot} published {pub} > chain {len(pages)}")
                for j in range(pub):
                    if pages[j] not in trie:
                        raise AssertionError(
                            f"slot {slot} counts page {pages[j]} as "
                            "published but it is not trie-resident")
            # free list: unique, disjoint from use, refcount zero
            fs = set(self._free)
            if len(fs) != len(self._free):
                raise AssertionError("free list holds duplicates")
            if 0 in fs:
                raise AssertionError("junk page 0 on the free list")
            in_use = set(holders) | set(trie)
            dup = fs & in_use
            if dup:
                raise AssertionError(f"pages both free and in use: {dup}")
            bad = [p for p in fs if int(self._ref[p]) != 0]
            if bad:
                raise AssertionError(f"free pages with refs: {bad}")
            if len(fs) + len(in_use) != self.usable_pages:
                raise AssertionError(
                    f"page leak: {len(fs)} free + {len(in_use)} in use "
                    f"!= {self.usable_pages}")
