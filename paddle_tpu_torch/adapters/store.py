"""AdapterStore — paged, device-resident LoRA (A, B) factor pools
(counterpart of ``paddle_tpu/adapters/store.py``: ``AdapterStore``
:131, its errors :78-99).

Every target weight of the model gets rank-bucketed factor POOLS
(``A [slots, K, r]``, ``B [slots, r, N]`` per bucket, and one
``scale [slots]`` = alpha / rank vector per bucket); each batch row
names its adapter by SLOT, one column per bucket, exactly as a block
table names pages. Slot 0 of every bucket is the zero adapter (zero
factors, scale 0): base-only rows, rows of another bucket and idle
lanes point there.

* The pools are torch tensors written IN PLACE on their device
  (``attach(device)`` moves them there once); the JAX store instead
  pushes host mirrors into a Scope on every change.
* ``upload`` picks the smallest bucket whose rank fits and zero-pads
  the factors to it; partial adapters (a subset of targets) are legal.
* Slots are refcounted: the engine acquires at submit and releases at
  the request's end; ``evict`` refuses a pinned adapter unless
  ``force`` (the engine then fails that adapter's rows at its next
  step).
* A full bucket evicts its least recently used idle adapter first;
  a tenant at ``tenant_quota`` evicts its own least recently used idle
  adapter, and ``AdapterQuotaExceeded`` is raised only when all of its
  adapters are pinned.

``for_model`` builds the store from the model's target table
(``rewrite.lora_targets``), the counterpart of ``for_program`` :188.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.lora import lora_slot_bytes

__all__ = ["AdapterStore", "AdapterError", "AdapterMissing",
           "AdapterPoolFull", "AdapterQuotaExceeded", "AdapterInUse",
           "DEFAULT_RANK_BUCKETS"]

DEFAULT_RANK_BUCKETS = (8, 16)


class AdapterError(RuntimeError):
    """Base for adapter-store failures."""


class AdapterMissing(AdapterError):
    """The named adapter is not resident (upload it first)."""


class AdapterPoolFull(AdapterError):
    """No free slot and every resident adapter in the bucket is pinned
    by in-flight rows."""


class AdapterQuotaExceeded(AdapterError):
    """The tenant is at its adapter quota and owns no idle adapter to
    evict."""


class AdapterInUse(AdapterError):
    """Evict refused: the slot is referenced by in-flight rows."""


class _Resident:
    __slots__ = ("adapter_id", "bucket", "slot", "rank", "alpha", "tenant",
                 "refcount", "last_used", "targets", "bytes")

    def __init__(self, adapter_id, bucket, slot, rank, alpha, tenant,
                 targets, nbytes):
        self.adapter_id = adapter_id
        self.bucket = bucket          # index into rank_buckets
        self.slot = slot
        self.rank = rank              # the uploaded rank
        self.alpha = alpha
        self.tenant = tenant
        self.refcount = 0
        self.last_used = time.monotonic()
        self.targets = targets        # tuple of covered target names
        self.bytes = nbytes


class AdapterStore:
    """See the module docstring. Thread-safe: uploads and evictions may
    come from any thread while the engine loop reads slot rows."""

    def __init__(self, targets: Dict[str, Tuple[int, int]], *,
                 rank_buckets: Sequence[int] = DEFAULT_RANK_BUCKETS,
                 max_bytes: int = 0,
                 slots_per_bucket: Optional[int] = None,
                 tenant_quota: int = 0,
                 device: Union[str, torch.device] = "cpu"):
        if not targets:
            raise AdapterError(
                "AdapterStore: no target weights (the model has no "
                "eligible matmul weights — see rewrite_for_lora)")
        self.targets = {str(n): (int(k), int(nn))
                        for n, (k, nn) in targets.items()}
        self.rank_buckets = tuple(sorted(int(r) for r in rank_buckets))
        if not self.rank_buckets or min(self.rank_buckets) < 1:
            raise AdapterError(
                f"AdapterStore: bad rank_buckets {rank_buckets!r}")
        self.tenant_quota = int(tenant_quota)
        self._slot_bytes = [
            sum(lora_slot_bytes(k, n, rb) for k, n in self.targets.values())
            for rb in self.rank_buckets]
        if slots_per_bucket is not None:
            ns = [max(2, int(slots_per_bucket) + 1)] * len(self.rank_buckets)
        else:
            per = int(max_bytes) // max(len(self.rank_buckets), 1)
            # slot 0 is the zero adapter; never fewer than one usable
            # slot a bucket
            ns = [max(2, 1 + per // sb) for sb in self._slot_bytes]
        self.slots = tuple(ns)
        self.max_bytes = int(max_bytes)
        self.device = torch.device(device)
        self._lock = threading.RLock()
        self._resident: Dict[str, _Resident] = {}
        self._slot_owner: List[Dict[int, str]] = [
            {} for _ in self.rank_buckets]
        # the pools: (target, bucket) -> A [S, K, rb] / B [S, rb, N]
        # float32, and per bucket scale [S]
        self._a: Dict[Tuple[str, int], torch.Tensor] = {}
        self._b: Dict[Tuple[str, int], torch.Tensor] = {}
        self._scale: List[torch.Tensor] = []
        for bi, rb in enumerate(self.rank_buckets):
            s = self.slots[bi]
            for t, (k, n) in self.targets.items():
                self._a[(t, bi)] = torch.zeros((s, k, rb), device=self.device)
                self._b[(t, bi)] = torch.zeros((s, rb, n), device=self.device)
            self._scale.append(torch.zeros(s, device=self.device))
        self._counters = dict(uploads=0, evictions=0, lru_evictions=0,
                              quota_evictions=0, evict_refusals=0,
                              misses=0)
        # residency and pool accounting export as paddle_adapter_*{store=}
        from ..observability import watch_adapters

        watch_adapters(self)

    @classmethod
    def for_model(cls, model, **kw) -> "AdapterStore":
        """A store whose targets are exactly the weights
        ``rewrite_for_lora`` repoints in ``model`` (a ``GPTLM`` or its
        ``RaggedStepModel``; dense or already quantized), on the
        model's device unless ``device`` is given."""
        from .rewrite import lora_targets

        lm = getattr(model, "lm", model)
        kw.setdefault("device", lm.device)
        return cls({n: (k, nn) for n, (k, nn, _q) in
                    lora_targets(lm).items()}, **kw)

    @property
    def n_buckets(self) -> int:
        return len(self.rank_buckets)

    def attach(self, device: Union[str, torch.device]) -> None:
        """Move every pool to ``device`` (once; later uploads write
        there in place)."""
        device = torch.device(device)
        with self._lock:
            if device == self.device:
                return
            self._a = {k: v.to(device) for k, v in self._a.items()}
            self._b = {k: v.to(device) for k, v in self._b.items()}
            self._scale = [v.to(device) for v in self._scale]
            self.device = device

    def pools(self, target: str
              ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                         List[torch.Tensor]]:
        """(A pools, B pools, scale vectors) of ``target``, one of each
        per bucket in bucket order."""
        nb = range(self.n_buckets)
        return ([self._a[(target, j)] for j in nb],
                [self._b[(target, j)] for j in nb], list(self._scale))

    # -- residency -----------------------------------------------------------

    def upload(self, adapter_id: str, factors: Dict[str, Tuple[Any, Any]],
               *, alpha: Optional[float] = None,
               tenant: Optional[str] = None) -> Dict[str, Any]:
        """Make ``adapter_id`` resident. ``factors`` maps target weight
        name -> (A [K, r], B [r, N]) (arrays or tensors); a subset of
        targets is legal. Returns the residency row."""
        adapter_id = str(adapter_id)
        if not factors:
            raise AdapterError(f"upload {adapter_id!r}: empty factors")
        prep = {}
        rank = None
        for t, (a, b) in factors.items():
            if t not in self.targets:
                raise AdapterError(
                    f"upload {adapter_id!r}: unknown target {t!r} "
                    f"(known: {sorted(self.targets)})")
            k, n = self.targets[t]
            a = torch.as_tensor(a, dtype=torch.float32)
            b = torch.as_tensor(b, dtype=torch.float32)
            if a.dim() != 2 or b.dim() != 2 or a.shape[0] != k \
                    or b.shape[1] != n or a.shape[1] != b.shape[0]:
                raise AdapterError(
                    f"upload {adapter_id!r}: target {t!r} wants "
                    f"A [{k}, r] @ B [r, {n}], got A {tuple(a.shape)} "
                    f"B {tuple(b.shape)}")
            if rank is None:
                rank = int(a.shape[1])
            elif int(a.shape[1]) != rank:
                raise AdapterError(
                    f"upload {adapter_id!r}: mixed ranks across targets "
                    f"({rank} vs {a.shape[1]} at {t!r}) — one adapter, "
                    "one rank")
            prep[t] = (a, b)
        bucket = next((i for i, rb in enumerate(self.rank_buckets)
                       if rb >= rank), None)
        if bucket is None:
            raise AdapterError(
                f"upload {adapter_id!r}: rank {rank} exceeds the largest "
                f"rank bucket {self.rank_buckets[-1]} "
                "(adapter_rank_buckets flag)")
        scale = float(alpha if alpha is not None else rank) / float(rank)
        with self._lock:
            if adapter_id in self._resident:
                r = self._resident[adapter_id]
                if r.refcount:
                    raise AdapterInUse(
                        f"upload {adapter_id!r}: already resident with "
                        f"{r.refcount} in-flight rows — evict first")
                self._evict_locked(adapter_id)
            if tenant and self.tenant_quota > 0:
                self._enforce_tenant_quota(tenant)
            slot = self._take_slot(bucket, adapter_id)
            for t in self.targets:      # a previous occupant's rows go
                self._a[(t, bucket)][slot].zero_()
                self._b[(t, bucket)][slot].zero_()
            for t, (a, b) in prep.items():
                self._a[(t, bucket)][slot, :, :rank].copy_(a)
                self._b[(t, bucket)][slot, :rank, :].copy_(b)
            self._scale[bucket][slot] = scale
            res = _Resident(adapter_id, bucket, slot, rank,
                            float(alpha if alpha is not None else rank),
                            tenant, tuple(sorted(prep)),
                            self._slot_bytes[bucket])
            self._resident[adapter_id] = res
            self._slot_owner[bucket][slot] = adapter_id
            self._counters["uploads"] += 1
            return self._row(res)

    def _take_slot(self, bucket: int, for_id: str) -> int:
        owner = self._slot_owner[bucket]
        for s in range(1, self.slots[bucket]):
            if s not in owner:
                return s
        # bucket full: evict the least recently used idle resident
        idle = sorted((r for r in self._resident.values()
                       if r.bucket == bucket and r.refcount == 0),
                      key=lambda r: r.last_used)
        if not idle:
            raise AdapterPoolFull(
                f"upload {for_id!r}: rank-{self.rank_buckets[bucket]} "
                f"bucket full ({self.slots[bucket] - 1} slots) and every "
                "resident adapter is pinned by in-flight rows")
        victim = idle[0]
        self._evict_locked(victim.adapter_id)
        self._counters["lru_evictions"] += 1
        return victim.slot

    def _enforce_tenant_quota(self, tenant: str) -> None:
        mine = [r for r in self._resident.values() if r.tenant == tenant]
        if len(mine) < self.tenant_quota:
            return
        idle = sorted((r for r in mine if r.refcount == 0),
                      key=lambda r: r.last_used)
        if not idle:
            raise AdapterQuotaExceeded(
                f"tenant {tenant!r} is at its adapter quota "
                f"({self.tenant_quota}) and every resident adapter is "
                "pinned by in-flight rows")
        self._evict_locked(idle[0].adapter_id)
        self._counters["quota_evictions"] += 1

    def evict(self, adapter_id: str, force: bool = False) -> Dict[str, Any]:
        with self._lock:
            r = self._resident.get(str(adapter_id))
            if r is None:
                self._counters["misses"] += 1
                raise AdapterMissing(f"evict: {adapter_id!r} not resident")
            if r.refcount and not force:
                self._counters["evict_refusals"] += 1
                raise AdapterInUse(
                    f"evict {adapter_id!r}: {r.refcount} in-flight rows "
                    "reference it (force=True to tear down anyway)")
            row = self._row(r)
            self._evict_locked(r.adapter_id)
            return row

    def _evict_locked(self, adapter_id: str) -> None:
        r = self._resident.pop(adapter_id)
        self._slot_owner[r.bucket].pop(r.slot, None)
        for t in self.targets:
            self._a[(t, r.bucket)][r.slot].zero_()
            self._b[(t, r.bucket)][r.slot].zero_()
        self._scale[r.bucket][r.slot] = 0.0
        self._counters["evictions"] += 1

    # -- per-request pinning -------------------------------------------------

    def acquire(self, adapter_id: str) -> None:
        """Pin ``adapter_id`` for one in-flight request; raises
        AdapterMissing when it is not resident."""
        with self._lock:
            r = self._resident.get(str(adapter_id))
            if r is None:
                self._counters["misses"] += 1
                raise AdapterMissing(
                    f"adapter {adapter_id!r} is not resident — upload it "
                    "first")
            r.refcount += 1
            r.last_used = time.monotonic()

    def release(self, adapter_id: str) -> None:
        with self._lock:
            r = self._resident.get(str(adapter_id))
            if r is not None and r.refcount > 0:
                r.refcount -= 1
                r.last_used = time.monotonic()

    def is_resident(self, adapter_id: str) -> bool:
        """Residency probe without side effects (no pin, no LRU touch)."""
        with self._lock:
            return str(adapter_id) in self._resident

    def slots_row(self, adapter_id: Optional[str]) -> np.ndarray:
        """The [n_buckets] int32 slot vector one batch row feeds: zeros
        for a base-only row, else the adapter's slot in its bucket's
        column."""
        row = np.zeros(self.n_buckets, np.int32)
        if adapter_id is None:
            return row
        with self._lock:
            r = self._resident.get(str(adapter_id))
            if r is None:
                self._counters["misses"] += 1
                raise AdapterMissing(
                    f"adapter {adapter_id!r} vanished from the store "
                    "while rows were in flight (force-evicted?)")
            r.last_used = time.monotonic()
            row[r.bucket] = r.slot
            return row

    # -- introspection -------------------------------------------------------

    def _row(self, r: _Resident) -> Dict[str, Any]:
        return {"id": r.adapter_id, "rank": r.rank,
                "rank_bucket": self.rank_buckets[r.bucket],
                "slot": r.slot, "alpha": r.alpha, "tenant": r.tenant,
                "refcount": r.refcount, "bytes": r.bytes,
                "targets": list(r.targets)}

    def resident(self) -> List[Dict[str, Any]]:
        """One row (id, rank, bucket, slot, refcount, bytes ...) per
        resident adapter, by id."""
        with self._lock:
            return [self._row(r) for r in
                    sorted(self._resident.values(),
                           key=lambda r: r.adapter_id)]

    def used_bytes(self) -> int:
        with self._lock:
            return sum(r.bytes for r in self._resident.values())

    def capacity_bytes(self) -> int:
        return sum((s - 1) * sb
                   for s, sb in zip(self.slots, self._slot_bytes))

    def stats_numeric(self) -> Dict[str, float]:
        with self._lock:
            c = dict(self._counters)
            return {
                "resident": float(len(self._resident)),
                "pinned": float(sum(1 for r in self._resident.values()
                                    if r.refcount)),
                "active_refs": float(sum(r.refcount for r in
                                         self._resident.values())),
                "used_bytes": float(sum(r.bytes for r in
                                        self._resident.values())),
                "capacity_bytes": float(self.capacity_bytes()),
                "capacity_slots": float(sum(s - 1 for s in self.slots)),
                "uploads_total": float(c["uploads"]),
                "evictions_total": float(c["evictions"]),
                "lru_evictions_total": float(c["lru_evictions"]),
                "quota_evictions_total": float(c["quota_evictions"]),
                "evict_refusals_total": float(c["evict_refusals"]),
                "misses_total": float(c["misses"]),
            }
