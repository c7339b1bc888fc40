"""Admission control: priority classes, tenant quotas, bounded queues
(the counterpart of ``paddle_tpu/traffic/admission.py``).

The plain serving story admitted every request into ONE bounded FIFO
and rejected when it filled. That is the whole overload behavior a
single-tenant demo needs and none of what a multi-tenant production
front end needs: no way to say "this request is a human waiting and
that one is a nightly batch job", no way to stop one noisy tenant from
filling the queue for everyone, and no signal back to the client
beyond "try again sometime".

This module holds the admission-side vocabulary the controller
(controller.py) schedules over:

* **Priority classes** — ``interactive`` / ``batch`` / ``best_effort``,
  strict-priority order. A request declares its class in metadata
  (HTTP ``X-Priority`` header or payload field); unknown classes admit
  as ``batch``.
* **Token-bucket tenant quotas** — each tenant drains a
  ``TokenBucket`` (rate = admits/sec, burst = bucket depth) resolved
  from request metadata (``X-Tenant``). A dry bucket sheds the request
  at admission with a Retry-After computed from the refill rate —
  quota enforcement costs O(1) and never queues.
* **Per-class / per-tenant bounded queues** — ``ClassQueues`` keeps
  one FIFO per (class, tenant) with a per-class depth bound, so one
  tenant's backlog inside a class cannot evict another's (dequeue
  round-robins tenants through oldest-first pick) and a full class
  sheds instead of growing.

``TrafficConfig.from_flags()`` builds the whole admission policy from
the ``traffic_*`` live flags (flags.py); every field is overridable
per controller.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "CLASSES", "INTERACTIVE", "BATCH", "BEST_EFFORT", "class_index",
    "normalize_class", "TokenBucket", "TenantSpec", "parse_tenants",
    "parse_adapter_quotas", "TrafficConfig", "ClassQueues",
]

# strict-priority order: lower index preempts higher at dispatch
INTERACTIVE = "interactive"
BATCH = "batch"
BEST_EFFORT = "best_effort"
CLASSES: Tuple[str, ...] = (INTERACTIVE, BATCH, BEST_EFFORT)
_CLASS_INDEX = {c: i for i, c in enumerate(CLASSES)}


def class_index(name: str) -> int:
    return _CLASS_INDEX[name]


def normalize_class(name: Optional[str]) -> str:
    """Metadata is client input: an unknown/absent class must admit
    (as ``batch``, the middle ground), never 500."""
    if not name:
        return BATCH
    name = str(name).strip().lower()
    return name if name in _CLASS_INDEX else BATCH


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/sec refill up to
    ``burst``; ``try_take`` is the admission check, ``time_until``
    the Retry-After for a shed. ``rate <= 0`` means unlimited (the
    bucket always admits). ``clock`` is injectable for deterministic
    tests (fake time)."""

    __slots__ = ("rate", "burst", "_clock", "_tokens", "_t", "_lock")

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst) if burst and burst > 0 else max(
            1.0, self.rate)
        self._clock = clock
        self._tokens = self.burst
        self._t = clock()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = self._clock()
        if now > self._t:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
        self._t = now

    def try_take(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def time_until(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (0 when they
        already are) — the honest Retry-After for a quota shed."""
        if self.rate <= 0:
            return 0.0
        with self._lock:
            self._refill_locked()
            deficit = n - self._tokens
            return max(0.0, deficit / self.rate)

    def available(self) -> float:
        if self.rate <= 0:
            return float("inf")
        with self._lock:
            self._refill_locked()
            return self._tokens


class TenantSpec:
    """One tenant's admission contract: token-bucket rate/burst and
    the class its requests default to when they don't declare one."""

    __slots__ = ("name", "rate", "burst", "default_class")

    def __init__(self, name: str, rate: float = 0.0,
                 burst: Optional[float] = None,
                 default_class: str = BATCH):
        self.name = str(name)
        self.rate = float(rate)
        self.burst = float(burst) if burst else None
        self.default_class = normalize_class(default_class)

    def make_bucket(self, clock=time.monotonic) -> TokenBucket:
        return TokenBucket(self.rate, self.burst, clock=clock)

    def __repr__(self):
        return (f"TenantSpec({self.name!r}, rate={self.rate}, "
                f"burst={self.burst}, default_class={self.default_class!r})")


def parse_tenants(spec: str) -> Dict[str, TenantSpec]:
    """Flag syntax: ``"alice=100:200,bob=50"`` — ``name=rate[:burst]``
    entries, comma separated. Diagnostics name the offending entry and
    its position (the partition-rules parser contract)."""
    out: Dict[str, TenantSpec] = {}
    if not spec or not str(spec).strip():
        return out
    for i, entry in enumerate(str(spec).split(",")):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(
                f"traffic_tenants entry {i} ({entry!r}): expected "
                "name=rate[:burst]")
        name, _, rhs = entry.partition("=")
        name = name.strip()
        if not name:
            raise ValueError(
                f"traffic_tenants entry {i} ({entry!r}): empty tenant name")
        rate_s, _, burst_s = rhs.partition(":")
        try:
            rate = float(rate_s)
            burst = float(burst_s) if burst_s else None
        except ValueError:
            raise ValueError(
                f"traffic_tenants entry {i} ({entry!r}): rate/burst must "
                "be numbers") from None
        out[name] = TenantSpec(name, rate, burst)
    return out


def parse_adapter_quotas(spec: str) -> Dict[Tuple[str, str], TenantSpec]:
    """Flag syntax for per-(tenant, adapter) admission rates:
    ``"alice:summarize=10:20,*:translate=5"`` — ``tenant:adapter=
    rate[:burst]`` entries, comma separated. ``*`` as the tenant
    matches ANY tenant (a per-adapter aggregate cap); an exact tenant
    entry wins over the wildcard. Keys are ``(tenant, adapter)``."""
    out: Dict[Tuple[str, str], TenantSpec] = {}
    if not spec or not str(spec).strip():
        return out
    for i, entry in enumerate(str(spec).split(",")):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(
                f"traffic_adapter_quotas entry {i} ({entry!r}): expected "
                "tenant:adapter=rate[:burst]")
        lhs, _, rhs = entry.partition("=")
        tenant, sep, adapter = lhs.partition(":")
        tenant, adapter = tenant.strip(), adapter.strip()
        if not sep or not tenant or not adapter:
            raise ValueError(
                f"traffic_adapter_quotas entry {i} ({entry!r}): expected "
                "tenant:adapter on the left of '=' ('*' = any tenant)")
        rate_s, _, burst_s = rhs.partition(":")
        try:
            rate = float(rate_s)
            burst = float(burst_s) if burst_s else None
        except ValueError:
            raise ValueError(
                f"traffic_adapter_quotas entry {i} ({entry!r}): rate/burst "
                "must be numbers") from None
        out[(tenant, adapter)] = TenantSpec(
            f"{tenant}:{adapter}", rate, burst)
    return out


class TrafficConfig:
    """The whole admission + scheduling policy in one object. Every
    field mirrors a ``traffic_*`` flag (``from_flags()``); kwargs
    override per controller."""

    def __init__(self, *,
                 queue_capacity: int = 64,
                 tenants: Optional[Dict[str, TenantSpec]] = None,
                 default_rate: float = 0.0,
                 default_burst: float = 0.0,
                 aging_ms: float = 500.0,
                 shed_headroom: float = 1.2,
                 max_inflight: int = 0,
                 slo_miss_threshold: float = 0.5,
                 slo_window_s: float = 5.0,
                 adapter_quotas: Optional[
                     Dict[Tuple[str, str], TenantSpec]] = None):
        if queue_capacity < 1:
            raise ValueError("traffic queue_capacity must be >= 1")
        if shed_headroom < 1.0:
            raise ValueError("traffic shed_headroom must be >= 1.0")
        self.queue_capacity = int(queue_capacity)
        self.tenants = dict(tenants or {})
        self.default_rate = float(default_rate)
        self.default_burst = float(default_burst)
        self.aging_ms = float(aging_ms)
        self.shed_headroom = float(shed_headroom)
        self.max_inflight = int(max_inflight)
        self.slo_miss_threshold = float(slo_miss_threshold)
        self.slo_window_s = float(slo_window_s)
        self.adapter_quotas = dict(adapter_quotas or {})

    @classmethod
    def from_flags(cls, **overrides) -> "TrafficConfig":
        from ..flags import flag

        kw: Dict[str, Any] = {
            "queue_capacity": int(flag("traffic_queue_capacity")),
            "tenants": parse_tenants(flag("traffic_tenants")),
            "default_rate": float(flag("traffic_default_rate")),
            "default_burst": float(flag("traffic_default_burst")),
            "aging_ms": float(flag("traffic_aging_ms")),
            "shed_headroom": float(flag("traffic_shed_headroom")),
            "max_inflight": int(flag("traffic_max_inflight")),
            "slo_miss_threshold": float(flag("traffic_slo_miss_threshold")),
            "slo_window_s": float(flag("traffic_slo_window_s")),
            "adapter_quotas": parse_adapter_quotas(
                flag("traffic_adapter_quotas")),
        }
        kw.update(overrides)
        return cls(**kw)

    def spec_for(self, tenant: str) -> TenantSpec:
        spec = self.tenants.get(tenant)
        if spec is None:
            spec = TenantSpec(tenant, self.default_rate,
                              self.default_burst or None)
        return spec

    def adapter_spec_for(self, tenant: str,
                         adapter: str) -> Optional[TenantSpec]:
        """The (tenant, adapter) admission spec — exact tenant entry
        first, ``*`` wildcard second, None (no per-adapter cap)
        otherwise."""
        spec = self.adapter_quotas.get((tenant, adapter))
        if spec is None:
            spec = self.adapter_quotas.get(("*", adapter))
        return spec


class ClassQueues:
    """Per-class, per-tenant bounded FIFOs. NOT thread-safe — the
    controller serializes access under its own condition variable (the
    queues are part of one scheduling state machine; a second lock
    here would only add deadlock surface).

    Depth accounting is per class: ``push`` refuses when the class is
    at capacity (the caller sheds). Within a class, ``oldest_per_class``
    surfaces each tenant's head so the scheduler's pick is
    oldest-first across tenants — a tenant with a deep backlog ages at
    the same rate as one with a single queued request, it just holds
    more of the class's bounded capacity (which its token bucket
    already limits)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        # class -> tenant -> FIFO list of requests (append/pop(0) on
        # short bounded lists)
        self._q: Dict[str, Dict[str, List[Any]]] = {c: {} for c in CLASSES}
        self._depth: Dict[str, int] = {c: 0 for c in CLASSES}

    def push(self, cls: str, tenant: str, req: Any) -> bool:
        if self._depth[cls] >= self.capacity:
            return False
        self._q[cls].setdefault(tenant, []).append(req)
        self._depth[cls] += 1
        return True

    def depth(self, cls: Optional[str] = None) -> int:
        if cls is not None:
            return self._depth[cls]
        return sum(self._depth.values())

    def depths(self) -> Dict[str, int]:
        return dict(self._depth)

    def heads(self) -> List[Tuple[str, str, Any]]:
        """(class, tenant, head-request) for every non-empty tenant
        FIFO — the scheduler's candidate set (within one FIFO the head
        is always both oldest and most-aged)."""
        out = []
        for cls in CLASSES:
            for tenant, fifo in self._q[cls].items():
                if fifo:
                    out.append((cls, tenant, fifo[0]))
        return out

    def pop(self, cls: str, tenant: str) -> Any:
        fifo = self._q[cls][tenant]
        req = fifo.pop(0)
        self._depth[cls] -= 1
        if not fifo:
            del self._q[cls][tenant]
        return req

    def remove(self, req: Any) -> bool:
        """Drop a specific request wherever it sits (cancel path)."""
        for cls in CLASSES:
            for tenant, fifo in list(self._q[cls].items()):
                try:
                    fifo.remove(req)
                except ValueError:
                    continue
                self._depth[cls] -= 1
                if not fifo:
                    del self._q[cls][tenant]
                return True
        return False

    def drain(self) -> List[Any]:
        """Pop everything (close path), priority-then-FIFO order."""
        out = []
        for cls in CLASSES:
            for tenant in list(self._q[cls]):
                fifo = self._q[cls].pop(tenant)
                out.extend(fifo)
            self._depth[cls] = 0
        return out
