"""Traffic metrics: per-class/per-tenant admission + SLO accounting
(the counterpart of ``paddle_tpu/traffic/metrics.py``).

Everything here exports into the unified registry as
``paddle_traffic_*`` series via ``observability.watch_traffic``
(registered by the controller), with ``ctrl=`` identifying the
controller instance and ``cls=``/``tenant=``/``reason=`` labels
telling the series apart — the Prometheus convention the rest of the
stack follows (labels, never name suffixes).

The families a router/autoscaler actually decides from:

* ``paddle_traffic_admitted_total{cls,tenant}`` /
  ``paddle_traffic_shed_total{cls,tenant,reason}`` — admit/shed rates
  per class and tenant (reason in ``quota`` / ``queue_full`` /
  ``infeasible`` / ``backend`` / ``closed``).
* ``paddle_traffic_completed_total`` / ``paddle_traffic_goodput_total``
  / ``paddle_traffic_deadline_miss_total`` — completions, completions
  that met their deadline, and misses, per class/tenant.
* ``paddle_traffic_queue_depth{cls}`` + ``paddle_traffic_inflight`` —
  scheduler state.
* ``paddle_traffic_deadline_miss_ratio`` (sliding window) +
  ``paddle_traffic_drain_rate_rps`` — the SLO-breach trigger inputs.
* ``paddle_traffic_shed_before_batch_total`` — every shed here
  happened BEFORE the request consumed a batch slot; the replay
  harness gates on this staying equal to the shed total.
* ``paddle_traffic_latency_ms`` / ``paddle_traffic_queue_wait_ms``
  per-class streaming-histogram quantiles.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..serving.metrics import StreamingHistogram
from .admission import CLASSES

__all__ = ["TrafficMetrics"]


class TrafficMetrics:
    """Lock-protected counters keyed (class, tenant); one consistent
    ``snapshot()`` for stats()/JSON, one ``collect()`` in the registry
    collector's labeled-series shape."""

    def __init__(self, clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        # (cls, tenant) -> count
        self._admitted: Dict[Tuple[str, str], int] = {}
        self._completed: Dict[Tuple[str, str], int] = {}
        self._goodput: Dict[Tuple[str, str], int] = {}
        self._missed: Dict[Tuple[str, str], int] = {}
        # (cls, tenant, reason) -> count
        self._shed: Dict[Tuple[str, str, str], int] = {}
        self._latency = {c: StreamingHistogram() for c in CLASSES}
        self._queue_wait = {c: StreamingHistogram() for c in CLASSES}
        self._queue_depth: Dict[str, int] = {c: 0 for c in CLASSES}
        self._inflight = 0
        self._aged_total = 0
        self._retry_after_last = 0.0
        self._slo_dumps = 0
        # deadline-window ring: (t, missed) completion events inside
        # the slo window — feeds BOTH the breach detector and the
        # drain-rate estimate (a windowed count, not an EWMA of
        # instantaneous gaps: completions arrive in batch-sized
        # bursts, and 1/dt across a burst boundary oscillates by 1000x)
        self._window: List[Tuple[float, bool]] = []
        self._window_s = 5.0

    # -- mutators ------------------------------------------------------------
    def admitted(self, cls: str, tenant: str) -> None:
        with self._lock:
            k = (cls, tenant)
            self._admitted[k] = self._admitted.get(k, 0) + 1

    def shed(self, cls: str, tenant: str, reason: str,
             retry_after_s: float) -> None:
        with self._lock:
            k = (cls, tenant, reason)
            self._shed[k] = self._shed.get(k, 0) + 1
            self._retry_after_last = float(retry_after_s)

    def aged(self, n: int = 1) -> None:
        with self._lock:
            self._aged_total += n

    def completed(self, cls: str, tenant: str, latency_ms: float,
                  met_deadline: Optional[bool]) -> None:
        """One request reached a terminal state after dispatch.
        ``met_deadline`` None = the request carried no deadline (counts
        as goodput, never as a miss)."""
        now = self._clock()
        with self._lock:
            k = (cls, tenant)
            self._completed[k] = self._completed.get(k, 0) + 1
            self._latency[cls].record(latency_ms)
            miss = met_deadline is False
            if miss:
                self._missed[k] = self._missed.get(k, 0) + 1
            else:
                self._goodput[k] = self._goodput.get(k, 0) + 1
            self._window.append((now, miss))
            self._trim_window_locked(now)

    def observe_queue_wait(self, cls: str, ms: float) -> None:
        with self._lock:
            self._queue_wait[cls].record(ms)

    def set_queue_depths(self, depths: Dict[str, int],
                         inflight: int) -> None:
        with self._lock:
            self._queue_depth.update(depths)
            self._inflight = int(inflight)

    def slo_dumped(self) -> None:
        with self._lock:
            self._slo_dumps += 1

    # -- readers -------------------------------------------------------------
    def _trim_window_locked(self, now: float) -> None:
        cut = now - self._window_s
        i = 0
        for i, (t, _) in enumerate(self._window):
            if t >= cut:
                break
        else:
            i = len(self._window)
        if i:
            del self._window[:i]

    def miss_ratio(self) -> Tuple[float, int]:
        """(deadline-miss ratio over the sliding window, sample
        count) — the SLO-breach detector's read."""
        now = self._clock()
        with self._lock:
            self._trim_window_locked(now)
            n = len(self._window)
            if not n:
                return 0.0, 0
            return sum(1 for _, m in self._window if m) / n, n

    def drain_rate(self) -> float:
        """Completions/sec over the sliding window; 0.0 until two
        completions land."""
        now = self._clock()
        with self._lock:
            self._trim_window_locked(now)
            n = len(self._window)
            if n < 2:
                return 0.0
            span = now - self._window[0][0]
            return n / span if span > 0 else 0.0

    def snapshot(self) -> Dict[str, Any]:
        ratio, n = self.miss_ratio()
        drain = self.drain_rate()
        with self._lock:
            def _merge(d):
                out: Dict[str, Dict[str, int]] = {}
                for key, v in d.items():
                    cls, tenant = key[0], key[1]
                    label = f"{cls}/{tenant}" + (
                        f"/{key[2]}" if len(key) > 2 else "")
                    out[label] = v
                return out

            return {
                "admitted": _merge(self._admitted),
                "shed": _merge(self._shed),
                "completed": _merge(self._completed),
                "goodput": _merge(self._goodput),
                "deadline_miss": _merge(self._missed),
                "queue_depth": dict(self._queue_depth),
                "inflight": self._inflight,
                "aged_total": self._aged_total,
                "deadline_miss_ratio": round(ratio, 4),
                "miss_window_samples": n,
                "drain_rate_rps": round(drain, 3),
                "retry_after_last_s": round(self._retry_after_last, 3),
                "slo_dumps_total": self._slo_dumps,
                "latency_ms": {c: h.snapshot()
                               for c, h in self._latency.items()},
                "queue_wait_ms": {c: h.snapshot()
                                  for c, h in self._queue_wait.items()},
            }

    def latency_quantile(self, cls: str, q: float) -> float:
        with self._lock:
            return self._latency[cls].quantile(q)

    def collect(self) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
        """Registry-collector shape: {family: [(labels, value), ...]}.
        The observability collector adds the ctrl= label on top."""
        ratio, _n = self.miss_ratio()
        drain = self.drain_rate()
        with self._lock:
            out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}

            def add(name, labels, v):
                out.setdefault(name, []).append((labels, float(v)))

            for (cls, tenant), v in self._admitted.items():
                add("paddle_traffic_admitted_total",
                    {"cls": cls, "tenant": tenant}, v)
            shed_sum = 0
            for (cls, tenant, reason), v in self._shed.items():
                shed_sum += v
                add("paddle_traffic_shed_total",
                    {"cls": cls, "tenant": tenant, "reason": reason}, v)
            for (cls, tenant), v in self._completed.items():
                add("paddle_traffic_completed_total",
                    {"cls": cls, "tenant": tenant}, v)
            for (cls, tenant), v in self._goodput.items():
                add("paddle_traffic_goodput_total",
                    {"cls": cls, "tenant": tenant}, v)
            for (cls, tenant), v in self._missed.items():
                add("paddle_traffic_deadline_miss_total",
                    {"cls": cls, "tenant": tenant}, v)
            for cls, d in self._queue_depth.items():
                add("paddle_traffic_queue_depth", {"cls": cls}, d)
            for cls, h in self._latency.items():
                if h.count:
                    add("paddle_traffic_latency_ms_p50", {"cls": cls},
                        h.quantile(0.50))
                    add("paddle_traffic_latency_ms_p99", {"cls": cls},
                        h.quantile(0.99))
            add("paddle_traffic_inflight", {}, self._inflight)
            add("paddle_traffic_aged_total", {}, self._aged_total)
            # every shed happens at admission/scheduling time, strictly
            # before any batch slot: the two counters are equal BY
            # CONSTRUCTION and exported separately so the replay gate
            # (and any dashboard) can assert it cheaply
            add("paddle_traffic_shed_before_batch_total", {}, shed_sum)
            add("paddle_traffic_deadline_miss_ratio", {}, round(ratio, 4))
            add("paddle_traffic_drain_rate_rps", {}, round(drain, 3))
            add("paddle_traffic_retry_after_last_s", {},
                round(self._retry_after_last, 3))
            add("paddle_traffic_slo_dumps_total", {}, self._slo_dumps)
            return out
