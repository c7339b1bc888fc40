"""Serving metrics (counterpart of ``paddle_tpu/serving/metrics.py``):
``StreamingHistogram`` (fixed log-spaced buckets, O(1) record, which
the generation metrics use too) and ``ServingMetrics`` (:93-201), the
ServingEngine's lock-protected counters, latency and queue-wait
histograms, batch occupancy and fill, padding waste, ``snapshot()`` and
``to_prometheus_text(extra)``. Every ServingMetrics registers with the
process-wide observability registry (``watch_serving``, :104 there), so
``/metrics`` on any server shows every live engine as a labeled
``paddle_serving_*{engine=}`` series group."""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, Optional

__all__ = ["StreamingHistogram", "ServingMetrics"]


class StreamingHistogram:
    """Fixed log-spaced buckets over (0, hi]; O(1) record, O(buckets)
    quantile. Values below `lo` land in the first bucket, above `hi`
    in the overflow bucket (reported as >= hi)."""

    def __init__(self, lo: float = 0.05, hi: float = 300_000.0,
                 factor: float = 1.08):
        bounds = []
        b = float(lo)
        while b < hi:
            bounds.append(b)
            b *= factor
        self._bounds = bounds          # upper edges, ascending
        self._counts = [0] * (len(bounds) + 1)  # +1 overflow
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max = 0.0

    def record(self, v: float) -> None:
        v = float(v)
        self._counts[bisect.bisect_left(self._bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.max = v if v > self.max else self.max
        self.min = v if self.min is None or v < self.min else self.min

    def quantile(self, q: float) -> float:
        """Approximate q-quantile: the geometric midpoint of the bucket
        holding the q*count-th observation (0.0 when empty)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        acc = 0
        for i, c in enumerate(self._counts):
            acc += c
            if acc >= rank and c:
                if i >= len(self._bounds):          # overflow bucket
                    return self._bounds[-1] if self._bounds else 0.0
                lo = self._bounds[i - 1] if i else self._bounds[i] / 2
                return (lo * self._bounds[i]) ** 0.5
        return self.max

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": round(self.sum, 3),
            "mean": round(self.sum / self.count, 3) if self.count else 0.0,
            "min": round(self.min, 3) if self.min is not None else 0.0,
            "max": round(self.max, 3),
            "p50": round(self.quantile(0.50), 3),
            "p95": round(self.quantile(0.95), 3),
            "p99": round(self.quantile(0.99), 3),
        }


_COUNTERS = (
    "requests_total",          # admitted into the queue
    "responses_total",         # completed with a result
    "rejected_total",          # refused at admission (queue full)
    "expired_total",           # deadline passed before batching
    "cancelled_total",         # future.cancel() before batching
    "errors_total",            # predictor raised during execution
    "batches_total",           # predictor calls dispatched
    "batched_requests_total",  # requests across all dispatched batches
)


class ServingMetrics:
    """The ServingEngine's registry. Every mutator and ``snapshot()``
    take one lock, so concurrent workers can neither corrupt a counter
    nor read a torn view."""

    def __init__(self):
        self._lock = threading.Lock()
        # one labeled series group in the process-wide registry, weakly
        # held: a closed engine drops out of the scrape
        from ..observability import watch_serving

        watch_serving(self)
        self._c: Dict[str, int] = {k: 0 for k in _COUNTERS}
        self._latency_ms = StreamingHistogram()
        self._queue_wait_ms = StreamingHistogram()
        self._queue_depth = 0
        self._occupancy_max = 0          # requests in the fullest batch
        self._rows_sum = 0               # rows actually batched
        self._rows_capacity_sum = 0      # max_batch_size per batch
        self._pad_real = 0               # engine-level seq-padding waste
        self._pad_total = 0

    # -- mutators (hot path) ------------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] += n

    def observe_latency(self, ms: float) -> None:
        with self._lock:
            self._latency_ms.record(ms)

    def observe_queue_wait(self, ms: float) -> None:
        with self._lock:
            self._queue_wait_ms.record(ms)

    def observe_batch(self, n_requests: int, n_rows: int,
                      capacity: int) -> None:
        with self._lock:
            self._c["batches_total"] += 1
            self._c["batched_requests_total"] += n_requests
            if n_requests > self._occupancy_max:
                self._occupancy_max = n_requests
            self._rows_sum += n_rows
            self._rows_capacity_sum += capacity

    def set_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._queue_depth = depth

    def record_padding(self, real_elements: int, total_elements: int) -> None:
        with self._lock:
            self._pad_real += int(real_elements)
            self._pad_total += int(total_elements)

    # -- readers -------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """One consistent, JSON-serializable point-in-time view."""
        with self._lock:
            batches = self._c["batches_total"]
            out: Dict[str, Any] = dict(self._c)
            out["queue_depth"] = self._queue_depth
            out["latency_ms"] = self._latency_ms.snapshot()
            out["queue_wait_ms"] = self._queue_wait_ms.snapshot()
            out["batch_occupancy"] = {
                "mean": (round(self._c["batched_requests_total"] / batches, 3)
                         if batches else 0.0),
                "max": self._occupancy_max,
            }
            out["batch_fill"] = (
                round(self._rows_sum / self._rows_capacity_sum, 4)
                if self._rows_capacity_sum else 0.0)
            out["padding_waste"] = (
                round(1.0 - self._pad_real / self._pad_total, 4)
                if self._pad_total else 0.0)
            return out

    def to_prometheus_text(self,
                           extra: Optional[Dict[str, Any]] = None) -> str:
        """Prometheus exposition text (counters, gauges, quantile
        summaries). ``extra`` adds flat name -> number gauges (the
        server passes the aggregated predictor bucket stats and the
        generation engine's numbers)."""
        snap = self.snapshot()
        lines = []

        def emit(name, kind, value):
            lines.append(f"# TYPE paddle_serving_{name} {kind}")
            lines.append(f"paddle_serving_{name} {value}")

        for k in _COUNTERS:
            emit(k, "counter", snap[k])
        emit("queue_depth", "gauge", snap["queue_depth"])
        emit("batch_occupancy_mean", "gauge", snap["batch_occupancy"]["mean"])
        emit("batch_occupancy_max", "gauge", snap["batch_occupancy"]["max"])
        emit("batch_fill", "gauge", snap["batch_fill"])
        emit("padding_waste", "gauge", snap["padding_waste"])
        for hist_name in ("latency_ms", "queue_wait_ms"):
            h = snap[hist_name]
            lines.append(f"# TYPE paddle_serving_{hist_name} summary")
            for q, k in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
                lines.append(
                    f'paddle_serving_{hist_name}{{quantile="{q}"}} {h[k]}')
            lines.append(f"paddle_serving_{hist_name}_sum {h['sum']}")
            lines.append(f"paddle_serving_{hist_name}_count {h['count']}")
        for k, v in (extra or {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                emit(k, "gauge", v)
        return "\n".join(lines) + "\n"
