"""Streaming latency histogram (a copy of ``StreamingHistogram`` in
``paddle_tpu/serving/metrics.py``, which the generation metrics use)."""

from __future__ import annotations

import bisect
from typing import Dict, Optional

__all__ = ["StreamingHistogram"]


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
