"""Weighted averaging helper.

The port's copy of ``paddle_tpu/average.py``.

Reference: python/paddle/fluid/average.py:40 (WeightedAverage) — host-
side streaming average of fetched metrics.
"""

from __future__ import annotations

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number(v):
    return isinstance(v, (int, float)) or (
        isinstance(v, np.ndarray) and v.size == 1)


class WeightedAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = 0.0
        self.denominator = 0.0

    def add(self, value, weight):
        if not (_is_number(value) or isinstance(value, np.ndarray)):
            raise ValueError("add(): value must be a number or ndarray")
        if not _is_number(weight):
            raise ValueError("add(): weight must be a number")
        w = float(np.asarray(weight).reshape(()))
        self.numerator += float(np.sum(np.asarray(value))) * w
        self.denominator += w

    def eval(self):
        if self.denominator == 0.0:
            raise ValueError(
                "eval() on an empty WeightedAverage (add() something first)")
        return self.numerator / self.denominator
