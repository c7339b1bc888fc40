"""DataFeeder: converts user mini-batch rows into the feed dict.

The port's copy of ``paddle_tpu/data_feeder.py``: numpy arrays out, in
the dtypes the feed variables declare; the Executor (or a loader) moves
them to the device.

Reference: python/paddle/fluid/data_feeder.py — converts a list of
sample tuples into LoDTensors per feed var. Dense-only here (raggedness
is handled by padding at the pipeline level).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .core.framework import Variable, convert_dtype


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None, program=None):
        self.feed_vars = list(feed_list)
        self.place = place

    def feed(self, iterable) -> Dict[str, np.ndarray]:
        rows = list(iterable)
        out = {}
        for i, var in enumerate(self.feed_vars):
            name = var.name if isinstance(var, Variable) else str(var)
            cols = [np.asarray(r[i]) for r in rows]
            arr = np.stack(cols, axis=0)
            if isinstance(var, Variable):
                want = convert_dtype(var.dtype)
                arr = arr.astype(want, copy=False)
                # reshape flat rows to the declared trailing shape
                if var.shape and len(var.shape) > arr.ndim and all(
                    d and d > 0 for d in var.shape[1:]
                ):
                    arr = arr.reshape((arr.shape[0],) + tuple(var.shape[1:]))
            out[name] = arr
        return out

    def feed_parallel(self, iterable, num_places=None):
        return self.feed(iterable)
