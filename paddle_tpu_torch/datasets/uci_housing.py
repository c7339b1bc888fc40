"""UCI housing reader (synthetic; 13 features -> price).

The port's copy of ``paddle_tpu/datasets/uci_housing.py``.

Reference: python/paddle/dataset/uci_housing.py — (13 float feats,
1 float target), feature-normalized. Synthetic: linear model + noise
with fixed ground-truth weights, deterministic.
"""

from __future__ import annotations

from . import common

import numpy as np

_W = np.array(
    [-0.5, 0.3, -0.2, 0.8, -1.0, 2.5, -0.1, 0.4, -0.3, -0.6, 0.9, 0.05, -1.2],
    dtype="float64",
)
TRAIN_SIZE = 404
TEST_SIZE = 102


def _sample(idx):
    rng = np.random.RandomState(1000 + idx)
    x = rng.randn(13).astype("float32")
    y = np.array([float(x @ _W) + rng.randn() * 0.2 + 22.5], dtype="float32")
    return x, y


def train():
    def reader():
        for i in range(TRAIN_SIZE):
            yield _sample(i)

    return common.synthetic("uci_housing", reader)


def test():
    def reader():
        for i in range(TEST_SIZE):
            yield _sample(TRAIN_SIZE + i)

    return common.synthetic("uci_housing", reader)
