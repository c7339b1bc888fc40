"""MNIST reader (synthetic; real shapes 784 float + int label).

The port's copy of ``paddle_tpu/datasets/mnist.py``.

Reference: python/paddle/dataset/mnist.py train()/test() yield
(flattened 28x28 float32 in [-1,1], int label). Synthetic data: each
class is a fixed quadrant pattern + noise, deterministic per index, so
convergence tests behave like the real set.
"""

from __future__ import annotations

from . import common

import numpy as np

TRAIN_SIZE = 8192
TEST_SIZE = 1024


def _sample(idx: int):
    rng = np.random.RandomState(idx)
    label = idx % 10
    img = np.full((28, 28), -1.0, dtype="float32")
    r, c = divmod(label, 4)
    img[r * 7 : r * 7 + 7, c * 7 : c * 7 + 7] = 1.0
    img += rng.randn(28, 28).astype("float32") * 0.3
    return np.clip(img, -1.0, 1.0).reshape(784), label


def train():
    def reader():
        for i in range(TRAIN_SIZE):
            yield _sample(i)

    return common.synthetic("mnist", reader)


def test():
    def reader():
        for i in range(TEST_SIZE):
            yield _sample(TRAIN_SIZE + i)

    return common.synthetic("mnist", reader)
