"""CIFAR-10 reader (synthetic; 3x32x32 float + int label).

The port's copy of ``paddle_tpu/datasets/cifar.py``.

Reference: python/paddle/dataset/cifar.py train10()/test10().
"""

from __future__ import annotations

from . import common

import numpy as np

TRAIN_SIZE = 4096
TEST_SIZE = 512


def _sample(idx):
    rng = np.random.RandomState(idx)
    label = idx % 10
    img = rng.rand(3, 32, 32).astype("float32") * 0.4
    # class signature: colored band at class-dependent row
    img[label % 3, (label * 3) % 32 : (label * 3) % 32 + 4, :] += 0.6
    return img.reshape(-1), label


def train10():
    def reader():
        for i in range(TRAIN_SIZE):
            yield _sample(i)

    return common.synthetic("cifar", reader)


def test10():
    def reader():
        for i in range(TEST_SIZE):
            yield _sample(TRAIN_SIZE + i)

    return common.synthetic("cifar", reader)
