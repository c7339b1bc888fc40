"""Oxford-102 flowers reader (synthetic images).

The port's copy of ``paddle_tpu/datasets/flowers.py``.

Reference: python/paddle/dataset/flowers.py — train()/test()/valid()
yield (3x224x224 float image, label in [0,102)).
"""

from __future__ import annotations

from . import common

import numpy as np

N_CLASSES = 102
TRAIN_SIZE, TEST_SIZE, VAL_SIZE = 1024, 256, 256


def _sample(idx):
    rng = np.random.RandomState(96000 + idx)
    label = idx % N_CLASSES
    img = rng.rand(3, 224, 224).astype("float32")
    # class-dependent hue so the label is learnable
    img[0] *= (label + 1) / N_CLASSES
    return img, label


def _make(base, count):
    def reader():
        for i in range(count):
            yield _sample(base + i)

    return common.synthetic("flowers", reader)


def train(mapper=None, buffered_size=1024, use_xmap=False, cycle=False):
    return _make(0, TRAIN_SIZE)


def test(mapper=None, buffered_size=1024, use_xmap=False, cycle=False):
    return _make(TRAIN_SIZE, TEST_SIZE)


def valid(mapper=None, buffered_size=1024, use_xmap=False):
    return _make(TRAIN_SIZE + TEST_SIZE, VAL_SIZE)
