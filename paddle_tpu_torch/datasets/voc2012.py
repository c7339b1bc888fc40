"""Pascal VOC2012 segmentation reader (synthetic).

The port's copy of ``paddle_tpu/datasets/voc2012.py``.

Reference: python/paddle/dataset/voc2012.py — train()/test()/val()
yield (3xHxW image, HxW int32 segmentation mask with 21 classes).
"""

from __future__ import annotations

from . import common

import numpy as np

N_CLASSES = 21
H = W = 96
TRAIN_SIZE, TEST_SIZE, VAL_SIZE = 512, 128, 128


def _sample(idx):
    rng = np.random.RandomState(97000 + idx)
    img = rng.rand(3, H, W).astype("float32")
    mask = np.zeros((H, W), "int32")
    for _ in range(3):  # a few rectangular objects
        c = int(rng.randint(1, N_CLASSES))
        y0, x0 = rng.randint(0, H - 16), rng.randint(0, W - 16)
        h, w = rng.randint(8, 16), rng.randint(8, 16)
        mask[y0:y0 + h, x0:x0 + w] = c
        img[:, y0:y0 + h, x0:x0 + w] += c / N_CLASSES
    return img, mask


def _make(base, count):
    def reader():
        for i in range(count):
            yield _sample(base + i)

    return common.synthetic("voc2012", reader)


def train():
    return _make(0, TRAIN_SIZE)


def test():
    return _make(TRAIN_SIZE, TEST_SIZE)


def val():
    return _make(TRAIN_SIZE + TEST_SIZE, VAL_SIZE)
