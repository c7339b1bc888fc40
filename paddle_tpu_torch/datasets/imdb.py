"""IMDB sentiment reader (synthetic; word-id sequences + 0/1 label).

The port's copy of ``paddle_tpu/datasets/imdb.py``.

Reference: python/paddle/dataset/imdb.py — word_dict() + train()/test()
yielding (list of word ids, label). Synthetic: two vocab regions carry
sentiment signal; sequence lengths vary like the real data.
"""

from __future__ import annotations

from . import common

import numpy as np

VOCAB_SIZE = 5147  # roughly the reference's cutoff dict size
TRAIN_SIZE = 2048
TEST_SIZE = 512


def word_dict():
    return {f"w{i}": i for i in range(VOCAB_SIZE)}


def _sample(idx):
    rng = np.random.RandomState(7000 + idx)
    label = idx % 2
    length = int(rng.randint(20, 200))
    base = rng.randint(0, VOCAB_SIZE, size=length)
    # sentiment-bearing tokens from disjoint ranges
    sentiment_tokens = rng.randint(
        100 if label else 600, 300 if label else 800, size=max(length // 5, 1)
    )
    pos = rng.randint(0, length, size=sentiment_tokens.size)
    base[pos] = sentiment_tokens
    return base.astype("int64").tolist(), label


def train(word_idx=None):
    def reader():
        for i in range(TRAIN_SIZE):
            yield _sample(i)

    return common.synthetic("imdb", reader)


def test(word_idx=None):
    def reader():
        for i in range(TEST_SIZE):
            yield _sample(TRAIN_SIZE + i)

    return common.synthetic("imdb", reader)
