"""NLTK movie-reviews sentiment reader (synthetic).

The port's copy of ``paddle_tpu/datasets/sentiment.py``.

Reference: python/paddle/dataset/sentiment.py — get_word_dict();
train()/test() yield (word_ids, 0/1 label).
"""

from __future__ import annotations

from . import common

from . import imdb as _imdb

VOCAB = 2048
TRAIN_SIZE, TEST_SIZE = 1600, 400


def get_word_dict():
    return [(f"w{i}", i) for i in range(VOCAB)]


def train():
    def reader():
        for i in range(TRAIN_SIZE):
            ids, lbl = _imdb._sample(90000 + i)
            yield [w % VOCAB for w in ids], lbl

    return common.synthetic("sentiment", reader)


def test():
    def reader():
        for i in range(TEST_SIZE):
            ids, lbl = _imdb._sample(90000 + TRAIN_SIZE + i)
            yield [w % VOCAB for w in ids], lbl

    return common.synthetic("sentiment", reader)
