"""imikolov (PTB) language-model reader (synthetic).

The port's copy of ``paddle_tpu/datasets/imikolov.py``.

Reference: python/paddle/dataset/imikolov.py — build_dict();
train(word_idx, n)/test(word_idx, n) yield n-gram tuples (NGRAM mode)
or (src_seq, trg_seq) in SEQ mode.
"""

from __future__ import annotations

from . import common

import numpy as np


class DataType:
    NGRAM = 1
    SEQ = 2


VOCAB = 2074
TRAIN_SIZE, TEST_SIZE = 4096, 512


def build_dict(min_word_freq=50):
    return {f"w{i}": i for i in range(VOCAB)}


def _sentence(idx, vocab):
    rng = np.random.RandomState(95000 + idx)
    n = int(rng.randint(5, 25))
    return rng.randint(0, vocab, n).astype("int64").tolist()


def _make(base, count, word_idx, n, data_type):
    vocab = max(word_idx.values()) + 1 if word_idx else VOCAB

    def reader():
        for i in range(count):
            s = _sentence(base + i, vocab)
            if data_type == DataType.NGRAM:
                for j in range(len(s) - n + 1):
                    yield tuple(s[j:j + n])
            else:
                yield s[:-1], s[1:]

    return common.synthetic("imikolov", reader)


def train(word_idx, n, data_type=DataType.NGRAM):
    return _make(0, TRAIN_SIZE, word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _make(TRAIN_SIZE, TEST_SIZE, word_idx, n, data_type)
