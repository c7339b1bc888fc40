"""WMT16 EN<->DE translation reader (synthetic id sequences).

The port's copy of ``paddle_tpu/datasets/wmt16.py``.

Reference: python/paddle/dataset/wmt16.py —
train/test/validation(src_dict_size, trg_dict_size, src_lang) yield
(src_ids, trg_ids, trg_ids_next); get_dict(lang, dict_size).
"""

from __future__ import annotations

from . import common

import numpy as np

from .wmt14 import START, END, UNK

TRAIN_SIZE, TEST_SIZE, VAL_SIZE = 2048, 256, 256


def _sample(idx, src_dict_size, trg_dict_size):
    rng = np.random.RandomState(92000 + idx)
    n = int(rng.randint(4, 40))
    src = rng.randint(3, src_dict_size, size=n).astype("int64").tolist()
    m = max(2, int(n * float(rng.uniform(0.8, 1.25))))
    trg = rng.randint(3, trg_dict_size, size=m).astype("int64").tolist()
    return src, [START] + trg, trg + [END]


def _make(base, count, src_dict_size, trg_dict_size):
    def reader():
        for i in range(count):
            yield _sample(base + i, src_dict_size, trg_dict_size)

    return common.synthetic("wmt16", reader)


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return _make(0, TRAIN_SIZE, src_dict_size, trg_dict_size)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return _make(TRAIN_SIZE, TEST_SIZE, src_dict_size, trg_dict_size)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    return _make(TRAIN_SIZE + TEST_SIZE, VAL_SIZE, src_dict_size,
                 trg_dict_size)


def get_dict(lang, dict_size, reverse=False):
    words = {f"{lang}{i}": i for i in range(dict_size)}
    words["<s>"], words["<e>"], words["<unk>"] = START, END, UNK
    if reverse:
        return {i: w for w, i in words.items()}
    return words
