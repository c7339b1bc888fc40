"""WMT14 EN->FR translation reader (synthetic id sequences).

The port's copy of ``paddle_tpu/datasets/wmt14.py``.

Reference: python/paddle/dataset/wmt14.py — train(dict_size) /
test(dict_size) yield (src_ids, trg_ids, trg_ids_next);
get_dict(dict_size) returns (src_dict, trg_dict). Synthetic pairs keep
the reference's start/end markers (<s>=0, <e>=1, <unk>=2) and the
src/trg length correlation real translation data has.
"""

from __future__ import annotations

from . import common

import numpy as np

START, END, UNK = 0, 1, 2
TRAIN_SIZE, TEST_SIZE = 2048, 256


def _sample(idx, dict_size):
    rng = np.random.RandomState(91000 + idx)
    n = int(rng.randint(4, 30))
    src = rng.randint(3, dict_size, size=n).astype("int64").tolist()
    m = max(2, int(n * float(rng.uniform(0.8, 1.25))))
    trg = rng.randint(3, dict_size, size=m).astype("int64").tolist()
    trg_with_start = [START] + trg
    trg_next = trg + [END]
    return src, trg_with_start, trg_next


def train(dict_size):
    def reader():
        for i in range(TRAIN_SIZE):
            yield _sample(i, dict_size)

    return common.synthetic("wmt14", reader)


def test(dict_size):
    def reader():
        for i in range(TEST_SIZE):
            yield _sample(TRAIN_SIZE + i, dict_size)

    return common.synthetic("wmt14", reader)


def get_dict(dict_size, reverse=True):
    words = {i: f"w{i}" for i in range(dict_size)}
    words[START], words[END], words[UNK] = "<s>", "<e>", "<unk>"
    if reverse:
        return dict(words), dict(words)
    inv = {w: i for i, w in words.items()}
    return dict(inv), dict(inv)
