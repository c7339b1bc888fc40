"""CoNLL-2005 semantic role labeling reader (synthetic).

The port's copy of ``paddle_tpu/datasets/conll05.py``.

Reference: python/paddle/dataset/conll05.py — test() yields the 9-slot
SRL sample (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, verb_ids,
mark, label_ids); get_dict() returns (word_dict, verb_dict,
label_dict); get_embedding() the pretrained table.
"""

from __future__ import annotations

from . import common

import numpy as np

WORD_DICT_LEN = 44068
VERB_DICT_LEN = 3162
LABEL_DICT_LEN = 59
EMB_DIM = 32
TEST_SIZE = 512
UNK_IDX = 0


def get_dict():
    word_dict = {f"w{i}": i for i in range(WORD_DICT_LEN)}
    verb_dict = {f"v{i}": i for i in range(VERB_DICT_LEN)}
    label_dict = {f"l{i}": i for i in range(LABEL_DICT_LEN)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    rng = np.random.RandomState(94000)
    return rng.randn(WORD_DICT_LEN, EMB_DIM).astype("float32") * 0.1


def _sample(idx):
    rng = np.random.RandomState(94500 + idx)
    n = int(rng.randint(5, 40))
    words = rng.randint(0, WORD_DICT_LEN, n).astype("int64").tolist()
    verb_pos = int(rng.randint(0, n))
    ctx = [[words[max(0, min(n - 1, verb_pos + d))]] * n
           for d in (-2, -1, 0, 1, 2)]
    verb = [int(rng.randint(0, VERB_DICT_LEN))] * n
    mark = [1 if i == verb_pos else 0 for i in range(n)]
    labels = rng.randint(0, LABEL_DICT_LEN, n).astype("int64").tolist()
    return (words, *ctx, verb, mark, labels)


def test():
    def reader():
        for i in range(TEST_SIZE):
            yield _sample(i)

    return common.synthetic("conll05", reader)
