"""MQ2007 learning-to-rank reader (synthetic).

The port's copy of ``paddle_tpu/datasets/mq2007.py``.

Reference: python/paddle/dataset/mq2007.py — train()/test() with
format= 'pointwise' (feature, score), 'pairwise' (d_high, d_low) or
'listwise' (label_list, feature_list) grouped by query.
"""

from __future__ import annotations

from . import common

import numpy as np

FEATURE_DIM = 46
N_QUERIES_TRAIN, N_QUERIES_TEST = 128, 32
DOCS_PER_QUERY = 8


def _query(qid):
    rng = np.random.RandomState(98000 + qid)
    feats = rng.rand(DOCS_PER_QUERY, FEATURE_DIM).astype("float32")
    # relevance correlated with the first feature
    labels = (feats[:, 0] * 3).astype("int64")
    return labels, feats


def _make(base, n_queries, format):
    def reader():
        for q in range(n_queries):
            labels, feats = _query(base + q)
            if format == "pointwise":
                for l, f in zip(labels, feats):
                    yield f, float(l)
            elif format == "pairwise":
                for i in range(len(labels)):
                    for j in range(len(labels)):
                        if labels[i] > labels[j]:
                            yield feats[i], feats[j]
            else:  # listwise
                yield labels.tolist(), list(feats)

    return common.synthetic("mq2007", reader)


def train(format="pairwise"):
    return _make(0, N_QUERIES_TRAIN, format)


def test(format="pairwise"):
    return _make(N_QUERIES_TRAIN, N_QUERIES_TEST, format)
