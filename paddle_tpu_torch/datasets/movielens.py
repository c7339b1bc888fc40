"""MovieLens-1M rating reader (synthetic).

The port's copy of ``paddle_tpu/datasets/movielens.py``.

Reference: python/paddle/dataset/movielens.py — train()/test() yield
[user_id, gender_id, age_id, job_id, movie_id, category_ids,
title_ids, [rating]]; plus the meta helpers
(max_user_id/max_movie_id/max_job_id/age_table/movie_categories/
user_info/movie_info/get_movie_title_dict).
"""

from __future__ import annotations

from . import common

import numpy as np

age_table = [1, 18, 25, 35, 45, 50, 56]

_N_USERS, _N_MOVIES, _N_JOBS = 6040, 3952, 21
_N_CATEGORIES, _TITLE_VOCAB = 18, 5175
TRAIN_SIZE, TEST_SIZE = 4096, 512


def max_user_id():
    return _N_USERS


def max_movie_id():
    return _N_MOVIES


def max_job_id():
    return _N_JOBS - 1


def movie_categories():
    return {f"cat{i}": i for i in range(_N_CATEGORIES)}


def get_movie_title_dict():
    return {f"t{i}": i for i in range(_TITLE_VOCAB)}


def user_info():
    return {
        uid: {"gender": "MF"[uid % 2], "age": age_table[uid % len(age_table)],
              "job_id": uid % _N_JOBS}
        for uid in range(1, 64)
    }


def movie_info():
    rng = np.random.RandomState(93000)
    return {
        mid: {"categories": sorted(set(
                  rng.randint(0, _N_CATEGORIES, 3).tolist())),
              "title": rng.randint(0, _TITLE_VOCAB, 4).tolist()}
        for mid in range(1, 64)
    }


def _sample(idx):
    rng = np.random.RandomState(93500 + idx)
    uid = int(rng.randint(1, _N_USERS + 1))
    mid = int(rng.randint(1, _N_MOVIES + 1))
    gender = uid % 2
    age_id = uid % len(age_table)
    job = uid % _N_JOBS
    cats = sorted(set(rng.randint(0, _N_CATEGORIES, 3).tolist()))
    title = rng.randint(0, _TITLE_VOCAB, int(rng.randint(2, 8))).tolist()
    # taste model so the rating is learnable, not noise
    rating = float((uid * 7 + mid * 13) % 5 + 1)
    return [uid, gender, age_id, job, mid, cats, title, [rating]]


def train():
    def reader():
        for i in range(TRAIN_SIZE):
            yield _sample(i)

    return common.synthetic("movielens", reader)


def test():
    def reader():
        for i in range(TEST_SIZE):
            yield _sample(TRAIN_SIZE + i)

    return common.synthetic("movielens", reader)
