"""Reader decorators. Reference: python/paddle/reader/decorator.py
(paddle.batch, paddle.reader.shuffle, cache, firstn, map_readers).

The port's copy of ``paddle_tpu/datasets/common.py``."""

from __future__ import annotations

import random
import warnings

_synthetic_warned = set()


def synthetic(name, reader):
    """Wrap a synthetic dataset reader: warn once per dataset on first
    iteration. These readers reproduce the reference paddle.dataset
    APIs but yield deterministic synthetic samples (zero-egress build);
    a ported training script must not silently train on random data."""

    def wrapped():
        if name not in _synthetic_warned:
            _synthetic_warned.add(name)
            warnings.warn(
                f"paddle_tpu_torch.datasets.{name}: yielding SYNTHETIC data "
                "(this build cannot download the real corpus); metrics "
                "will not match real-data training", stacklevel=2)
        return reader()

    return wrapped


def batch(reader, batch_size: int, drop_last: bool = False):
    def batched():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


def shuffle(reader, buf_size: int, seed=None):
    rng = random.Random(seed)

    def shuffled():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        rng.shuffle(buf)
        yield from buf

    return shuffled


def cache(reader):
    # materialize fully on first use: a partially-consumed first pass
    # must not poison later passes with a truncated dataset
    data = []
    loaded = [False]

    def cached():
        if not loaded[0]:
            data.extend(reader())
            loaded[0] = True
        yield from data

    return cached


def firstn(reader, n: int):
    def limited():
        for i, s in enumerate(reader()):
            if i >= n:
                break
            yield s

    return limited


def map_readers(func, *readers):
    def mapped():
        for samples in zip(*[r() for r in readers]):
            yield func(*samples)

    return mapped
