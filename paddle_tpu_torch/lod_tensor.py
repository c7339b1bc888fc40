"""User-facing LoDTensor helpers.

The port's copy of ``paddle_tpu/lod_tensor.py``.

Reference: python/paddle/fluid/lod_tensor.py:24 (create_lod_tensor),
:114 (create_random_int_lodtensor) over the C++ LoDTensor
(framework/lod_tensor.h:104 — ragged level-of-detail offsets).

Representation (the JAX package's, kept so that both packages feed the
same arrays): raggedness lives as DENSE PADDED data + per-sequence
lengths (the convention every sequence op and the rank-table family in
ops/lod.py consume). ``LoDTensor`` here is the host-side carrier pairing the
padded array with its recursive sequence lengths; feeding one to the
executor feeds the padded array, and its ``lengths()`` feed the ops'
Length slots.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["LoDTensor", "create_lod_tensor", "create_random_int_lodtensor"]


class LoDTensor:
    """Dense padded data + recursive sequence lengths.

    ``recursive_sequence_lengths()`` matches the reference API
    (lod_tensor.h length-based LoD); ``lod()`` returns offset form."""

    def __init__(self, data: np.ndarray, recursive_seq_lens: Sequence[Sequence[int]]):
        self._data = np.asarray(data)
        self._seq_lens = [list(l) for l in recursive_seq_lens]

    def recursive_sequence_lengths(self) -> List[List[int]]:
        return [list(l) for l in self._seq_lens]

    def set_recursive_sequence_lengths(self, lens):
        self._seq_lens = [list(l) for l in lens]

    def lod(self) -> List[List[int]]:
        out = []
        for level in self._seq_lens:
            offs = [0]
            for l in level:
                offs.append(offs[-1] + int(l))
            out.append(offs)
        return out

    def has_valid_recursive_sequence_lengths(self) -> bool:
        # non-leaf levels: sum == next level's sequence count; the
        # LEAF level in dense padding owns one padded row per sequence
        # and each length must fit within the padded time extent
        try:
            for i, level in enumerate(self._seq_lens):
                if not level or any(l < 0 for l in level):
                    return False
                if i + 1 < len(self._seq_lens):
                    if sum(level) != len(self._seq_lens[i + 1]):
                        return False
                else:
                    if len(level) != self._data.shape[0]:
                        return False
                    if self._data.ndim > 1 and max(level) > self._data.shape[1]:
                        return False
        except (IndexError, TypeError):
            return False
        return True

    def numpy(self) -> np.ndarray:
        return self._data

    def lengths(self) -> np.ndarray:
        """Leaf-level lengths vector for ops' Length slots."""
        return np.asarray(self._seq_lens[-1], dtype=np.int64)

    @property
    def shape(self):
        return self._data.shape

    def __array__(self, dtype=None):
        return self._data.astype(dtype) if dtype else self._data


def create_lod_tensor(data, recursive_seq_lens, place=None) -> LoDTensor:
    """Reference lod_tensor.py:24. ``data`` may be:

    * a flat [sum(lens), ...] array (reference layout) — rows are
      re-packed into dense padding [num_seqs, max_len, ...];
    * a list of per-sequence row-lists (reference nested-list form);
    * an already-padded [num_seqs, max_len, ...] array whose row count
      matches len(lens) — kept as-is.
    """
    lens = [list(l) for l in recursive_seq_lens]
    leaf = lens[-1]
    if isinstance(data, (list, tuple)):
        rows = [np.asarray(r).reshape(-1, *np.asarray(r).shape[1:])
                for r in data]
        flat = np.concatenate(rows, axis=0)
    else:
        flat = np.asarray(data)
    if not leaf:
        return LoDTensor(flat, lens)  # empty: nothing to repack
    max_len = max(leaf)
    # already-padded detection: [num_seqs, time >= max(leaf), ...]
    # (bucketed batches may pad past max(leaf)). When all lengths are 1
    # the flat and padded row counts coincide — then only a 3-D+ block
    # whose time axis is exactly max(leaf) reads as padded.
    if flat.shape[0] == sum(leaf):  # ambiguous or flat
        padded_like = (flat.shape[0] == len(leaf) and flat.ndim >= 3
                       and flat.shape[1] == max_len)
    else:
        padded_like = (flat.shape[0] == len(leaf) and flat.ndim >= 2
                       and flat.shape[1] >= max_len)
    if padded_like:
        return LoDTensor(flat, lens)
    if flat.shape[0] != sum(leaf):
        raise ValueError(
            f"data rows {flat.shape[0]} match neither sum(lengths) "
            f"{sum(leaf)} (flat layout) nor a padded "
            f"[{len(leaf)}, >={max_len}, ...] block")
    out = np.zeros((len(leaf), max_len) + flat.shape[1:], flat.dtype)
    off = 0
    for i, l in enumerate(leaf):
        out[i, :l] = flat[off:off + l]
        off += l
    return LoDTensor(out, lens)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None,
                                low=0, high=10) -> LoDTensor:
    """Reference lod_tensor.py:114."""
    leaf = list(recursive_seq_lens[-1])
    total = sum(leaf)
    flat = np.random.randint(low, high + 1,
                             size=(total,) + tuple(base_shape)).astype("int64")
    return create_lod_tensor(flat, recursive_seq_lens, place)
