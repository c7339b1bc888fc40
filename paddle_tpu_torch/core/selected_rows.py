"""SelectedRows: the sparse row-slice gradient of an embedding table.

The port's counterpart of ``paddle_tpu/core/selected_rows.py`` (Fluid's
framework/selected_rows.h:32): ``rows`` (int64 [N], duplicates allowed)
index the dim-0 of a dense [height, *dims] tensor and ``values``
([N, *dims]) hold one slice per entry. ``lookup_table_grad`` with
``is_sparse=True`` makes one (``ops/tensor.py``); the sparse paths of
``sgd`` / ``momentum`` / ``adam`` / ``adagrad`` (``ops/optim.py``) touch
only its rows.

Two differences from the JAX type, both about the card:

  * ``merge`` keeps the true number of distinct rows. JAX keeps length N
    and pads with the row index ``height``, relying on XLA to clamp the
    padded gathers and drop the padded scatters; on CUDA an index out of
    range is a device-side assert. Its length is data-dependent, so
    merging reads the count back to the host once.
  * sums over duplicate rows are ordered: the entries are stably sorted
    by row and each row's slices summed in their original order
    (``segment_reduce``), so the bits repeat on the card, where a float
    ``index_add_`` adds duplicates by atomics in whatever order they
    land.
"""

from __future__ import annotations

import torch


class SelectedRows:
    """rows: int64 tensor [N] (duplicates allowed); values: [N, *dims];
    height: the dense dim-0 extent."""

    __slots__ = ("rows", "values", "height")

    def __init__(self, rows: torch.Tensor, values: torch.Tensor, height: int):
        self.rows = rows
        self.values = values
        self.height = int(height)

    # -- tensor-protocol conveniences ---------------------------------------
    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    @property
    def ndim(self):
        return self.values.dim()

    def astype(self, dtype):
        return SelectedRows(self.rows, self.values.to(dtype), self.height)

    def __mul__(self, s):
        return SelectedRows(self.rows, self.values * s, self.height)

    __rmul__ = __mul__

    def __neg__(self):
        return SelectedRows(self.rows, -self.values, self.height)

    def __repr__(self):
        return (f"SelectedRows(rows={tuple(self.rows.shape)}, "
                f"values={tuple(self.values.shape)}, height={self.height})")

    # -- conversions ----------------------------------------------------------
    def merge(self) -> "SelectedRows":
        """Distinct rows, ascending, each with the sum of its slices in
        their original order (Fluid's merge_selected_rows_op.cc)."""
        rows, sums = segment_sum_rows(self.rows, self.values)
        return SelectedRows(rows, sums, self.height)

    def to_dense(self) -> torch.Tensor:
        """The dense [height, *dims] gradient, for an update without a
        sparse path. Equal to JAX's scatter-add of zeros, whose indices
        wrap when negative and are dropped past the height (the -1 rows
        ``split_selected_rows`` gives another shard's slots): such rows
        are summed into a scratch row past the end."""
        h = self.height
        rows = self.rows.reshape(-1)
        rows = torch.where(rows < 0, rows + h, rows)
        rows = torch.where((rows >= 0) & (rows < h), rows,
                           torch.full_like(rows, h))
        merged = SelectedRows(rows, self.values, h + 1).merge()
        out = torch.zeros((h + 1,) + tuple(self.values.shape[1:]),
                          dtype=self.values.dtype, device=self.values.device)
        return out.index_copy_(0, merged.rows, merged.values)[:h]

    def concat(self, other: "SelectedRows") -> "SelectedRows":
        """Both entry lists over the same dense tensor (Fluid's sum_op
        over SelectedRows inputs concatenates their rows)."""
        if self.height != other.height:
            raise ValueError(f"height mismatch in sparse sum: {self.height} "
                             f"vs {other.height}")
        return SelectedRows(torch.cat([self.rows, other.rows]),
                            torch.cat([self.values, other.values]),
                            self.height)


def segment_sum_rows(rows: torch.Tensor, values: torch.Tensor, base=None):
    """(distinct rows ascending, per-row sums) of ``values`` grouped by
    ``rows``: a stable sort, then each group summed in its original
    order. With ``base`` ([height, *dims]) each group's sum starts from
    ``base[row]``, ``((base + v1) + v2) + ...``: JAX's scatter-add of the
    slices into ``base``, in its order."""
    rows = rows.reshape(-1)
    tail = tuple(values.shape[1:])
    flat = values.reshape(values.shape[0], -1)
    sorted_rows, order = torch.sort(rows, stable=True)
    uniq, counts = torch.unique_consecutive(sorted_rows, return_counts=True)
    data = flat[order]
    if base is not None:
        # each group's base row first: element j of the sorted slices
        # moves to j + (its group's index) + 1, group g's base row to
        # (the group's first slice) + g
        group = torch.repeat_interleave(
            torch.arange(uniq.numel(), device=rows.device), counts)
        starts = torch.cumsum(counts, 0) - counts
        n = data.shape[0] + uniq.numel()
        combined = data.new_empty((n, data.shape[1]))
        combined[torch.arange(data.shape[0], device=rows.device)
                 + group + 1] = data
        combined[starts + torch.arange(uniq.numel(), device=rows.device)] = \
            base.reshape(base.shape[0], -1)[uniq].to(data.dtype)
        data, counts = combined, counts + 1
    sums = torch.segment_reduce(data, "sum", lengths=counts, axis=0)
    return uniq, sums.reshape((uniq.numel(),) + tail)


def is_selected_rows(x) -> bool:
    return isinstance(x, SelectedRows)
