"""Dataset API: high-throughput file-based ingest.

The port's copy of ``paddle_tpu/dataset.py``. Reference:
python/paddle/fluid/dataset.py:22-47 (DatasetFactory,
QueueDataset, InMemoryDataset) wrapping the C++ MultiSlotDataFeed
(framework/data_feed.h:61, data_feed.proto) — multi-threaded
file->channel parsing with global shuffle via fleet RPC
(framework/data_set.cc).

Parsing runs in the port's native C++ datafeed library
(native/datafeed.cpp, loaded via ctypes) when it builds; the Python
parser (``_parse_file_py``) is its plain version. Batches are numpy
dicts in the dtypes the feed variables declare (integer slots int64);
``Executor.train_from_dataset`` (``dataset_runner.py``) moves them to
the device. ``global_shuffle`` deals every rank the same
seed-synchronized permutation of the full load and keeps its slice.
"""

from __future__ import annotations

import os
import random
import threading
import queue as _queue
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class DatasetFactory:
    """Reference dataset.py DatasetFactory.create_dataset."""

    def create_dataset(self, datafeed_class: str = "QueueDataset"):
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        raise ValueError(f"unknown dataset class {datafeed_class!r}")


class DatasetBase:
    def __init__(self):
        self._batch_size = 1
        self._thread_num = 1
        self._filelist: List[str] = []
        self._use_var_names: List[str] = []
        self._var_shapes: Dict[str, tuple] = {}
        self._var_dtypes: Dict[str, str] = {}
        self._pipe_command = None

    # -- reference API --------------------------------------------------------
    def set_batch_size(self, batch_size: int):
        self._batch_size = batch_size

    def set_thread(self, thread_num: int):
        self._thread_num = thread_num

    def set_filelist(self, filelist: Sequence[str]):
        self._filelist = list(filelist)

    def set_use_var(self, var_list):
        self._use_var_names = [v.name for v in var_list]
        for v in var_list:
            self._var_shapes[v.name] = tuple(
                d for d in (v.shape or ()) if d is not None and d > 0
            )
            self._var_dtypes[v.name] = v.dtype

    def set_pipe_command(self, cmd: str):
        self._pipe_command = cmd

    def get_filelist(self):
        return self._filelist

    # -- parsing --------------------------------------------------------------
    def _parse_file(self, path: str) -> Iterator[List[np.ndarray]]:
        """MultiSlot text format (reference MultiSlotDataFeed): each
        line = for each slot: <n> v1 ... vn. Uses the native parser
        when available."""
        from .native import datafeed as native_feed

        dtypes = [self._var_dtypes[n] for n in self._use_var_names]
        if native_feed.available():
            yield from native_feed.parse_file(path, len(self._use_var_names), dtypes)
            return
        yield from self._parse_file_py(path)

    def _parse_file_py(self, path: str) -> Iterator[List[np.ndarray]]:
        """The plain Python parser of the same format (a malformed line
        raises where the native parser drops it)."""
        dtypes = [self._var_dtypes[n] for n in self._use_var_names]
        with open(path) as f:
            for line in f:
                parts = line.split()
                i = 0
                sample = []
                for slot_i in range(len(self._use_var_names)):
                    n = int(parts[i])
                    i += 1
                    vals = parts[i : i + n]
                    i += n
                    dt = dtypes[slot_i]
                    arr = np.array(vals, dtype=np.float32 if "float" in dt else np.int64)
                    sample.append(arr)
                yield sample

    def _iter_samples(self) -> Iterator[List[np.ndarray]]:
        for path in self._filelist:
            yield from self._parse_file(path)

    def _iter_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Multi-threaded file parsing feeding a bounded channel
        (reference data_feed channels), batched for the executor."""
        chan: "_queue.Queue" = _queue.Queue(maxsize=4 * self._thread_num * self._batch_size)
        stop = object()
        files = list(self._filelist)
        errors: List[BaseException] = []

        def worker(paths):
            # a parse error ends this worker's share and is raised to the
            # consumer; its stop still arrives, or the consumer would wait
            # for it forever (the JAX package's worker has no such guard)
            try:
                for p in paths:
                    for s in self._parse_file(p):
                        chan.put(s)
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)
            finally:
                chan.put(stop)

        nthreads = max(1, min(self._thread_num, len(files) or 1))
        shards = [files[i::nthreads] for i in range(nthreads)]
        for sh in shards:
            threading.Thread(target=worker, args=(sh,), name="pt-datafeed",
                             daemon=True).start()

        done = 0
        buf: List[List[np.ndarray]] = []
        while done < nthreads:
            item = chan.get()
            if item is stop:
                done += 1
                if errors:
                    raise errors[0]
                continue
            buf.append(item)
            if len(buf) == self._batch_size:
                yield self._collate(buf)
                buf = []
        if buf:
            yield self._collate(buf)

    def _collate(self, rows: List[List[np.ndarray]]) -> Dict[str, np.ndarray]:
        out = {}
        for i, name in enumerate(self._use_var_names):
            cols = [r[i] for r in rows]
            arr = np.stack(cols, axis=0)
            shp = self._var_shapes.get(name)
            if shp:
                arr = arr.reshape((arr.shape[0],) + shp)
            want = self._var_dtypes[name]
            if "int" in want:
                arr = arr.astype(np.int64)
            out[name] = arr
        return out


class QueueDataset(DatasetBase):
    """Streaming dataset (reference QueueDataset): files parsed on the
    fly, no global shuffle."""


class InMemoryDataset(DatasetBase):
    """Reference InMemoryDataset: load_into_memory + local/global
    shuffle + merge."""

    def __init__(self):
        super().__init__()
        self._samples: List[List[np.ndarray]] = []

    def load_into_memory(self):
        self._samples = list(self._iter_samples())

    def local_shuffle(self, seed: Optional[int] = None):
        random.Random(seed).shuffle(self._samples)

    def global_shuffle(self, fleet=None, thread_num: int = 12, seed: Optional[int] = None):
        """Shuffle across ALL trainers (reference data_set.cc
        GlobalShuffle ships samples between workers over fleet RPC).

        TPU-native: every rank loads the same source and applies one
        seed-synchronized permutation, then keeps its rank's slice —
        the same resulting partition as the reference's exchange with
        zero cross-worker traffic. Rank/world come from `fleet` when
        given, else the launcher env contract."""
        import os

        if fleet is not None:
            rank, world = fleet.worker_index(), max(fleet.worker_num(), 1)
        else:
            rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
            world = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
        # always partition from the FULL load: calling global_shuffle
        # once per epoch must re-deal the same deck, not slice the
        # rank's previous slice to nothing
        if not hasattr(self, "_full_samples"):
            self._full_samples = list(self._samples)
        self._shuffle_epoch = getattr(self, "_shuffle_epoch", 0) + 1
        if seed is None:
            # must agree across ranks; vary per epoch deterministically
            seed = self._shuffle_epoch
        rng = random.Random(seed)
        order = list(range(len(self._full_samples)))
        rng.shuffle(order)
        self._samples = [self._full_samples[i] for i in order[rank::world]]

    def release_memory(self):
        self._samples = []

    def get_memory_data_size(self, fleet=None):
        return len(self._samples)

    def _iter_batches(self):
        buf = []
        for s in self._samples:
            buf.append(s)
            if len(buf) == self._batch_size:
                yield self._collate(buf)
                buf = []
        if buf:
            yield self._collate(buf)
