"""DataLoader: host-side batching and asynchronous device prefetch.

The port's copy of ``paddle_tpu/reader.py``. Reference:
python/paddle/fluid/reader.py (PyReader/DataLoader over C++ blocking
queues) and operators/reader/buffered_reader.cc (the asynchronous GPU
prefetch). A background thread batches, normalizes each batch to the
dtypes ``Executor.run`` would give it, stages it in pinned memory and
copies it to the card on a stream of its own, ahead of the step: the
copy of batch N+1 overlaps the step of batch N
(``runtime/prefetch.py``). The consumer orders its stream after the
copy before it sees the batch. Rank sharding replaces the reference's
DistributedBatchSampler: each trainer takes every num_trainers-th
sample, and the ranks are padded to the same count.

The device is ``places[0]`` of ``set_*_generator`` (``CUDAPlace(0)``
when none is given, which raises without a card); ``CPUPlace()``
prefetches host tensors. With ``use_double_buffer=False`` the loader
yields the host batches as they come.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import List

from .core.executor import torch_dtype
from .core.framework import Variable
from .core.places import CUDAPlace
from .observability import tracing
from .runtime.prefetch import DeviceStager, claim, host_tensor

__all__ = ["DataLoader", "GeneratorLoader"]


class DataLoader:
    @staticmethod
    def from_generator(
        feed_list=None,
        capacity=64,
        use_double_buffer=True,
        iterable=True,
        return_list=False,
        use_multiprocess=False,
    ) -> "GeneratorLoader":
        return GeneratorLoader(feed_list, capacity, use_double_buffer,
                               iterable)


class GeneratorLoader:
    def __init__(self, feed_list, capacity=64, use_double_buffer=True,
                 iterable=True, trainer_id=None, num_trainers=None,
                 prefetch_depth=None):
        self.feed_list = feed_list or []
        self.capacity = capacity
        self.use_double_buffer = use_double_buffer
        self.iterable = iterable
        # device prefetch depth: an explicit argument wins, else the
        # live flag `reader_prefetch_depth` (read when an iteration
        # starts, so a flag change applies to the NEXT epoch). Each entry
        # holds one batch of device memory.
        self._prefetch_depth = (None if prefetch_depth is None
                                else max(1, int(prefetch_depth)))
        self._active_depth = 0      # what the current iteration uses
        # stall counters (paddle_reader_buffer_*_stall_total): full = the
        # producer blocked, the consumer / device is the bottleneck;
        # empty = the consumer blocked, the input pipeline starves it
        self._stall_full = 0
        self._stall_empty = 0
        self._places = None
        self._batch_reader = None
        # resumable position (resilience/): batches handed to the
        # consumer since iteration started; a resumed run fast-forwards
        # the stream to where the killed run left off
        self._position = 0
        self._resume_from = 0
        # rank sharding (reference DistributedBatchSampler): defaults
        # from the launcher's env contract
        self.trainer_id = (
            int(os.environ.get("PADDLE_TRAINER_ID", 0))
            if trainer_id is None else int(trainer_id)
        )
        self.num_trainers = (
            int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
            if num_trainers is None else int(num_trainers)
        )
        # unified telemetry: queue depth, position and stalls as
        # paddle_reader_* gauges (the prefetch queue draining to 0 is the
        # input-bound signal)
        self._obs_queue = None
        from .observability import watch_loader

        watch_loader(self)

    # reference API: set_sample_generator / set_sample_list_generator /
    # set_batch_generator
    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None):
        def batcher():
            buf = []
            mine = 0
            total = 0
            head = []  # wrap-around pool for rank equalization
            for i, sample in enumerate(reader()):
                total = i + 1
                s = sample if isinstance(sample, (list, tuple)) else (sample,)
                if len(head) < max(self.num_trainers, 1):
                    head.append(s)
                if (self.num_trainers > 1
                        and i % self.num_trainers != self.trainer_id):
                    continue
                mine += 1
                buf.append(s)
                if len(buf) == batch_size:
                    yield buf
                    buf = []
            if self.num_trainers > 1:
                # every rank must emit the SAME number of samples or a
                # collective trainer deadlocks waiting for the others
                # (reference DistributedBatchSampler pads by wrapping)
                target = -(-total // self.num_trainers)
                k = 0
                while mine < target and head:
                    buf.append(head[k % len(head)])
                    k += 1
                    mine += 1
                    if len(buf) == batch_size:
                        yield buf
                        buf = []
            if buf and not drop_last:
                yield buf

        return self.set_sample_list_generator(batcher, places)

    def set_sample_list_generator(self, reader, places=None):
        from .data_feeder import DataFeeder

        feeder = DataFeeder(self.feed_list)

        def batches():
            for rows in reader():
                yield feeder.feed(rows)

        self._batch_reader = batches
        self._places = places
        return self

    def set_batch_generator(self, reader, places=None):
        names = [v.name for v in self.feed_list]

        def batches():
            for batch in reader():
                if isinstance(batch, dict):
                    yield batch
                else:
                    yield dict(zip(names, batch))

        self._batch_reader = batches
        self._places = places
        return self

    def _device(self):
        places = self._places
        if places is None:
            return CUDAPlace(0).torch_device()
        if isinstance(places, (list, tuple)):
            places = places[0]
        return places.torch_device()

    def _dtypes(self):
        """name -> the torch dtype its feed variable declares: the cast
        ``Executor.run`` applies to a numpy feed of that name."""
        return {v.name: torch_dtype(v.dtype) for v in self.feed_list
                if isinstance(v, Variable)}

    def shard_info(self) -> dict:
        """This loader's slice of the multi-host world (scraped as
        paddle_reader_trainer_id / paddle_reader_num_trainers)."""
        return {"trainer_id": self.trainer_id,
                "num_trainers": self.num_trainers}

    # -- resumable position (checkpoint/restore contract) -------------------
    def position(self) -> int:
        """Batches handed to the consumer since iteration started (the
        step count a supervised training loop has consumed)."""
        return self._position

    def state_dict(self) -> dict:
        return {"position": self._position}

    def set_state(self, state: dict):
        self.set_resume_position(int(state.get("position", 0)))

    def set_resume_position(self, n: int):
        """Fast-forward the NEXT iteration past its first n batches: they
        are drawn from the generator (keeping a stateful reader
        deterministic) but neither copied to the device nor yielded."""
        self._resume_from = max(0, int(n))

    def _positioned_batches(self):
        """The batch stream with the resume fast-forward applied; bumps
        no counter (the consumer-visible position is counted at yield)."""
        skip = self._resume_from
        self._resume_from = 0
        self._position = skip
        for i, b in enumerate(self._batch_reader()):
            if i < skip:
                continue
            yield b

    def __iter__(self):
        if self._batch_reader is None:
            raise RuntimeError("no generator set; call set_*_generator first")
        if not self.use_double_buffer:
            for b in self._positioned_batches():
                # count BEFORE the yield: code after a yield runs only on
                # the NEXT pull, which would leave the final batch
                # uncounted in a checkpoint taken mid-iteration
                self._position += 1
                yield b
            return
        # bounded DEVICE buffer (depth 2 = double buffering by default):
        # each entry holds a batch of device memory, so `capacity` host
        # batches would hold capacity x batch bytes for no more overlap
        from .flags import flag

        stager = DeviceStager(self._device())
        dtypes = self._dtypes()
        depth = (self._prefetch_depth if self._prefetch_depth is not None
                 else max(1, int(flag("reader_prefetch_depth"))))
        self._active_depth = depth
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._obs_queue = q  # scraped as paddle_reader_queue_depth
        stop = object()
        halt = threading.Event()
        err: List[BaseException] = []

        def put(item) -> bool:
            while not halt.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in self._positioned_batches():
                    if halt.is_set():
                        return
                    with tracing.span("reader/prefetch"):
                        names = list(b)
                        staged = stager.stage(
                            [host_tensor(b[n], dtypes.get(n)) for n in names])
                    item = (names, staged)
                    try:
                        q.put_nowait(item)
                    except queue.Full:
                        # buffer full: the consumer is the bottleneck
                        # (device-bound): counted, then block normally
                        self._stall_full += 1
                        if not put(item):
                            return
            except BaseException as e:  # noqa: BLE001 — raised to the consumer
                # record BEFORE the stop sentinel: the consumer checks err
                # on every get, so the error is visible by the time stop
                # (or any later batch) arrives
                err.append(e)
            finally:
                put(stop)

        t = threading.Thread(target=worker, name="pt-reader-prefetch",
                             daemon=True)
        t.start()
        yielded = False
        try:
            while True:
                try:
                    item = q.get_nowait()
                    waited = False
                except queue.Empty:
                    waited = True
                    item = q.get()
                if err:
                    # fail fast on the NEXT __next__, even with good
                    # batches still buffered ahead of the sentinel:
                    # training on a known-truncated epoch skews the data
                    raise err[0]
                if item is stop:
                    break
                if waited and yielded:
                    # buffer empty on a mid-stream batch: the input
                    # pipeline starves the device. The pipeline-fill wait
                    # and the end-of-stream wait are not starvation.
                    self._stall_empty += 1
                names, (tensors, event) = item
                batch = dict(zip(names, claim(tensors, event)))
                self._position += 1
                yielded = True
                yield batch
        finally:
            # an epoch that ends, fails or is abandoned (the generator
            # closed) stops the worker and drops every staged batch: no
            # thread left parked on a full queue holding device memory
            halt.set()
            _drain(q)
            t.join(timeout=5.0)
            _drain(q)   # a put that was mid-wait when halt was set

    # non-iterable (start/reset) mode parity
    def start(self):
        self._iter = iter(self)

    def reset(self):
        self._iter = None


def _drain(q: "queue.Queue") -> None:
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass
