"""The dataset path's training loop: the port's copy of
``paddle_tpu/dataset_runner.py`` (reference Executor.train_from_dataset
-> MultiTrainer / HogwildWorker, framework/multi_trainer.cc:157,
framework/hogwild_worker.cc).

thread <= 1: one bound step a batch through ``Executor.run``.
thread > 1: HogwildWorker semantics. N threads pull batches from one
channel and run the SAME program against the SHARED scope without
synchronization, through a dedicated Executor cached on the caller
(``_hogwild_exe``), so repeated epochs reuse its bound steps.

What the threads share, and which races are whose:

* the reference's accepted trade, last writer wins: every parameter and
  optimizer-state write (a fused update rewrites a tensor in place, an
  unfused one replaces it in the scope), the learning-rate and beta-power
  counters, and a bound step's cached state refs, which a thread may
  refresh from a scope another thread has just written (the scope's
  generation then looks stale and forces one more resolve, which is
  harmless);
* races that would be a crash, and why they cannot happen: the bound-step
  cache and the run counter that seeds every op's generator are taken
  under the executor's lock (each step draws its own step number); the
  scope generation moves under the scope lock; autograd's saved-tensor
  version check would fail a step whose parameter another thread
  updated in place between its forward and its backward, so every step
  runs under pass-through saved-tensor hooks, which read what is there
  at the backward (Hogwild's semantics) instead of raising. On CUDA the
  threads launch on one stream, so no two kernels of different steps
  run at once.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading

import torch

__all__ = ["run_from_dataset"]

# status lines keep off stdout: a serving process or a pipe-reading tool
# shares this process's stdout
_log = logging.getLogger("paddle_tpu_torch.dataset")


def run_from_dataset(executor, program, dataset, scope, fetch_list=None,
                     fetch_info=None, print_period=100, train=True,
                     thread=0):
    if dataset is None:
        raise ValueError("dataset is required")
    fetch_list = fetch_list or []
    fetch_info = fetch_info or [v.name if hasattr(v, "name") else str(v)
                                for v in fetch_list]
    if thread and thread > 1:
        return _run_hogwild(executor, program, dataset, scope, fetch_list,
                            fetch_info, print_period, int(thread))
    step = 0
    results = None
    for batch in dataset._iter_batches():
        results = executor.run(program=program, feed=batch,
                               fetch_list=fetch_list, scope=scope)
        if fetch_list and step % print_period == 0:
            msgs = ", ".join(f"{n}={float(r.reshape(-1)[0]):.6f}"
                             for n, r in zip(fetch_info, results))
            _log.info("[dataset] step %d: %s", step, msgs)
        step += 1
    return results


def _keep(t):
    return t


def _run_hogwild(executor, program, dataset, scope, fetch_list, fetch_info,
                 print_period, n_threads):
    from .core.executor import Executor

    exe = getattr(executor, "_hogwild_exe", None)
    if exe is None:
        exe = Executor(executor.place)
        executor._hogwild_exe = exe
    # the steps run on the caller's stream, as its own would
    stream = (torch.cuda.current_stream(exe.device)
              if exe.device.type == "cuda" else None)

    channel: "queue.Queue" = queue.Queue(maxsize=2 * n_threads)
    stop = object()
    errors = []
    last = [None]
    counter = [0]
    lock = threading.Lock()

    def worker(tid):
        try:
            with torch.autograd.graph.saved_tensors_hooks(_keep, _keep), \
                    (torch.cuda.stream(stream) if stream is not None
                     else contextlib.nullcontext()):
                while True:
                    b = channel.get()
                    if b is stop:
                        return
                    r = exe.run(program=program, feed=b,
                                fetch_list=fetch_list, scope=scope)
                    with lock:
                        counter[0] += 1
                        last[0] = r
                        step = counter[0]
                    if fetch_list and step % print_period == 0:
                        msgs = ", ".join(f"{n}={float(v.reshape(-1)[0]):.6f}"
                                         for n, v in zip(fetch_info, r))
                        _log.info("[dataset hogwild t%d] step %d: %s", tid,
                                  step, msgs)
        except BaseException as e:  # noqa: BLE001 — raised by the caller
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,),
                                name=f"pt-hogwild-{i}", daemon=True)
               for i in range(n_threads)]
    for t in threads:
        t.start()
    try:
        for batch in dataset._iter_batches():
            # timed put + liveness check: if every worker died on an error
            # the bounded queue would block us forever
            while True:
                if errors or not any(t.is_alive() for t in threads):
                    break
                try:
                    channel.put(batch, timeout=1.0)
                    break
                except queue.Full:
                    continue
            if errors or not any(t.is_alive() for t in threads):
                break
    finally:
        # always deliver ALL sentinels, even when the dataset iterator
        # raises: a worker left without one blocks on channel.get forever
        # and keeps mutating the shared scope. Queued REAL batches are
        # dropped only on the error path (workers dead or wedged); at a
        # normal epoch end they drain first.
        for _ in threads:
            attempts = 0
            while True:
                try:
                    channel.put(stop, timeout=1.0)
                    break
                except queue.Full:
                    attempts += 1
                    if (errors or attempts > 120
                            or not any(t.is_alive() for t in threads)):
                        try:
                            channel.get_nowait()  # make room: abandon run
                        except queue.Empty:
                            pass
        for t in threads:
            t.join(timeout=120.0)
    if errors:
        raise errors[0]
    return last[0]

