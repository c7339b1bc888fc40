"""ServingEngine: dynamic micro-batching over the Program Predictor
(counterpart of ``paddle_tpu/serving/engine.py``: the errors,
``ServingFuture``, ``_Request`` and ``ServingEngine``, :95-675).

    submit() --> bounded admission queue --> batcher thread
                                               |  coalesce up to
                                               |  max_batch_size rows or
                                               |  batch_timeout_ms,
                                               v  whichever first
                              batch queue --> N worker threads, each
                                              holding a Predictor.clone()

* Admission: the queue is bounded (``queue_capacity``); a full queue
  raises ``Overloaded`` at submit, before anything is queued.
* Coalescing: requests group by a key of identical non-batch dims,
  except the predictor's sequence feeds, which group by their bucket
  when the predictor buckets shapes. Within a group each request's
  sequence dim is padded up to the group's bucket and the requests are
  concatenated along the batch dim; outputs are split back by rows and
  sliced to each request's true shapes (``Predictor._true_fetch_shapes``).
* Deadlines and cancel: a request whose deadline passes while queued,
  or that its caller cancels, completes with ``DeadlineExceeded`` /
  ``RequestCancelled`` and never reaches the predictor. A batched
  request runs to completion.
* Workers: ``num_workers`` Predictor clones, which share the weights,
  the bound steps and the true-shape cache.
* Drain: ``close(drain=True)`` stops admission and serves what is
  queued (without waiting out batch timeouts); ``close(drain=False)``
  fails queued requests with ``EngineClosed``.

Defaults come from the flags ``serving_max_batch_size``,
``serving_batch_timeout_ms``, ``serving_queue_capacity`` and
``serving_num_workers``, overridable per engine.

The engine registers with the process-wide metrics registry
(``watch_engine``, :232 there: ``paddle_serving_predictor_*{engine=}``
beside its ``paddle_serving_*{engine=}``), opens the ``serving/submit``
and ``serving/batch_execute`` spans (:327, :612) and completes futures
through ``ServingFuture.add_done_callback`` (:119), the traffic tier's
hook. Left out: the autotune seam that pre-tunes the ``serving_*`` knobs
from a recorded profile (:195-202 there, ``autotune_for_program``),
which belongs to ROADMAP A11k with the other autotune equivalents.
"""

from __future__ import annotations

import collections
import contextlib
import queue as _queue_mod
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from ..flags import flag
from ..observability import tracing
from .metrics import ServingMetrics

__all__ = ["ServingError", "Overloaded", "DeadlineExceeded", "EngineClosed",
           "RequestCancelled", "ServingFuture", "ServingEngine"]


class ServingError(RuntimeError):
    """Base class for serving-layer failures."""


class Overloaded(ServingError):
    """Admission queue full, or a request that can never fit: the
    request was rejected, not queued."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before it was served."""


class EngineClosed(ServingError):
    """submit() after close(), or queued work failed by a hard close."""


class RequestCancelled(ServingError):
    """The caller cancelled the request."""


class ServingFuture:
    """Completion handle for one submitted request. ``result()`` returns
    the per-fetch output list (predictor order) or raises the serving
    error the request was completed with."""

    __slots__ = ("_ev", "_lock", "_result", "_error", "_engine",
                 "_callbacks")

    def __init__(self, engine: "ServingEngine"):
        self._ev = threading.Event()
        self._lock = threading.Lock()
        self._result: Optional[List[np.ndarray]] = None
        self._error: Optional[BaseException] = None
        self._engine = engine
        self._callbacks: List = []

    def _complete(self, result=None, error=None) -> bool:
        """First completion wins (expiry vs cancel vs worker result);
        returns whether THIS call won."""
        with self._lock:
            if self._ev.is_set():
                return False
            self._result, self._error = result, error
            self._ev.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — a bad callback is the caller's bug
                pass
        return True

    def add_done_callback(self, fn) -> None:
        """``fn(self)`` on completion, on whichever thread completes it;
        at once when already done. The traffic tier's completion
        accounting rides this instead of a waiter thread per request."""
        with self._lock:
            if not self._ev.is_set():
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception:  # noqa: BLE001
            pass

    def cancel(self) -> bool:
        """Cancel if not yet completed or batched: True if the request
        will never run, False if it already completed."""
        won = self._complete(error=RequestCancelled(
            "request cancelled before batching"))
        if won:
            self._engine.metrics.inc("cancelled_total")
        return won

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        if not self._ev.wait(timeout):
            raise TimeoutError(f"serving result not ready within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def exception(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError(f"serving result not ready within {timeout}s")
        return self._error


class _Request:
    __slots__ = ("arrays", "n_rows", "key", "deadline", "enqueue_t",
                 "future", "ctx")

    def __init__(self, arrays, n_rows, key, deadline, future, ctx=None):
        self.arrays = arrays        # per feed, predictor feed order
        self.n_rows = n_rows
        self.key = key              # batch-compatibility key (None: solo)
        self.deadline = deadline    # absolute time.monotonic() or None
        self.enqueue_t = time.monotonic()
        self.future = future
        self.ctx = ctx              # tracing.SpanContext of the submit span


class ServingEngine:
    """Dynamic-batching front end over a Program ``Predictor``.

        engine = ServingEngine(predictor)            # flag defaults
        fut = engine.submit({"x": arr}, deadline_ms=50)
        outs = fut.result(timeout=1.0)               # per-fetch list
        outs = engine.predict({"x": arr})            # submit + result
        engine.metrics.snapshot()
        engine.predictor_stats()                     # bucket stats, all clones
        engine.close(drain=True)

    ``server.ServingServer`` puts the HTTP front end on it.
    """

    def __init__(self, predictor, max_batch_size: Optional[int] = None,
                 batch_timeout_ms: Optional[float] = None,
                 queue_capacity: Optional[int] = None,
                 num_workers: Optional[int] = None, start: bool = True):
        self._predictor = predictor
        self._feed_names: List[str] = list(predictor.get_input_names())
        self._fetch_names: List[str] = list(predictor.get_output_names())
        cfg = predictor._config
        self._bucketing = bool(getattr(cfg, "_bucketing", False))
        self._seq_buckets = tuple(getattr(cfg, "_seq_buckets", ()) or ())
        self._seq_feeds = set(getattr(predictor, "_seq_feed_names", ()))
        self.max_batch_size = int(max_batch_size if max_batch_size is not None
                                  else flag("serving_max_batch_size"))
        self.batch_timeout_s = float(
            batch_timeout_ms if batch_timeout_ms is not None
            else flag("serving_batch_timeout_ms")) / 1e3
        self.queue_capacity = int(queue_capacity if queue_capacity is not None
                                  else flag("serving_queue_capacity"))
        self.num_workers = max(1, int(num_workers if num_workers is not None
                                      else flag("serving_num_workers")))
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        self.metrics = ServingMetrics()
        # the predictor's bucket stats join the scrape under the same
        # engine= label as the serving series
        from ..observability import watch_engine

        self._obs_id = self.metrics._obs_id
        watch_engine(self)
        self._cond = threading.Condition()
        self._pending: "collections.deque[_Request]" = collections.deque()
        self._closed = False      # admission stopped
        self._stop = False        # the batcher flushes and exits
        # depth num_workers: when every worker is busy the batcher blocks
        # here and requests wait in the bounded admission queue
        self._batch_q: "_queue_mod.Queue" = _queue_mod.Queue(
            maxsize=self.num_workers)
        self._worker_preds = [predictor.clone()
                              for _ in range(self.num_workers)]
        for p in self._worker_preds:
            p.bind_tag = "serving/predict"
        self._batcher: Optional[threading.Thread] = None
        self._workers: List[threading.Thread] = []
        self._started = False
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingEngine":
        """Idempotent: spawn the batcher and the worker threads."""
        with self._cond:
            if self._started:
                return self
            if self._closed:
                raise EngineClosed("engine already closed")
            self._started = True
        self._batcher = threading.Thread(
            target=self._batcher_loop, name="pt-torch-serving-batcher",
            daemon=True)
        self._batcher.start()
        for i, pred in enumerate(self._worker_preds):
            t = threading.Thread(target=self._worker_loop, args=(pred,),
                                 name=f"pt-torch-serving-worker-{i}",
                                 daemon=True)
            t.start()
            self._workers.append(t)
        return self

    def close(self, drain: bool = True, timeout: Optional[float] = 30.0):
        """Stop admission; drain (default) or fail queued requests; join
        the batcher and workers. Safe to call twice."""
        with self._cond:
            already = self._closed and self._stop
            self._closed = True
            if not drain:
                while self._pending:
                    self._pending.popleft().future._complete(
                        error=EngineClosed(
                            "engine closed before the request was batched"))
                self.metrics.set_queue_depth(0)
            self._stop = True
            self._cond.notify_all()
        if already:
            return
        if self._started:
            # the batcher sends the workers' stop sentinels after its
            # flush, so a join timeout only returns early
            self._batcher.join(timeout)
            for t in self._workers:
                t.join(timeout)
        else:
            with self._cond:
                while self._pending:
                    self._pending.popleft().future._complete(
                        error=EngineClosed("engine closed before start()"))
                self.metrics.set_queue_depth(0)

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc):
        self.close(drain=exc[0] is None)

    @property
    def closed(self) -> bool:
        return self._closed

    # -- submission ----------------------------------------------------------
    def submit(self, feed: Union[Dict[str, Any], Sequence[Any]],
               deadline_ms: Optional[float] = None) -> ServingFuture:
        """Admit one request (dict name -> array, or a sequence in feed
        order). Raises ``Overloaded`` when the queue is full and
        ``EngineClosed`` after close(), both before anything is
        queued."""
        arrays = self._normalize_feed(feed)
        n_rows = self._request_rows(arrays)
        key = self._group_key(arrays)
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        fut = ServingFuture(self)
        with (tracing.span("serving/submit", {"rows": n_rows})
              if tracing.enabled() else contextlib.nullcontext()) as ctx:
            req = _Request(arrays, n_rows, key, deadline, fut, ctx=ctx)
            with self._cond:
                if self._closed:
                    raise EngineClosed("ServingEngine is closed")
                if len(self._pending) >= self.queue_capacity:
                    self.metrics.inc("rejected_total")
                    raise Overloaded(
                        f"serving queue full ({self.queue_capacity} "
                        "pending); retry with backoff or raise "
                        "serving_queue_capacity")
                self._pending.append(req)
                self.metrics.inc("requests_total")
                self.metrics.set_queue_depth(len(self._pending))
                self._cond.notify_all()
        return fut

    def predict(self, feed, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None) -> List[np.ndarray]:
        """Synchronous submit + result."""
        return self.submit(feed, deadline_ms=deadline_ms).result(timeout)

    # -- introspection -------------------------------------------------------
    def predictor_stats(self) -> Dict[str, Any]:
        """``Predictor.bucket_stats()`` over every worker clone: summed
        runs, the padding waste from the raw element counts, distinct
        bound buckets from the union of the hit histograms.
        ``request_shapes`` is a lower bound (the largest clone's)."""
        runs = real = padded = 0
        hits: Dict[str, int] = {}
        request_shapes = 0
        for p in self._worker_preds:
            st = p.bucket_stats()
            runs += st["runs"]
            real += st["real_elements"]
            padded += st["padded_elements"]
            request_shapes = max(request_shapes, st["request_shapes"])
            for k, v in st.get("bucket_hits", {}).items():
                hits[k] = hits.get(k, 0) + v
        return {
            "runs": runs,
            "padding_waste": (round(1.0 - real / padded, 4)
                              if padded else 0.0),
            "request_shapes": request_shapes,
            "compiled_shapes": len(hits),
            "bucket_hits": hits,
        }

    def predictor_stats_numeric(self) -> Dict[str, Any]:
        """``predictor_stats()`` without the per-bucket histogram."""
        st = self.predictor_stats()
        st.pop("bucket_hits", None)
        return st

    def stats(self) -> Dict[str, Any]:
        """Serving metrics and the aggregated predictor bucket stats in
        one JSON-serializable dict."""
        return {"serving": self.metrics.snapshot(),
                "predictor": self.predictor_stats()}

    # -- request shaping -----------------------------------------------------
    def _normalize_feed(self, feed) -> List[np.ndarray]:
        if isinstance(feed, dict):
            missing = [n for n in self._feed_names if n not in feed]
            extra = [n for n in feed if n not in self._feed_names]
            if missing or extra:
                raise ValueError(
                    f"feed names mismatch: missing {missing}, "
                    f"unexpected {extra}; expected {self._feed_names}")
            ordered = [feed[n] for n in self._feed_names]
        else:
            ordered = list(feed)
            if len(ordered) != len(self._feed_names):
                raise ValueError(
                    f"expected {len(self._feed_names)} feeds "
                    f"({self._feed_names}), got {len(ordered)}")
        return [np.asarray(a) for a in ordered]

    def _request_rows(self, arrays: List[np.ndarray]) -> int:
        rows = {int(a.shape[0]) for a in arrays if a.ndim >= 1}
        if len(rows) > 1:
            raise ValueError(
                f"inconsistent batch dims across feeds: {sorted(rows)}")
        return rows.pop() if rows else 1

    def _group_key(self, arrays: List[np.ndarray]):
        """Two requests batch together iff their keys are equal: same
        dtypes and non-batch dims, sequence dims compared by bucket
        when bucketing is on. A scalar feed cannot be concatenated: key
        None serves the request alone."""
        key = []
        for name, a in zip(self._feed_names, arrays):
            if a.ndim == 0:
                return None
            dims = list(a.shape[1:])
            if (self._bucketing and name in self._seq_feeds
                    and a.ndim >= 2 and self._seq_buckets):
                dims[0] = self._predictor._bucket_of(int(a.shape[1]),
                                                     self._seq_buckets)
            key.append((name, a.dtype.str, tuple(dims)))
        return tuple(key)

    # -- batcher -------------------------------------------------------------
    def _expire(self, req: _Request, now: float) -> None:
        if req.future._complete(error=DeadlineExceeded(
                f"deadline passed after "
                f"{(now - req.enqueue_t) * 1e3:.1f}ms in queue")):
            self.metrics.inc("expired_total")

    def _pop_next_live_locked(self) -> Optional[_Request]:
        """The oldest request still worth serving; expired and cancelled
        ones are completed and dropped on the way."""
        now = time.monotonic()
        while self._pending:
            req = self._pending.popleft()
            if req.future.done():            # cancelled by the caller
                continue
            if req.deadline is not None and now > req.deadline:
                self._expire(req, now)
                continue
            return req
        return None

    def _pop_compatible_locked(self, key, max_rows: int) -> Optional[_Request]:
        """The oldest queued request that fits the open batch (same key,
        at most ``max_rows`` rows); expired and cancelled requests are
        dropped whatever their key."""
        now = time.monotonic()
        i = 0
        while i < len(self._pending):
            req = self._pending[i]
            if req.future.done():
                del self._pending[i]
                continue
            if req.deadline is not None and now > req.deadline:
                del self._pending[i]
                self._expire(req, now)
                continue
            if key is not None and req.key == key and req.n_rows <= max_rows:
                del self._pending[i]
                return req
            i += 1
        return None

    def _collect_batch(self) -> Optional[List[_Request]]:
        """Block until a batch is ready: the first request and compatible
        followers up to max_batch_size rows or the batch timeout,
        whichever first (no waiting while draining). None: shut down."""
        with self._cond:
            while True:
                first = self._pop_next_live_locked()
                if first is not None:
                    break
                if self._stop:
                    self.metrics.set_queue_depth(len(self._pending))
                    return None
                self._cond.wait(0.1)
            batch = [first]
            rows = first.n_rows
            t_close = time.monotonic() + self.batch_timeout_s
            while rows < self.max_batch_size and first.key is not None:
                nxt = self._pop_compatible_locked(
                    first.key, self.max_batch_size - rows)
                if nxt is not None:
                    batch.append(nxt)
                    rows += nxt.n_rows
                    continue
                if self._stop:
                    break
                remaining = t_close - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(min(remaining, 0.05))
            self.metrics.set_queue_depth(len(self._pending))
        return batch

    def _batcher_loop(self):
        try:
            while True:
                batch = self._collect_batch()
                if batch is None:
                    return
                rows = sum(r.n_rows for r in batch)
                self.metrics.observe_batch(len(batch), rows,
                                           self.max_batch_size)
                now = time.monotonic()
                for r in batch:
                    self.metrics.observe_queue_wait((now - r.enqueue_t) * 1e3)
                self._batch_q.put(batch)
        finally:
            # the stop sentinels go in strictly after the last batch
            for _ in range(self.num_workers):
                self._batch_q.put(None)

    # -- workers -------------------------------------------------------------
    def _worker_loop(self, pred):
        while True:
            batch = self._batch_q.get()
            if batch is None:
                return
            self._execute(pred, batch)

    def _assemble(self, batch: List[_Request]):
        """The members concatenated along the batch dim, each sequence
        dim padded up to the group's bucket first. Returns (feeds,
        padded_any): padded_any means member outputs may come back at
        the padded length and need slicing to their true shapes."""
        feeds = []
        real = total = 0
        padded_any = False
        for fi, _name in enumerate(self._feed_names):
            parts = []
            target = None
            if len(batch) > 1 and batch[0].key is not None:
                target = batch[0].key[fi][2]  # non-batch dims, bucketed
            for req in batch:
                a = req.arrays[fi]
                if target is not None and a.ndim >= 2 \
                        and tuple(a.shape[1:]) != target:
                    pads = [(0, 0)] + [
                        (0, t - s) for t, s in zip(target, a.shape[1:])]
                    a = np.pad(a, pads)
                    padded_any = True
                real += int(req.arrays[fi].size)
                total += int(a.size)
                parts.append(a)
            feeds.append(np.concatenate(parts, axis=0)
                         if len(parts) > 1 else parts[0])
        if total:
            self.metrics.record_padding(real, total)
        return feeds, padded_any

    def _true_shapes_for(self, pred, req: _Request):
        """Per-fetch output shapes at the request's TRUE feed shapes
        (the predictor's meta-tensor evaluation, cached per signature):
        a request gets the same output shape solo or coalesced."""
        feed = dict(zip(self._feed_names, req.arrays))
        with pred._lock:
            return pred._true_fetch_shapes(feed)

    def _execute(self, pred, batch: List[_Request]):
        try:
            feeds, padded_any = self._assemble(batch)
            # the batch span parents to the first member's submit span
            # and names every other member's in flow_from
            flow = [r.ctx.span_id for r in batch[1:] if r.ctx is not None]
            with tracing.span(
                    f"serving/batch_execute[n={len(batch)}]",
                    {"rows": sum(r.n_rows for r in batch),
                     **({"flow_from": flow} if flow else {})},
                    parent=batch[0].ctx):
                outs = pred.run(feeds)
            true_shapes = ([self._true_shapes_for(pred, r) for r in batch]
                           if padded_any else None)
            done = self._split_and_complete(batch, outs, true_shapes)
            now = time.monotonic()
            for req in batch:
                self.metrics.observe_latency((now - req.enqueue_t) * 1e3)
            self.metrics.inc("responses_total", done)
        except Exception as e:  # noqa: BLE001 — a bad batch must not kill the worker
            n = 0
            for req in batch:
                if req.future._complete(error=ServingError(
                        f"predictor execution failed: {e!r}")):
                    n += 1
            self.metrics.inc("errors_total", n)

    def _split_and_complete(self, batch: List[_Request],
                            outs: Sequence[np.ndarray],
                            true_shapes=None) -> int:
        """Row-split the batched outputs back per request (sliced to the
        true shapes when the engine padded the batch); returns how many
        futures this call completed (a concurrent cancel may win)."""
        total_rows = sum(r.n_rows for r in batch)
        offset = 0
        won = 0
        for i, req in enumerate(batch):
            sliced = []
            for j, o in enumerate(outs):
                o = np.asarray(o)
                if o.ndim >= 1 and o.shape[0] == total_rows:
                    o = o[offset:offset + req.n_rows]
                    if true_shapes is not None:
                        ts = tuple(true_shapes[i][j])
                        if o.shape != ts:
                            o = o[tuple(slice(0, s) for s in ts)]
                # else: a batch-invariant output; every member gets it
                sliced.append(o)
            offset += req.n_rows
            if req.future._complete(result=sliced):
                won += 1
        return won
