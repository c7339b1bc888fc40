"""TrafficController: SLO-aware scheduling between front end and engines
(the counterpart of ``paddle_tpu/traffic/controller.py``).

This layer owns every decision between
"a request arrived with metadata" and "the engine got handed work",
for BOTH the stateless predict path (``ServingEngine``) and the
autoregressive generation path (``GenerationEngine``):

    submit(feed, tenant=, priority=, deadline_ms=)
        │ 1. quota:      tenant token bucket (dry -> shed "quota")
        │ 2. feasibility: estimated wait + service vs deadline
        │                 (provably unmeetable -> shed "infeasible")
        │ 3. queueing:   per-class/per-tenant bounded FIFO
        │                 (class full -> shed "queue_full")
        ▼
    dispatcher thread ── strict-priority pick with AGING (a queued
        │                batch/best_effort request promotes one class
        │                per traffic_aging_ms, so priority cannot
        │                starve it), re-checks feasibility at dispatch
        │                (deadline now unmeetable -> shed BEFORE the
        │                request costs a batch slot)
        ▼
    engine.submit(...) / generation_engine.submit(...)
        bounded in-flight (traffic_max_inflight), completion callbacks
        feed goodput / deadline-miss / drain-rate accounting

Every shed raises (or completes the ticket with) ``TrafficShed`` — an
``Overloaded`` subclass carrying ``retry_after_s`` computed from the
measured queue-drain rate (quota sheds: from the token-bucket refill),
so the HTTP layer's 503 tells the client WHEN retrying will help.

Sustained SLO breach (deadline-miss ratio over
``traffic_slo_miss_threshold`` for ``traffic_slo_window_s``) dumps the
flight recorder once per breach episode: the ring of spans and
step samples that led into the overload is on disk before anyone files
the incident.

Service-time estimates come from the live telemetry the stack already
exports: the ``paddle_step_*`` wall-time quantiles (observability
registry) plus the engine's batch-close timeout for predict, and the
measured TTFT/inter-token quantiles for generation. No estimate ->
no shedding-on-estimate (cold start admits optimistically; the
engine's own deadline expiry still backstops).

Determinism for tests: ``clock=`` injects fake time everywhere
(buckets, aging, windows) and ``start=False`` + ``pump()`` runs the
dispatcher synchronously.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..observability import tracing
from ..serving.engine import Overloaded, RequestCancelled, ServingError
from .admission import (CLASSES, ClassQueues, TokenBucket, TrafficConfig,
                        class_index, normalize_class)
from .metrics import TrafficMetrics

__all__ = ["TrafficShed", "TrafficTicket", "ServiceTimeEstimator",
           "TrafficController", "engine_retry_after",
           "generation_retry_after"]


class TrafficShed(Overloaded):
    """Request shed by the traffic layer before any engine work.
    ``kind`` in {"quota", "queue_full", "infeasible", "backend",
    "closed", "adapter"}; ``retry_after_s`` is the computed client
    backoff. "adapter" means the requested LoRA adapter is not
    resident on this worker — the router should upload or place
    elsewhere rather than blind-retry."""

    def __init__(self, msg: str, kind: str, retry_after_s: float):
        super().__init__(msg)
        self.kind = kind
        self.retry_after_s = float(retry_after_s)


def _clamp_retry(s: float) -> float:
    return min(30.0, max(0.05, float(s)))


def engine_retry_after(engine) -> float:
    """Retry-After estimate for a BARE ServingEngine 503 (no traffic
    controller attached): queued work over the engine's best-case
    drain bandwidth (max_batch rows per median batch latency across
    the worker pool). Coarse by design — the controller's measured
    drain rate replaces it when the traffic layer is in front."""
    try:
        snap = engine.metrics.snapshot()
        depth = snap.get("queue_depth")
        if depth is None:       # a MEASURED 0 is an empty queue, not
            depth = engine.queue_capacity   # an unknown one
        lat_ms = snap["latency_ms"]["p50"] or 0.0
        per_batch_s = (lat_ms / 1e3) if lat_ms > 0 else 0.1
        bandwidth = (engine.max_batch_size * engine.num_workers
                     / per_batch_s)
        return _clamp_retry((depth + 1) / max(bandwidth, 1e-6))
    except Exception:  # noqa: BLE001 — a 503 must never become a 500
        return 1.0


def generation_retry_after(gen_engine) -> float:
    """Retry-After for a BARE GenerationEngine 503: queued prompts
    over the measured admission bandwidth (median TTFT approximates
    one queue slot's holding time across the lane pool)."""
    try:
        depth = gen_engine.queue_depth()
        snap = gen_engine.metrics.snapshot()
        ttft_ms = snap["ttft_ms"]["p50"] or 100.0
        lanes = max(1, int(getattr(gen_engine, "lanes", 1)))
        return _clamp_retry((depth + 1) * (ttft_ms / 1e3) / lanes)
    except Exception:  # noqa: BLE001 — a 503 must never become a 500
        return 1.0


class TrafficTicket:
    """Completion handle for one admitted request. Predict tickets
    resolve to the per-fetch output list; generation tickets expose
    ``stream()`` (the ``GenerationStream``, available the moment the
    dispatcher hands the prompt to the engine) and resolve to the
    token list."""

    __slots__ = ("cls", "tenant", "_ev", "_lock", "_result", "_error",
                 "_stream", "_stream_ev", "_controller", "_req",
                 "_callbacks")

    def __init__(self, controller, cls: str, tenant: str):
        self.cls = cls
        self.tenant = tenant
        self._controller = controller
        self._req = None               # back-ref set at enqueue
        self._ev = threading.Event()
        self._lock = threading.Lock()
        self._result = None
        self._error: Optional[BaseException] = None
        self._stream = None
        self._stream_ev = threading.Event()
        self._callbacks: List = []

    # -- controller side -----------------------------------------------------
    def _complete(self, result=None, error=None) -> bool:
        with self._lock:
            if self._ev.is_set():
                return False
            self._result, self._error = result, error
            self._ev.set()
            # a shed/failed generation never gets a stream: release
            # stream() waiters into the terminal error
            self._stream_ev.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — a bad callback is the caller's bug
                pass
        return True

    def add_done_callback(self, fn) -> None:
        """``fn(self)`` at the terminal state (immediately if already
        done) — open-loop load drivers account completions without a
        waiter thread per request."""
        with self._lock:
            if not self._ev.is_set():
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception:  # noqa: BLE001
            pass

    def _set_stream(self, stream) -> None:
        self._stream = stream
        self._stream_ev.set()

    # -- caller side ---------------------------------------------------------
    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError(f"traffic result not ready within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def exception(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError(f"traffic result not ready within {timeout}s")
        return self._error

    def stream(self, timeout: Optional[float] = None):
        """Generation path: block until dispatched, return the live
        ``GenerationStream`` (raises the shed/closed error instead if
        the request never reached the engine)."""
        if not self._stream_ev.wait(timeout):
            raise TimeoutError(f"not dispatched within {timeout}s")
        if self._stream is None:
            if self._error is not None:
                raise self._error
            raise ServingError("request finished without a stream")
        return self._stream

    def cancel(self) -> bool:
        """Cancel wherever the request currently is: still queued in
        the traffic layer (dropped, never dispatched), or already in
        the engine (delegated to the inner future/stream)."""
        return self._controller._cancel(self)


class _TReq:
    __slots__ = ("kind", "feed", "gen_args", "cls", "tenant", "deadline",
                 "enqueue_t", "ticket", "cancelled", "dispatched",
                 "inner", "ctx")

    def __init__(self, kind, feed, gen_args, cls, tenant, deadline,
                 enqueue_t, ticket):
        self.kind = kind            # "predict" | "generate"
        self.feed = feed
        self.gen_args = gen_args
        self.cls = cls
        self.tenant = tenant
        self.deadline = deadline    # absolute clock() or None
        self.enqueue_t = enqueue_t
        self.ticket = ticket
        self.cancelled = False
        self.dispatched = False
        self.inner = None           # ServingFuture / GenerationStream
        # the submitter's trace context: the dispatcher thread submits to
        # the engine under it, so the engine's spans stay in the
        # request's trace (the JAX controller drops it here)
        self.ctx = tracing.current()


class ServiceTimeEstimator:
    """Service-time estimates from live telemetry. ``service_ms``
    answers "if this request were dispatched now, how long until its
    result" — queue wait NOT included (the controller adds that from
    its own drain rate)."""

    def __init__(self, engine=None, generation_engine=None):
        self._engine = engine
        self._gen = generation_engine

    def predict_service_ms(self) -> Optional[float]:
        """paddle_step_* MEDIAN (the jitted step, the dominant term)
        plus the batch-close timeout (worst-case coalescing wait).
        Median, not p99: a shed claims the deadline is PROVABLY
        unmeetable, so the estimate must be the optimistic one — the
        global step p99 carries every worst outlier in the process and
        would shed requests that usually finish fine (headroom covers
        the rest). None until a step has been measured — never shed on
        zero data."""
        from ..observability import step_telemetry

        tel = step_telemetry().collect()
        step_p50 = float(tel.get("paddle_step_wall_ms_p50", 0.0) or 0.0)
        batch_ms = (self._engine.batch_timeout_s * 1e3
                    if self._engine is not None else 0.0)
        if step_p50 > 0.0:
            return step_p50 + batch_ms
        if self._engine is not None:
            lat = self._engine.metrics.snapshot()["latency_ms"]
            if lat["count"]:
                return float(lat["p50"])
        return None

    def generate_service_ms(self, max_new: Optional[int],
                            prompt_tokens: Optional[int] = None,
                            prompt=None) -> Optional[float]:
        """TTFT estimate + max_new x inter-token p50; None until the
        engine has served (medians for the same shed-must-be-provable
        reason).

        TTFT accounts for CHUNKED prefill: on the ragged engine a
        prompt of P tokens takes ceil(P / chunk_tokens) steps to reach
        its first token, so the estimate is chunks x step median — a
        fat prompt is priced as the several bounded slices it actually
        costs, not as one monolithic prefill at the global TTFT
        median (which a mixed workload would badly under/over-state
        for the tails of the prompt-length distribution).

        With the radix prefix cache warm, a matched prefix costs no
        prefill steps at all, so when the actual ``prompt`` tokens are
        available the engine's trie is probed (a pure peek) and only
        the UNMATCHED suffix is priced — otherwise a boilerplate-heavy
        prompt would be shed as unmeetable when it is really ~one
        chunk of work."""
        if self._gen is None:
            return None
        snap = self._gen.metrics.snapshot()
        if not snap["ttft_ms"]["count"]:
            return None
        itl = float(snap["itl_ms"]["p50"] or 0.0)
        n = int(max_new if max_new is not None
                else getattr(self._gen, "default_max_new", 16))
        ttft = float(snap["ttft_ms"]["p50"] or 0.0)
        # chunk pricing only for the ragged engine: a two_lane engine
        # prefills in ONE monolithic executable, and pricing it as
        # chunks x step-median would shed requests it can serve
        chunk = (int(getattr(self._gen, "chunk_tokens", 0) or 0)
                 if getattr(self._gen, "mode", "") == "ragged" else 0)
        step_p50 = float(snap["decode_step_ms"]["p50"] or 0.0)
        if (prompt is not None and prompt_tokens
                and getattr(self._gen, "prefix_cache", False)):
            try:
                matched = int(self._gen.prefix_probe(prompt))
            except Exception:  # noqa: BLE001 — pricing must never raise
                matched = 0
            # at least one token always prefills (it samples the
            # first output token)
            prompt_tokens = max(1, int(prompt_tokens) - matched)
        if prompt_tokens and chunk and step_p50 > 0:
            chunks = -(-int(prompt_tokens) // chunk)
            # queue-to-lane wait is already in the measured TTFT; keep
            # its single-chunk share and add the extra chunk steps
            ttft = max(ttft, chunks * step_p50)
        # disaggregated backend (disagg.DisaggService): the
        # prefill->decode handoff (spill + store put + decode admit)
        # is real wall time on every request's critical path — price
        # it, or deadlines near the TTFT median shed wrongly. The
        # store-hit discount itself already landed above: prefix_probe
        # on a disagg service consults the page store too.
        hand = getattr(self._gen, "handoff_overhead_ms", None)
        if hand is not None:
            try:
                ttft += float(hand() or 0.0)
            except Exception:  # noqa: BLE001 — pricing must never raise
                pass
        return ttft + itl * max(0, n - 1)

    def service_ms(self, req: _TReq) -> Optional[float]:
        if req.kind == "generate":
            prompt_tokens = None
            try:
                prompt_tokens = len(req.feed)
            except TypeError:
                pass
            return self.generate_service_ms(
                req.gen_args.get("max_new_tokens"),
                prompt_tokens=prompt_tokens, prompt=req.feed)
        return self.predict_service_ms()


class TrafficController:
    """SLO-aware admission + scheduling in front of the engines.

        eng = ServingEngine(predictor)
        ctl = traffic.TrafficController(eng, generation_engine=gen)
        t = ctl.submit({"x": arr}, tenant="alice",
                       priority="interactive", deadline_ms=50)
        outs = t.result(timeout=1.0)           # or TrafficShed w/ retry
        ctl.stats() / ctl.queue_depths() / ctl.close(drain=True)

    ``serving.ServingServer(engine, traffic=ctl)`` routes the HTTP
    front end through it (tenant/priority from headers, Retry-After on
    sheds, per-class depths on /healthz).
    """

    def __init__(self, engine, generation_engine=None,
                 config: Optional[TrafficConfig] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 start: bool = True):
        self.engine = engine
        self.generation_engine = generation_engine
        self.config = config or TrafficConfig.from_flags()
        self._clock = clock
        self.metrics = TrafficMetrics(clock=clock)
        self.metrics._window_s = self.config.slo_window_s
        self.estimator = ServiceTimeEstimator(engine, generation_engine)
        self._cond = threading.Condition()
        self._queues = ClassQueues(self.config.queue_capacity)
        self._buckets: Dict[str, TokenBucket] = {}
        self._adapter_buckets: Dict[tuple, TokenBucket] = {}
        self._inflight = 0          # predict requests inside the engine
        self._gen_inflight = 0      # generation requests inside the engine
        max_inflight = self.config.max_inflight
        if max_inflight <= 0:
            # default: enough to keep every worker's batch assembly fed
            # (2 full batches per worker) while ordering decisions stay
            # HERE — a deeper engine queue would re-create the FIFO
            # this layer exists to replace
            mb = int(getattr(engine, "max_batch_size", 8) or 8)
            nw = int(getattr(engine, "num_workers", 1) or 1)
            max_inflight = max(1, 2 * mb * nw)
        self.max_inflight = int(max_inflight)
        self._closed = False
        self._stop = False
        self._breach_start: Optional[float] = None
        self._breach_dumped = False
        self.slo_dump_paths: List[str] = []
        # unified telemetry: paddle_traffic_*{ctrl=} series
        from ..observability import watch_traffic

        watch_traffic(self)
        self._thread: Optional[threading.Thread] = None
        self._started = False
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "TrafficController":
        with self._cond:
            if self._started:
                return self
            self._started = True
        self._thread = threading.Thread(
            target=self._loop, name="pt-traffic-dispatch", daemon=True)
        self._thread.start()
        return self

    def close(self, drain: bool = True, timeout: Optional[float] = 30.0):
        """Stop admission; drain (default) lets queued + in-flight
        work finish, otherwise queued requests shed with "closed"."""
        deadline = time.monotonic() + (timeout or 0)
        with self._cond:
            self._closed = True
            if not drain:
                for req in self._queues.drain():
                    self._shed_locked(req, "closed",
                                      "traffic controller closed")
            self._cond.notify_all()
        if drain and self._started:
            while time.monotonic() < deadline:
                with self._cond:
                    if (not self._queues.depth() and not self._inflight
                            and not self._gen_inflight):
                        break
                time.sleep(0.01)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self) -> "TrafficController":
        return self

    def __exit__(self, *exc):
        self.close(drain=exc[0] is None)

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def draining(self) -> bool:
        return self._closed

    # -- admission -----------------------------------------------------------
    def _bucket_for(self, tenant: str) -> TokenBucket:
        # under _cond: concurrent first requests of a new tenant must
        # not mint two buckets (doubled burst), and stats() iterates
        with self._cond:
            b = self._buckets.get(tenant)
            if b is None:
                b = self.config.spec_for(tenant).make_bucket(
                    clock=self._clock)
                self._buckets[tenant] = b
            return b

    def _retry_after(self, cls: str) -> float:
        """Queue-drain-rate Retry-After: how long until the backlog
        ahead of a NEW request drains. No measured rate yet -> 1s."""
        drain = self.metrics.drain_rate()
        with self._cond:
            ahead = self._queues.depth() + self._inflight
        if drain <= 0:
            return 1.0
        return _clamp_retry((ahead + 1) / drain)

    def _adapter_bucket_for(self, tenant: str,
                            adapter: str) -> Optional[TokenBucket]:
        """The (tenant, adapter) admission bucket, or None when no
        per-adapter quota is configured for the pair (exact tenant
        entry wins over the ``*`` wildcard). Under _cond for the same
        reason as _bucket_for."""
        spec = self.config.adapter_spec_for(tenant, adapter)
        if spec is None:
            return None
        key = (tenant, adapter)
        with self._cond:
            b = self._adapter_buckets.get(key)
            if b is None:
                b = spec.make_bucket(clock=self._clock)
                self._adapter_buckets[key] = b
            return b

    def _admit(self, kind: str, feed, gen_args, tenant, priority,
               deadline_ms, adapter=None) -> TrafficTicket:
        tenant = str(tenant) if tenant else "default"
        spec = self.config.spec_for(tenant)
        cls = normalize_class(priority or spec.default_class)
        now = self._clock()
        ticket = TrafficTicket(self, cls, tenant)
        deadline = (now + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        req = _TReq(kind, feed, gen_args, cls, tenant, deadline, now, ticket)
        ticket._req = req
        # 1. feasibility at ADMISSION: queue wait (measured drain rate)
        # + service estimate vs the deadline. Conservative: only sheds
        # when both terms are measured. Side-effect free, so it runs
        # BEFORE the quota debit.
        infeasible, ra, detail = self._infeasible(req, now,
                                                  at_dispatch=False)
        if infeasible:
            self.metrics.shed(cls, tenant, "infeasible", ra)
            raise TrafficShed(
                f"deadline {deadline_ms:g}ms provably unmeetable: "
                f"{detail}", "infeasible", ra)
        if kind == "generate" and adapter is not None:
            # residency check BEFORE any quota debit: a request for an
            # adapter this worker doesn't hold should route elsewhere
            # (or trigger an upload), not burn tokens and batch slots
            # only to 500 mid-dispatch
            store = getattr(self.generation_engine, "adapter_store", None)
            if store is None or not store.is_resident(adapter):
                ra = 1.0
                self.metrics.shed(cls, tenant, "adapter", ra)
                raise TrafficShed(
                    f"adapter {adapter!r} is not resident on this worker",
                    "adapter", ra)
        bucket = self._bucket_for(tenant)
        abucket = (self._adapter_bucket_for(tenant, adapter)
                   if adapter is not None else None)
        # 2+3. queue room, THEN quota, THEN push — one atomic block.
        # Quota is checked last so a request shed for capacity reasons
        # never burns a token (otherwise a tenant under overload is
        # double-penalized: capacity-shed AND quota-drained, pushing
        # its admitted rate below its configured share).
        with self._cond:
            if self._closed:
                ra = self._retry_after(cls)
                self.metrics.shed(cls, tenant, "closed", ra)
                raise TrafficShed("traffic controller is draining",
                                  "closed", ra)
            if self._queues.depth(cls) >= self._queues.capacity:
                ra = self._retry_after(cls)
                self.metrics.shed(cls, tenant, "queue_full", ra)
                raise TrafficShed(
                    f"{cls} queue full "
                    f"({self.config.queue_capacity} pending)",
                    "queue_full", ra)
            if abucket is not None and abucket.available() < 1.0:
                # peek-then-take (serialized under _cond): shedding on
                # the adapter bucket must not have already burned a
                # tenant token, and vice versa
                ra = _clamp_retry(abucket.time_until())
                self.metrics.shed(cls, tenant, "quota", ra)
                raise TrafficShed(
                    f"tenant {tenant!r} over adapter quota for "
                    f"{adapter!r} ({abucket.rate:g} req/s, burst "
                    f"{abucket.burst:g})", "quota", ra)
            if not bucket.try_take():
                ra = _clamp_retry(bucket.time_until())
                self.metrics.shed(cls, tenant, "quota", ra)
                raise TrafficShed(
                    f"tenant {tenant!r} over quota "
                    f"({bucket.rate:g} req/s, burst {bucket.burst:g})",
                    "quota", ra)
            if abucket is not None:
                abucket.try_take()
            self._queues.push(cls, tenant, req)
            self.metrics.admitted(cls, tenant)
            self._update_gauges_locked()
            self._cond.notify_all()
        return ticket

    def submit(self, feed, *, tenant: Optional[str] = None,
               priority: Optional[str] = None,
               deadline_ms: Optional[float] = None) -> TrafficTicket:
        """Admit one predict request. Sheds raise ``TrafficShed``
        (with ``retry_after_s``) BEFORE any engine work."""
        return self._admit("predict", feed, None, tenant, priority,
                           deadline_ms)

    def predict(self, feed, *, tenant: Optional[str] = None,
                priority: Optional[str] = None,
                deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None):
        """Synchronous submit + result."""
        return self.submit(feed, tenant=tenant, priority=priority,
                           deadline_ms=deadline_ms).result(timeout)

    def submit_generation(self, prompt, *, tenant: Optional[str] = None,
                          priority: Optional[str] = None,
                          deadline_ms: Optional[float] = None,
                          max_new_tokens: Optional[int] = None,
                          eos_id="default", adapter: Optional[str] = None,
                          on_token=None) -> TrafficTicket:
        """Admit one generation request (requires a
        ``generation_engine``). The ticket's ``stream()`` hands back
        the live ``GenerationStream`` once the dispatcher admits the
        prompt into the continuous batch. ``adapter`` routes the row
        through a resident LoRA adapter: a non-resident id sheds with
        kind "adapter" at admission, and any configured
        (tenant, adapter) quota bucket is enforced alongside the
        tenant bucket."""
        if self.generation_engine is None:
            raise ServingError(
                "no GenerationEngine attached — construct "
                "TrafficController(engine, generation_engine=...)")
        gen_args = {"max_new_tokens": max_new_tokens, "eos_id": eos_id,
                    "on_token": on_token, "adapter": adapter}
        return self._admit("generate", prompt, gen_args, tenant, priority,
                           deadline_ms, adapter=adapter)

    # -- scheduling ----------------------------------------------------------
    def _infeasible(self, req: _TReq, now: float, at_dispatch: bool):
        """(must_shed, retry_after_s, detail). A request whose
        deadline cannot be met by the estimate sheds NOW — at dispatch
        time this is the guarantee that a doomed request never costs a
        batch slot. ``detail`` carries the estimate arithmetic into
        the shed message (an operator debugging sheds needs the
        numbers, not the verdict)."""
        if req.deadline is None:
            return False, 0.0, ""
        remaining_ms = (req.deadline - now) * 1e3
        if remaining_ms <= 0:
            return True, self._retry_after(req.cls), "deadline already past"
        svc = self.estimator.service_ms(req)
        if svc is None:
            return False, 0.0, ""
        need_ms = svc * self.config.shed_headroom
        wait_ms = 0.0
        if not at_dispatch:
            drain = self.metrics.drain_rate()
            if drain > 0:
                # the wait estimate is CLASS-AWARE: strict-priority
                # dispatch means an interactive request only waits
                # behind same-or-higher classes (+ what is already in
                # the engine) — counting the whole backlog would shed
                # exactly the traffic the priority ladder protects
                idx = class_index(req.cls)
                with self._cond:
                    depths = self._queues.depths()
                    ahead = self._inflight + sum(
                        d for c, d in depths.items()
                        if class_index(c) <= idx)
                wait_ms = (ahead / drain) * 1e3
                need_ms += wait_ms
        if remaining_ms < need_ms:
            detail = (f"remaining {remaining_ms:.1f}ms < est wait "
                      f"{wait_ms:.1f}ms + service {svc:.1f}ms x "
                      f"{self.config.shed_headroom:g} headroom")
            return True, self._retry_after(req.cls), detail
        return False, 0.0, ""

    def _effective_class(self, req: _TReq, now: float) -> int:
        idx = class_index(req.cls)
        if self.config.aging_ms > 0:
            boost = int((now - req.enqueue_t) * 1e3 / self.config.aging_ms)
            return max(0, idx - boost)
        return idx

    def _pick_locked(self, now: float) -> Optional[_TReq]:
        """Strict priority with aging over the queue heads; skips
        kinds whose backend has no room (predict past max_inflight,
        generation when the engine's own queue is full)."""
        gen = self.generation_engine
        gen_room = True
        if gen is not None:
            try:
                gen_room = gen.queue_depth() < gen.queue_capacity
            except Exception:  # noqa: BLE001
                gen_room = True
        best_key = None
        best = None
        for cls, tenant, req in self._queues.heads():
            if req.kind == "predict" and self._inflight >= self.max_inflight:
                continue
            if req.kind == "generate" and not gen_room:
                continue
            eff = self._effective_class(req, now)
            # tie-break equal EFFECTIVE classes by ORIGINAL class
            # before age: under sustained overload everything old
            # enough ages to effective 0, and an age tie-break would
            # quietly turn the scheduler back into the FIFO this
            # subsystem replaces — aged batch work runs when the
            # interactive queue is empty (which open-loop interactive
            # traffic guarantees between arrivals), not instead of it
            key = (eff, class_index(req.cls), req.enqueue_t)
            if best_key is None or key < best_key:
                best_key, best = key, (cls, tenant, req, eff)
        if best is None:
            return None
        cls, tenant, req, eff = best
        self._queues.pop(cls, tenant)
        if eff < class_index(cls):
            self.metrics.aged()
        return req

    def pump(self, budget: int = 1) -> int:
        """Synchronous dispatcher turns (tests / start=False): up to
        ``budget`` pick->dispatch rounds; returns how many requests
        moved (dispatched or shed)."""
        moved = 0
        for _ in range(budget):
            with self._cond:
                req = self._pick_locked(self._clock())
                if req is None:
                    break
                if req.kind == "predict":
                    self._inflight += 1
                else:
                    self._gen_inflight += 1
                self._update_gauges_locked()
            self._dispatch(req)
            moved += 1
        return moved

    def _loop(self):
        while True:
            with self._cond:
                while not self._stop:
                    req = self._pick_locked(self._clock())
                    if req is not None:
                        break
                    # bounded wait: aging promotions and deadline
                    # expiry are time-driven, not event-driven
                    self._cond.wait(0.02)
                if self._stop:
                    for r in self._queues.drain():
                        self._shed_locked(r, "closed",
                                          "traffic controller closed")
                    self._update_gauges_locked()
                    return
                if req.kind == "predict":
                    self._inflight += 1
                else:
                    self._gen_inflight += 1
                self._update_gauges_locked()
            self._dispatch(req)

    def _dispatch(self, req: _TReq):
        now = self._clock()
        if req.cancelled or req.ticket.done():
            self._finish(req, None, RequestCancelled(
                "cancelled before dispatch"), record=False)
            return
        self.metrics.observe_queue_wait(
            req.cls, (now - req.enqueue_t) * 1e3)
        # the shed-before-batch guarantee: the LAST check before the
        # engine sees the request
        infeasible, ra, detail = self._infeasible(req, now,
                                                  at_dispatch=True)
        if infeasible:
            self.metrics.shed(req.cls, req.tenant, "infeasible", ra)
            self._finish(req, None, TrafficShed(
                "deadline unmeetable at dispatch after "
                f"{(now - req.enqueue_t) * 1e3:.1f}ms in queue: {detail}",
                "infeasible", ra), record=False)
            return
        remaining_ms = ((req.deadline - now) * 1e3
                        if req.deadline is not None else None)
        try:
            with tracing.attach(req.ctx):
                self._submit_to_engine(req, remaining_ms)
        except Overloaded as e:
            ra = self._retry_after(req.cls)
            self.metrics.shed(req.cls, req.tenant, "backend", ra)
            self._finish(req, None, TrafficShed(
                f"backend rejected: {e}", "backend", ra), record=False)
        except Exception as e:  # noqa: BLE001 — a bad request must not kill dispatch
            self._finish(req, None, ServingError(
                f"dispatch failed: {e!r}"))

    def _submit_to_engine(self, req: _TReq, remaining_ms) -> None:
        """Hand one request to its engine (on the dispatcher thread,
        under the submitter's trace context)."""
        if req.kind == "predict":
            inner = self.engine.submit(req.feed,
                                       deadline_ms=remaining_ms)
            req.inner = inner
            req.dispatched = True
            inner.add_done_callback(
                lambda fut, r=req: self._on_engine_done(r, fut))
        else:
            ga = req.gen_args
            kw = {"max_new_tokens": ga["max_new_tokens"],
                  "eos_id": ga["eos_id"], "deadline_ms": remaining_ms,
                  "on_token": ga["on_token"]}
            # the tenant identity rides into the engine so trie
            # publishes attribute to the right per-tenant quota;
            # engine-likes without the kwarg (older mocks) still
            # dispatch
            if self._gen_takes_tenant():
                kw["tenant"] = req.tenant
            if ga.get("adapter") is not None and self._gen_takes_adapter():
                kw["adapter"] = ga["adapter"]
            stream = self.generation_engine.submit(req.feed, **kw)
            req.inner = stream
            req.dispatched = True
            req.ticket._set_stream(stream)
            stream.add_done_callback(
                lambda s, r=req: self._on_stream_done(r, s))

    # -- completion ----------------------------------------------------------
    def _on_engine_done(self, req: _TReq, fut):
        try:
            result = fut.result(timeout=0)
            err = None
        except BaseException as e:  # noqa: BLE001
            result, err = None, e
        self._finish(req, result, err)

    def _on_stream_done(self, req: _TReq, stream):
        err = stream.error
        self._finish(req, list(stream.tokens), err)

    def _finish(self, req: _TReq, result, err, record: bool = True):
        now = self._clock()
        if record and req.dispatched:
            met: Optional[bool]
            if isinstance(err, RequestCancelled):
                met = None
            elif err is not None:
                met = False if req.deadline is not None else None
            elif req.deadline is not None:
                met = now <= req.deadline
            else:
                met = None
            self.metrics.completed(req.cls, req.tenant,
                                   (now - req.enqueue_t) * 1e3, met)
            self._check_slo(now)
        req.ticket._complete(result=result, error=err)
        with self._cond:
            # every _finish follows a pump/_loop increment (dispatch
            # shed, backend reject, or completion callback), so the
            # slot releases unconditionally by kind
            if req.kind == "predict":
                self._inflight = max(0, self._inflight - 1)
            else:
                self._gen_inflight = max(0, self._gen_inflight - 1)
            self._update_gauges_locked()
            self._cond.notify_all()

    def _shed_locked(self, req: _TReq, kind: str, msg: str):
        ra = 1.0
        self.metrics.shed(req.cls, req.tenant, kind, ra)
        req.ticket._complete(error=TrafficShed(msg, kind, ra))

    def _cancel(self, ticket: TrafficTicket) -> bool:
        req = ticket._req
        if req is None:
            return ticket._complete(error=RequestCancelled("cancelled"))
        with self._cond:
            if not req.dispatched and self._queues.remove(req):
                req.cancelled = True
                self._update_gauges_locked()
                ticket._complete(error=RequestCancelled(
                    "cancelled while queued in the traffic layer"))
                return True
        req.cancelled = True
        if req.inner is not None:
            return bool(req.inner.cancel())
        return False

    # -- SLO breach -> flight dump -------------------------------------------
    def _check_slo(self, now: float):
        ratio, n = self.metrics.miss_ratio()
        breaching = (n >= 10
                     and ratio >= self.config.slo_miss_threshold)
        if not breaching:
            self._breach_start = None
            self._breach_dumped = False
            return
        if self._breach_start is None:
            self._breach_start = now
            return
        if (not self._breach_dumped
                and now - self._breach_start >= self.config.slo_window_s):
            self._breach_dumped = True
            from ..observability import flight

            path = flight.dump("slo_breach", extra={
                "deadline_miss_ratio": round(ratio, 4),
                "window_samples": n,
                "threshold": self.config.slo_miss_threshold,
                "window_s": self.config.slo_window_s,
                "traffic": self.metrics.snapshot(),
            })
            if path:
                self.slo_dump_paths.append(path)
            self.metrics.slo_dumped()

    # -- introspection -------------------------------------------------------
    def _update_gauges_locked(self):
        self.metrics.set_queue_depths(
            self._queues.depths(), self._inflight + self._gen_inflight)

    def queue_depths(self) -> Dict[str, int]:
        with self._cond:
            return self._queues.depths()

    def retry_after_s(self, cls: str = "batch") -> float:
        return self._retry_after(cls)

    def stats(self) -> Dict[str, Any]:
        """Traffic metrics + scheduler state + SLO dump paths in one
        JSON-serializable dict."""
        out = self.metrics.snapshot()
        out["draining"] = self.draining
        out["max_inflight"] = self.max_inflight
        out["slo_dump_paths"] = list(self.slo_dump_paths)
        with self._cond:
            buckets = list(self._buckets.items())
            abuckets = list(self._adapter_buckets.items())
        out["tenants"] = {
            name: {"rate": b.rate, "burst": b.burst,
                   "tokens": (round(b.available(), 2)
                              if b.rate > 0 else -1.0)}
            for name, b in buckets}
        out["adapter_quotas"] = {
            f"{tenant}:{adapter}": {
                "rate": b.rate, "burst": b.burst,
                "tokens": (round(b.available(), 2)
                           if b.rate > 0 else -1.0)}
            for (tenant, adapter), b in abuckets}
        return out

    def _gen_takes_tenant(self) -> bool:
        """Whether generation_engine.submit accepts tenant= (cached
        one-time signature probe — per-dispatch inspect would be pure
        overhead)."""
        cached = getattr(self, "_gen_tenant_kw", None)
        if cached is None:
            import inspect

            try:
                cached = "tenant" in inspect.signature(
                    self.generation_engine.submit).parameters
            except (TypeError, ValueError):
                cached = False
            self._gen_tenant_kw = cached
        return cached

    def _gen_takes_adapter(self) -> bool:
        """Whether generation_engine.submit accepts adapter= (same
        cached-probe shape as _gen_takes_tenant)."""
        cached = getattr(self, "_gen_adapter_kw", None)
        if cached is None:
            import inspect

            try:
                cached = "adapter" in inspect.signature(
                    self.generation_engine.submit).parameters
            except (TypeError, ValueError):
                cached = False
            self._gen_adapter_kw = cached
        return cached

    def health(self) -> Dict[str, Any]:
        """The /healthz fragment: per-class depths + drain state —
        everything a router/autoscaler needs from one endpoint. A
        disaggregated backend adds the per-worker phase fragment
        (which workers prefill, which decode, their load)."""
        ratio, _ = self.metrics.miss_ratio()
        out = {
            "draining": self.draining,
            "queue_depth": self.queue_depths(),
            "inflight": self._inflight + self._gen_inflight,
            "max_inflight": self.max_inflight,
            "drain_rate_rps": self.metrics.drain_rate(),
            "deadline_miss_ratio": round(ratio, 4),
            "classes": list(CLASSES),
        }
        gen = self.generation_engine
        if gen is not None:
            ph = getattr(gen, "phase_health", None)
            if ph is not None:
                try:
                    out["phases"] = ph()
                except Exception:  # noqa: BLE001 — health must never raise
                    pass
            elif getattr(gen, "phase", None):
                out["phase"] = gen.phase
        return out
