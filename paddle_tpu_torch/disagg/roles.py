"""Disaggregated serving roles: the prefill tier, the decode pool,
and the service facade that hands requests between them (the
counterpart of ``paddle_tpu/disagg/roles.py``).

Prefill is compute-bound (a prompt's worth of matmul per request);
decode is bandwidth-bound (one token's worth per step, every step).
Co-locating them on one engine makes every decode step pay for
whatever prefill happens to share the batch — chunked prefill
bounds the stall but cannot remove it. Splitting the phases does:

* ``PrefillWorker`` — a GenerationEngine pinned to chunked prefill
  (every request runs at ``max_new_tokens=1``); the finished prompt
  pages publish into its local trie as chunks complete, then
  ``spill_run`` streams them to the page store (blockwise-int8 on the
  wire — pagestore.py).
* ``DecodeWorker`` — a GenerationEngine whose admission consults the
  store BEFORE cold prefill (engine ``_consult_store``): matched runs
  splice into the local pool (``PagedKVCache.ingest_run``) and the
  sequence resumes at ``lengths=matched``. A freshly spawned or
  restarted decode worker on a populated store starts WARM — ROADMAP
  2(a) cross-engine prefix persistence.
* ``DisaggService`` — the engine-shaped facade the traffic tier
  drives unchanged: ``submit`` admits once, a dispatcher thread runs
  the prompt on the least-loaded prefill worker, spills, then hands
  the ticket to the decode worker chosen by the
  ``paddle_generation_*`` gauges (queue depth + active lanes). The
  decode worker re-derives the first output token from the spliced
  prefix (greedy — token-identical to co-located serving), so the
  handoff loses zero tokens by construction.

Token identity: with int8 KV pools the pages ship verbatim and the
split topology is BIT-identical to the co-located int8 engine; with
fp32 pools use ``disagg_wire_encoding="raw"`` for bitwise fidelity or
accept the blockwise-int8 error bound (kernels/quant.py) on the
streamed prefix.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..generation.engine import GenerationEngine, GenerationStream
from ..observability import tracing
from ..serving.engine import (EngineClosed, Overloaded, RequestCancelled,
                              ServingError)
from ..serving.metrics import StreamingHistogram

__all__ = ["PrefillWorker", "DecodeWorker", "DisaggService",
           "DisaggStream"]


class PrefillWorker:
    """A GenerationEngine pinned to the prefill phase: requests run
    chunked prefill to completion (one emitted token — the step that
    samples it IS the final prefill chunk) and their pages stream to
    the page store instead of staying for decode."""

    def __init__(self, predictor, config, store, **engine_kwargs):
        engine_kwargs.setdefault("mode", "ragged")
        engine_kwargs.setdefault("prefix_cache", True)
        self.store = store
        self.engine = GenerationEngine(predictor, config,
                                       page_store=store, phase="prefill",
                                       **engine_kwargs)

    def prefill(self, prompt, deadline_ms: Optional[float] = None,
                tenant: Optional[str] = None,
                timeout: Optional[float] = None) -> int:
        """Run ``prompt`` through chunked prefill and spill its full
        pages to the store. Returns pages spilled. Raises what the
        engine raises (Overloaded / EngineClosed / deadline)."""
        stream = self.engine.submit(prompt, max_new_tokens=1,
                                    eos_id=None, deadline_ms=deadline_ms,
                                    tenant=tenant)
        stream.result(timeout)
        return self.engine.spill_run(prompt)

    def queue_depth(self) -> int:
        return self.engine.queue_depth()

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()

    def close(self, drain: bool = True) -> None:
        self.engine.close(drain=drain)


class DecodeWorker:
    """A GenerationEngine pinned to the decode phase, warm-started
    from the page store: queued prompts consult the store before cold
    prefill, splice any matched run, and resume at the fork point."""

    def __init__(self, predictor, config, store, **engine_kwargs):
        engine_kwargs.setdefault("mode", "ragged")
        engine_kwargs.setdefault("prefix_cache", True)
        self.store = store
        self.engine = GenerationEngine(predictor, config,
                                       page_store=store, phase="decode",
                                       **engine_kwargs)

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_id="default", deadline_ms: Optional[float] = None,
               on_token=None, tenant: Optional[str] = None
               ) -> GenerationStream:
        return self.engine.submit(prompt, max_new_tokens=max_new_tokens,
                                  eos_id=eos_id, deadline_ms=deadline_ms,
                                  on_token=on_token, tenant=tenant)

    def queue_depth(self) -> int:
        return self.engine.queue_depth()

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()

    def close(self, drain: bool = True) -> None:
        self.engine.close(drain=drain)


class DisaggStream(GenerationStream):
    """The caller-facing stream for a disaggregated request: tokens
    relay from the decode worker's inner stream; cancel propagates to
    whichever phase currently owns the request (mid-handoff included
    — the dispatcher checks between prefill and decode submit)."""

    def __init__(self, service, on_token=None):
        super().__init__(service, on_token=on_token)
        self._inner: Optional[GenerationStream] = None

    def cancel(self) -> bool:
        ok = super().cancel()
        inner = self._inner
        if inner is not None:
            inner.cancel()
        return ok


class _HandoffJob:
    __slots__ = ("prompt", "max_new", "eos", "deadline", "stream",
                 "tenant", "enqueue_t", "ctx")

    def __init__(self, prompt, max_new, eos, deadline, stream, tenant):
        self.prompt = prompt
        self.max_new = max_new
        self.eos = eos
        self.deadline = deadline        # absolute monotonic or None
        self.stream = stream
        self.tenant = tenant
        self.enqueue_t = time.monotonic()
        # the submitter's ambient trace context rides the job across
        # the queue: the dispatcher thread re-attaches it, so the
        # handoff/prefill/decode spans stay in the REQUEST's trace
        # instead of rooting a fresh one per dispatcher thread
        self.ctx = tracing.current()


class _ServiceMetrics:
    """The engine-metrics duck the traffic estimator prices from:
    service-level TTFT (submit -> first decode token, handoff
    included), decode-pool ITL/step medians, request counters."""

    def __init__(self, service: "DisaggService"):
        self._svc = service
        self._lock = threading.Lock()
        self.ttft_ms = StreamingHistogram()
        self.handoff_ms = StreamingHistogram()
        self.prefill_ms = StreamingHistogram()
        self._c = {"requests_total": 0, "responses_total": 0,
                   "rejected_total": 0, "handoffs_total": 0,
                   "handoff_failures_total": 0, "cancelled_total": 0}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] += n

    def observe(self, hist: str, v: float) -> None:
        with self._lock:
            getattr(self, hist).record(v)

    def snapshot(self) -> Dict[str, Any]:
        decode = [w.engine.metrics.snapshot()
                  for w in self._svc._decode]
        busiest = max(decode, key=lambda s: s["itl_ms"]["count"])
        with self._lock:
            out: Dict[str, Any] = dict(self._c)
            out["ttft_ms"] = self.ttft_ms.snapshot()
            out["handoff_ms"] = self.handoff_ms.snapshot()
            out["prefill_ms"] = self.prefill_ms.snapshot()
        # decode-side medians come from the busiest decode worker (a
        # merged histogram would mix workers with different loads);
        # queue depth aggregates across the whole topology
        out["itl_ms"] = busiest["itl_ms"]
        out["decode_step_ms"] = busiest["decode_step_ms"]
        out["queue_depth"] = self._svc.queue_depth()
        out["active_seqs"] = sum(s["active_seqs"] for s in decode)
        return out


class DisaggService:
    """The split topology behind one engine-shaped surface.

        store = pagestore.PageStoreServer(page_size=16)
        svc = DisaggService(
            prefill=[PrefillWorker(pred, cfg, client_for(store))],
            decode=[DecodeWorker(pred, cfg, client_for(store))])
        stream = svc.submit(prompt, max_new_tokens=64)   # engine duck
        ctl = TrafficController(eng, generation_engine=svc)

    ``submit`` admits once (Overloaded before any work, same contract
    as the engine); dispatcher threads run prefill -> spill -> decode
    handoff; ``/healthz`` reads ``phase_health()`` through the
    traffic controller's fragment. Registers ``paddle_disagg_*``
    gauges (handoff latency, store traffic via the workers' engines).
    """

    def __init__(self, prefill: List[PrefillWorker],
                 decode: List[DecodeWorker], *,
                 handoff_threads: Optional[int] = None,
                 queue_capacity: Optional[int] = None):
        if not prefill or not decode:
            raise ValueError("DisaggService needs >= 1 prefill and >= 1 "
                             "decode worker")
        from ..flags import flag

        self._prefill = list(prefill)
        self._decode = list(decode)
        d0 = self._decode[0].engine
        # the engine-duck attributes the traffic tier reads
        self.mode = d0.mode
        self.chunk_tokens = d0.chunk_tokens
        self.prefix_cache = True
        self.default_max_new = d0.default_max_new
        self.default_eos = d0.default_eos
        self.lanes = sum(w.engine.lanes for w in self._decode)
        self.config = d0.config
        self.cache = d0.cache           # feasibility duck (can_fit_ever)
        self.queue_capacity = int(
            queue_capacity or self._prefill[0].engine.queue_capacity)
        self.phase = "disagg"
        self.metrics = _ServiceMetrics(self)
        self._cond = threading.Condition()
        self._jobs: List[_HandoffJob] = []
        self._closed = False
        self._handoff_hook = None       # test seam: between phases
        n = int(handoff_threads or flag("disagg_handoff_threads"))
        self._threads = [
            threading.Thread(target=self._dispatch_loop,
                             name=f"pt-disagg-handoff-{i}", daemon=True)
            for i in range(max(1, n))]
        for t in self._threads:
            t.start()
        from ..observability import watch_disagg

        watch_disagg(self)

    # -- the engine duck ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_id="default", deadline_ms: Optional[float] = None,
               on_token=None, tenant: Optional[str] = None
               ) -> DisaggStream:
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.default_max_new)
        eos = self.default_eos if eos_id == "default" else eos_id
        total = int(prompt.size) + max_new
        if total > self.config.max_position:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) "
                f"exceeds max_position {self.config.max_position}")
        if not self.cache.can_fit_ever(total):
            self.metrics.inc("rejected_total")
            raise Overloaded(
                f"request needs {self.cache.pages_needed(total)} pages; "
                "no decode pool can ever hold it")
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        stream = DisaggStream(self, on_token=on_token)
        job = _HandoffJob(prompt, max_new, eos, deadline, stream, tenant)
        with self._cond:
            if self._closed:
                raise EngineClosed("DisaggService is closed")
            if len(self._jobs) >= self.queue_capacity:
                self.metrics.inc("rejected_total")
                raise Overloaded(
                    f"disagg handoff queue full ({self.queue_capacity} "
                    "pending)")
            self._jobs.append(job)
            self.metrics.inc("requests_total")
            self._cond.notify()
        return stream

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos_id="default", deadline_ms: Optional[float] = None,
                 timeout: Optional[float] = None) -> List[int]:
        return self.submit(prompt, max_new_tokens, eos_id,
                           deadline_ms).result(timeout)

    def queue_depth(self) -> int:
        return (len(self._jobs)
                + sum(w.engine.queue_depth() for w in self._prefill))

    def prefix_probe(self, tokens) -> int:
        """Longest warm prefix across the decode pool AND the page
        store — the traffic tier's store-hit TTFT pricing."""
        best = max(w.engine.prefix_probe(tokens) for w in self._decode)
        store = self._decode[0].store
        try:
            ps = self._decode[0].engine.page_size
            best = max(best, store.match_pages(tokens) * ps)
        except Exception:  # noqa: BLE001 — a dead store prices as cold
            pass
        return best

    def handoff_overhead_ms(self) -> float:
        """Median prefill->decode handoff wall time — the estimator's
        extra TTFT term for the split topology."""
        h = self.metrics.handoff_ms
        return float(h.quantile(0.5)) if h.count else 0.0

    def _kick(self) -> None:
        with self._cond:
            self._cond.notify_all()

    # -- handoff dispatch -----------------------------------------------------
    def _pick_prefill(self) -> PrefillWorker:
        return min(self._prefill, key=lambda w: w.engine.queue_depth())

    def _pick_decode(self) -> DecodeWorker:
        """The decode worker the paddle_generation_* gauges call
        least loaded: queued + active sequences, per worker."""
        def load(w: DecodeWorker):
            snap = w.engine.metrics.snapshot()
            return snap["queue_depth"] + snap["active_seqs"]

        return min(self._decode, key=load)

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while not self._jobs and not self._closed:
                    self._cond.wait(0.05)
                if not self._jobs:
                    if self._closed:
                        return
                    continue
                job = self._jobs.pop(0)
            try:
                with tracing.attach(job.ctx), \
                     tracing.span("disagg/handoff", {
                         "queue_ms": round(
                             (time.monotonic() - job.enqueue_t) * 1e3, 3),
                         "prompt_tokens": int(job.prompt.size)}):
                    self._handoff(job)
            except Exception as e:  # noqa: BLE001 — one bad job must not kill the lane
                self.metrics.inc("handoff_failures_total")
                job.stream._finish("error", ServingError(
                    f"disagg handoff failed: {e!r}"))

    def _remaining_ms(self, job: _HandoffJob) -> Optional[float]:
        if job.deadline is None:
            return None
        return max(1.0, (job.deadline - time.monotonic()) * 1e3)

    def _handoff(self, job: _HandoffJob) -> None:
        stream = job.stream
        if stream._cancelled:
            self.metrics.inc("cancelled_total")
            stream._finish("cancelled", RequestCancelled(
                "cancelled before prefill"))
            return
        t0 = time.monotonic()
        pf = self._pick_prefill()
        try:
            with tracing.span("disagg/prefill_phase"):
                pf.prefill(job.prompt,
                           deadline_ms=self._remaining_ms(job),
                           tenant=job.tenant)
        except (Overloaded, EngineClosed) as e:
            self.metrics.inc("handoff_failures_total")
            stream._finish("error", e)
            return
        except Exception as e:  # noqa: BLE001 — deadline/cancel surface here
            self.metrics.inc("handoff_failures_total")
            stream._finish("error", ServingError(
                f"prefill phase failed: {e!r}"))
            return
        t_prefilled = time.monotonic()
        self.metrics.observe("prefill_ms", (t_prefilled - t0) * 1e3)
        if self._handoff_hook is not None:
            self._handoff_hook(job)
        if stream._cancelled:
            # slow-client cancel mid-handoff: the prompt's pages stay
            # in the store (refcounted, reusable by siblings); no
            # decode lane is ever spent
            self.metrics.inc("cancelled_total")
            stream._finish("cancelled", RequestCancelled(
                "cancelled between prefill and decode"))
            return
        dw = self._pick_decode()
        try:
            with tracing.span("disagg/decode_submit"):
                inner = dw.submit(job.prompt, max_new_tokens=job.max_new,
                                  eos_id=job.eos,
                                  deadline_ms=self._remaining_ms(job),
                                  on_token=stream._push, tenant=job.tenant)
        except (Overloaded, EngineClosed) as e:
            self.metrics.inc("handoff_failures_total")
            stream._finish("error", e)
            return
        stream._inner = inner
        if stream._cancelled:
            inner.cancel()
        self.metrics.inc("handoffs_total")
        self.metrics.observe(
            "handoff_ms", (time.monotonic() - t_prefilled) * 1e3)
        inner.add_done_callback(
            lambda s, outer=stream, t=job.enqueue_t: self._relay_done(
                outer, s, t))

    def _relay_done(self, outer: DisaggStream, inner: GenerationStream,
                    enqueue_t: float) -> None:
        outer.verified_tokens = inner.verified_tokens
        outer.accepted_draft_tokens = inner.accepted_draft_tokens
        if inner.first_token_at is not None:
            self.metrics.observe(
                "ttft_ms", (inner.first_token_at - enqueue_t) * 1e3)
        if inner.error is None and inner.finish_reason in (
                "eos", "length", "capacity"):
            self.metrics.inc("responses_total")
        outer._finish(inner.finish_reason or "error", inner.error)

    # -- introspection / lifecycle -------------------------------------------
    def phase_health(self) -> List[Dict[str, Any]]:
        """The /healthz per-worker phase fragment."""
        out = []
        for kind, workers in (("prefill", self._prefill),
                              ("decode", self._decode)):
            for i, w in enumerate(workers):
                snap = w.engine.metrics.snapshot()
                out.append({
                    "worker": f"{kind}-{i}",
                    "phase": w.engine.phase,
                    "queue_depth": snap["queue_depth"],
                    "active_seqs": snap["active_seqs"],
                })
        return out

    def stats(self) -> Dict[str, Any]:
        return {
            "service": self.metrics.snapshot(),
            "phases": self.phase_health(),
            "prefill": [w.stats() for w in self._prefill],
            "decode": [w.stats() for w in self._decode],
        }

    def stats_numeric(self) -> Dict[str, Any]:
        """The paddle_disagg_* gauge family for this service: handoff
        volume + latency, pages shipped/pulled and wire bytes summed
        over the workers' engines and the store."""
        snap = self.metrics.snapshot()
        out: Dict[str, Any] = {
            "requests_total": snap["requests_total"],
            "responses_total": snap["responses_total"],
            "rejected_total": snap["rejected_total"],
            "handoffs_total": snap["handoffs_total"],
            "handoff_failures_total": snap["handoff_failures_total"],
            "cancelled_total": snap["cancelled_total"],
            "handoff_ms": snap["handoff_ms"],
            "ttft_ms": snap["ttft_ms"],
            "queue_depth": snap["queue_depth"],
            "prefill_workers": len(self._prefill),
            "decode_workers": len(self._decode),
            "pages_shipped_total": sum(
                w.engine.store_pages_spilled_total for w in self._prefill),
            "pages_pulled_total": sum(
                w.engine.store_pages_pulled_total for w in self._decode),
            "store_lookups_total": sum(
                w.engine.store_lookups_total for w in self._decode),
            "store_hits_total": sum(
                w.engine.store_hits_total for w in self._decode),
        }
        lk = out["store_lookups_total"]
        out["store_hit_rate"] = (round(out["store_hits_total"] / lk, 4)
                                 if lk else 0.0)
        try:
            st = self._decode[0].store.stats()
            out["store_pages"] = st["pages"]
            out["wire_bytes_total"] = st.get("wire_bytes_total", 0)
            out["fp32_bytes_total"] = st.get("fp32_bytes_total", 0)
            out["wire_ratio"] = st.get("wire_ratio", 0.0)
        except Exception:  # noqa: BLE001 — gauges must never raise
            pass
        return out

    def close(self, drain: bool = True,
              timeout: Optional[float] = 60.0) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        deadline = (time.monotonic() + timeout) if timeout else None
        for t in self._threads:
            left = (max(0.1, deadline - time.monotonic())
                    if deadline else None)
            t.join(left)
        for w in self._prefill + self._decode:
            w.close(drain=drain)

    def __enter__(self) -> "DisaggService":
        return self

    def __exit__(self, *exc):
        self.close(drain=exc[0] is None)
