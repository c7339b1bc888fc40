"""Cross-process trace-context propagation (W3C-traceparent-style; the
counterpart of ``paddle_tpu/observability/propagate.py``).

tracing.py gives one process spans with trace/span/parent ids, ambient
within a thread and explicit across threads. What it cannot do is
follow a request across a PROCESS boundary: the HTTP hop into
serving/server.py, the disagg prefill->decode handoff, the page-store
TCP wire, and a WorkerPool child all started fresh traces, so a single
disaggregated request's story was shredded across four processes.

This module is the codec for every one of those boundaries:

* **headers** — ``inject``/``extract`` read and write a
  ``traceparent``-style header (plus the ``X-Trace`` alias) on any
  dict-like carrier: ``00-<trace_id>-<span_id>-01``. The field widths
  are tolerant (our ids are 22 hex chars, W3C's are 32/16 — both
  parse), which keeps the codec round-trip-exact for internal ids
  while still accepting a standards-shaped header from an external
  proxy.
* **wire heads** — the page-store client stamps
  ``current_traceparent()`` into each RPC frame's JSON head under the
  ``"trace"`` key; the server attaches it before dispatching, so the
  RPC's span joins the caller's trace across the TCP hop.
* **env** — ``to_env``/``from_env`` carry the context through
  ``PADDLE_TRACE_*`` environment variables into spawned children
  (traffic.WorkerPool stamps its workers at spawn and over the
  control pipe).

The per-process record of a trace is the flight recorder ring itself:
every completed span already lands there with its trace/span/parent
ids (tracing._Span.__exit__), bounded by
``observability_flight_capacity``. ``trace_spans``/``local_trace``
index that ring by trace id — this is what the
``/v1/admin/trace/<id>`` endpoint serves, with the process's pid
stamped on every span so a timeline renderer can draw process lanes for
the assembled cross-process trace.
"""

from __future__ import annotations

import os
import re
import socket
from typing import Any, Dict, List, Optional

from . import flight, tracing
from .tracing import SpanContext

__all__ = [
    "TRACEPARENT_HEADER", "TRACE_HEADER", "REQUEST_ID_HEADER",
    "ENV_TRACE_CONTEXT", "ENV_TRACE_ID",
    "format_traceparent", "parse_traceparent", "inject", "extract",
    "current_traceparent", "new_request_id", "to_env", "from_env",
    "trace_spans", "local_trace", "orphan_spans",
]

TRACEPARENT_HEADER = "traceparent"
TRACE_HEADER = "X-Trace"
REQUEST_ID_HEADER = "X-Request-Id"
ENV_TRACE_CONTEXT = "PADDLE_TRACE_CONTEXT"
ENV_TRACE_ID = "PADDLE_TRACE_ID"

_VERSION = "00"
_FLAGS_SAMPLED = "01"
# tolerant field widths: internal ids are 22 hex chars (tracing._new_id),
# W3C ids are 32/16 — accept 2..64 so both round-trip exactly
_TRACEPARENT = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{2,64})-([0-9a-f]{2,64})-([0-9a-f]{2})$")


def format_traceparent(ctx: SpanContext) -> str:
    """``SpanContext`` -> the on-the-wire header value."""
    return f"{_VERSION}-{ctx.trace_id}-{ctx.span_id}-{_FLAGS_SAMPLED}"


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """Header value -> ``SpanContext``; None for anything malformed
    (a bad header from a client must never 500 the request)."""
    if not value or not isinstance(value, str):
        return None
    m = _TRACEPARENT.match(value.strip().lower())
    if m is None:
        return None
    return SpanContext(m.group(2), m.group(3))


def inject(ctx: Optional[SpanContext],
           carrier: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Stamp ``ctx`` into a header-dict carrier (both the
    ``traceparent`` spelling and the ``X-Trace`` alias); returns the
    carrier. A None ctx injects nothing — callers can pass
    ``tracing.current()`` unconditionally."""
    if carrier is None:
        carrier = {}
    if ctx is not None:
        tp = format_traceparent(ctx)
        carrier[TRACEPARENT_HEADER] = tp
        carrier[TRACE_HEADER] = tp
    return carrier


def extract(carrier) -> Optional[SpanContext]:
    """Pull a trace context out of any ``.get``-able carrier (a plain
    dict, ``http.client.HTTPMessage`` headers, a wire-frame head).
    ``traceparent`` wins over ``X-Trace``; a bare trace id in
    ``X-Trace`` (no span field) is accepted as a parentless trace."""
    if carrier is None:
        return None
    for key in (TRACEPARENT_HEADER, TRACE_HEADER):
        ctx = parse_traceparent(carrier.get(key))
        if ctx is not None:
            return ctx
    raw = carrier.get(TRACE_HEADER)
    if raw and isinstance(raw, str) and re.match(r"^[0-9a-f]{2,64}$",
                                                 raw.strip().lower()):
        tid = raw.strip().lower()
        return SpanContext(tid, tid)
    return None


def current_traceparent() -> Optional[str]:
    """The ambient span's header value, or None outside any span —
    what a client stamps on an outgoing hop."""
    ctx = tracing.current()
    return format_traceparent(ctx) if ctx is not None else None


def new_request_id() -> str:
    """A fresh correlation id (same generator as span ids, so ids are
    unique across processes) for requests that arrive without an
    ``X-Request-Id``."""
    return tracing._new_id()


# -- env stamping (WorkerPool children) --------------------------------------

def to_env(ctx: Optional[SpanContext]) -> Dict[str, str]:
    """``PADDLE_TRACE_*`` variables carrying ``ctx`` into a spawned
    child; {} when there is no ambient context."""
    if ctx is None:
        return {}
    return {ENV_TRACE_CONTEXT: format_traceparent(ctx),
            ENV_TRACE_ID: ctx.trace_id}


def from_env(environ=None) -> Optional[SpanContext]:
    """Read the context a parent stamped (``to_env``) out of the
    environment — the child's boot spans attach to it."""
    env = os.environ if environ is None else environ
    return parse_traceparent(env.get(ENV_TRACE_CONTEXT))


# -- the per-process trace index ---------------------------------------------
#
# The "bounded completed-span ring" is the flight recorder itself:
# span exits already append {kind: "span", trace_id, span_id,
# parent_id, ts, dur, tid, ...} entries, capped at
# observability_flight_capacity. Indexing by trace id is a scan of at
# most that many entries, paid at query time (an admin endpoint), not
# on the span hot path.

def trace_spans(trace_id: str) -> List[Dict[str, Any]]:
    """Completed spans of ``trace_id`` still in this process's ring,
    oldest first."""
    return [e for e in flight.entries()
            if e.get("kind") == "span" and e.get("trace_id") == trace_id]


def local_trace(trace_id: str, *,
                phase: Optional[str] = None) -> Dict[str, Any]:
    """The ``/v1/admin/trace/<id>`` payload: this process's spans for
    the trace, each stamped with the pid (the process-lane key for
    a timeline renderer) and the worker identity when known."""
    pid = os.getpid()
    worker = os.environ.get("PADDLE_WORKER_ID") or None
    spans = []
    for e in trace_spans(trace_id):
        s = dict(e)
        s["pid"] = pid
        if worker:
            s.setdefault("worker", worker)
        spans.append(s)
    out: Dict[str, Any] = {
        "trace_id": trace_id,
        "pid": pid,
        "host": socket.gethostname(),
        "spans": spans,
    }
    if worker:
        out["worker"] = worker
    if phase:
        out["phase"] = phase
    return out


def orphan_spans(spans: List[Dict[str, Any]],
                 known_parents=()) -> List[Dict[str, Any]]:
    """Spans whose ``parent_id`` names no span in ``spans`` and none
    of ``known_parents`` (e.g. the client-side span id that arrived in
    the traceparent header). Empty list == the trace is fully
    connected — the propagation round-trip gate."""
    ids = {s.get("span_id") for s in spans} | set(known_parents)
    return [s for s in spans
            if s.get("parent_id") and s["parent_id"] not in ids]
