"""Trace spans with parentage (the counterpart of
``paddle_tpu/observability/tracing.py``).

With ``observability_tracing`` off (the default) ``span`` is
``profiler.record_event``: a ``torch.profiler.record_function`` range,
and a host event while a profiler session records. With it on, a span
also carries a ``trace_id``, a ``span_id`` and its ``parent_id``,
logs itself into the flight recorder when it closes, and goes into the
profiler's host-event log while a session records (JAX's :120-145).
Where the JAX package opens a ``jax.profiler.TraceAnnotation`` (its
:124), the port opens ``record_function``.

Propagation is ambient within a thread (a thread-local stack: nested
``span()`` calls parent automatically) and explicit across threads:
the submitting side keeps the context ``span(...)`` yields on the work
item, and the consuming thread opens its span with ``parent=ctx`` or
wraps its handling in ``attach(ctx)``. ``traced`` is the decorator
form.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from typing import Any, Dict, NamedTuple, Optional

import torch

from .. import profiler
from ..flags import _flags
from . import flight

__all__ = ["SpanContext", "span", "traced", "attach", "current", "enabled"]


class SpanContext(NamedTuple):
    trace_id: str
    span_id: str


_tls = threading.local()
_proc_prefix = os.urandom(4).hex()


def _new_id() -> str:
    n = getattr(_tls, "id_n", None)
    if n is None:
        _tls.id_prefix = f"{_proc_prefix}{os.urandom(3).hex()}"
        n = 0
    _tls.id_n = n + 1
    return f"{_tls.id_prefix}{n:08x}"


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def enabled() -> bool:
    return bool(_flags["observability_tracing"])


def current() -> Optional[SpanContext]:
    """The innermost open span on this thread, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


class _AmbientType:
    """Sentinel for "parent from the thread-local stack", with a stable
    repr."""

    def __repr__(self):
        return "<ambient parent>"


_AMBIENT = _AmbientType()


class _Span:
    __slots__ = ("name", "meta", "ctx", "t0", "_rf", "_stack")

    # entry keys the recorder owns; span args may not override them
    _RESERVED = frozenset(("kind", "t", "name", "ts", "dur", "tid"))

    def __init__(self, name: str, args: Optional[Dict[str, Any]], parent):
        st = _stack()
        par = (st[-1] if st else None) if parent is _AMBIENT else parent
        ctx = SpanContext(par.trace_id if par is not None else _new_id(),
                          _new_id())
        meta = dict(args) if args else {}
        meta["trace_id"] = ctx.trace_id
        meta["span_id"] = ctx.span_id
        if par is not None:
            meta["parent_id"] = par.span_id
        self.name, self.meta, self.ctx, self._stack = name, meta, ctx, st

    def __enter__(self) -> SpanContext:
        self._stack.append(self.ctx)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.t0 = time.time()
        return self.ctx

    def __exit__(self, *exc):
        dur = time.time() - self.t0
        self._rf.__exit__(*exc)
        self._stack.pop()
        profiler.emit_event(self.name, self.t0, dur, self.meta)
        entry = {"kind": "span", "t": self.t0, "name": self.name,
                 "ts": self.t0, "dur": dur, "tid": profiler.thread_tid()}
        for k, v in self.meta.items():
            if k not in self._RESERVED:
                entry[k] = v
        flight.append_entry(entry)
        return False


class _Plain:
    """The range of a span with tracing off: ``profiler.record_event``
    (a ``record_function`` range, a host event while a session records)
    that yields None, as the JAX package's does."""

    __slots__ = ("_rf", "name", "args", "t0")

    def __init__(self, name: str, args):
        self.name, self.args = name, args
        self._rf = torch.profiler.record_function(name)

    def __enter__(self):
        self._rf.__enter__()
        self.t0 = time.time()
        return None

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        if profiler._recording:
            profiler.emit_event(self.name, self.t0, time.time() - self.t0,
                                self.args)
        return False


def span(name: str, args: Optional[Dict[str, Any]] = None, parent=_AMBIENT):
    """Context manager for one traced range: yields the SpanContext with
    tracing on, and None (a plain ``record_function`` range) with it
    off. ``parent``: the ambient span by default; an explicit
    SpanContext stitches across threads, None forces a new root."""
    if not _flags["observability_tracing"]:
        return _Plain(name, args)
    return _Span(name, args, parent)


class _Attach:
    __slots__ = ("ctx", "_st")

    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        self._st = _stack() if self.ctx is not None else None
        if self._st is not None:
            self._st.append(self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        if self._st is not None:
            self._st.pop()
        return False


def attach(ctx: Optional[SpanContext]) -> _Attach:
    """Adopt ``ctx`` as this thread's ambient parent for the duration:
    the cross-thread handoff (a worker wraps its handling in
    ``attach(req.ctx)`` and every span inside parents under it)."""
    return _Attach(ctx)


def traced(name: Optional[str] = None, args: Optional[Dict[str, Any]] = None):
    """Decorator form: ``@traced("serving/rebatch")``."""

    def deco(fn):
        span_name = name or f"{fn.__module__}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with span(span_name, args):
                return fn(*a, **kw)

        return wrapper

    return deco
