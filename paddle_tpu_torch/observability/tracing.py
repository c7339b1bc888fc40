"""Trace spans with parentage (the counterpart of
``paddle_tpu/observability/tracing.py``'s ``span`` and ``enabled``).

With ``observability_tracing`` off (the default) ``span`` is a
``torch.profiler.record_function`` range, which costs nothing outside
a profiler run. With it on, a span also carries a ``trace_id``, a
``span_id`` and its ``parent_id`` (a thread-local stack: nested spans
parent automatically) and logs itself into the flight recorder when it
closes. Where the JAX package opens a ``jax.profiler.TraceAnnotation``,
the port opens ``record_function``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..flags import _flags
from . import flight

__all__ = ["SpanContext", "span", "current", "enabled"]


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


class _Span:
    __slots__ = ("name", "meta", "ctx", "t0", "_rf", "_stack")

    # entry keys the recorder owns; span args may not override them
    _RESERVED = frozenset(("kind", "t", "name", "ts", "dur", "tid"))

    def __init__(self, name: str, args: Optional[Dict[str, Any]]):
        st = _stack()
        par = st[-1] if st else None
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
        entry = {"kind": "span", "t": self.t0, "name": self.name,
                 "ts": self.t0, "dur": dur, "tid": threading.get_ident()}
        for k, v in self.meta.items():
            if k not in self._RESERVED:
                entry[k] = v
        flight.append_entry(entry)
        return False


def span(name: str, args: Optional[Dict[str, Any]] = None):
    """Context manager for one traced range: yields the SpanContext with
    tracing on, and is a plain ``record_function`` range with it off."""
    if not _flags["observability_tracing"]:
        return torch.profiler.record_function(name)
    return _Span(name, args)
