"""Crash-time flight recorder: the last N events, always on, in constant
memory, dumped as JSON when something goes wrong (the counterpart of
``paddle_tpu/observability/flight.py``).

``note()`` appends one entry (span completions from ``tracing``,
supervisor events such as retry, rollback, NaN and watchdog fires) to a
bounded deque of ``observability_flight_capacity`` entries.
``dump(reason)`` writes the ring and the metrics registry's snapshot
into one JSON file, in the JAX package's layout (``flight_recorder``,
``reason``, ``time``, ``pid``, ``version``, ``entries``, ``metrics``,
``extra``; the port compiles no executables at run time, so the JAX
dump's ``compile_events`` has no counterpart). It is called from the
supervisor's failure paths, the traffic controller's SLO breach, the
fleet's sustained burn, ``POST /v1/admin/flight/dump`` and SIGUSR2
(``install_signal_handlers``). A dump never makes a crash worse: any
failure inside it is logged and reported as ``None``.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import signal
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from ..flags import _flags

__all__ = ["note", "entries", "clear", "dump", "last_dump_path",
           "install_signal_handlers"]

_log = logging.getLogger("paddle_tpu_torch.observability")

_lock = threading.Lock()
_ring: Optional[collections.deque] = None
_ring_flag_cap = None  # the raw flag value the ring was last sized from
_dump_count = [0]
_last_dump: List[Optional[str]] = [None]


def _get_ring() -> collections.deque:
    """Sized from the flag at first use and re-sized (newest entries
    kept) when the flag changes. Caller holds ``_lock``."""
    global _ring, _ring_flag_cap
    raw = _flags["observability_flight_capacity"]
    if _ring is None or raw != _ring_flag_cap:
        cap = max(16, int(raw))
        old = list(_ring) if _ring is not None else []
        _ring = collections.deque(old[-cap:], maxlen=cap)
        _ring_flag_cap = raw
    return _ring


def note(kind: str, **fields) -> None:
    """Append one entry; safe from any thread, a no-op with the recorder
    off."""
    if not _flags["observability_flight"]:
        return
    entry = {"kind": kind, "t": fields.pop("t", None) or time.time()}
    entry.update(fields)
    append_entry(entry)


def append_entry(entry: Dict[str, Any]) -> None:
    """Append a caller-built entry (with its ``kind`` and ``t`` keys)."""
    if not _flags["observability_flight"]:
        return
    with _lock:
        _get_ring().append(entry)


def entries() -> List[Dict[str, Any]]:
    """A consistent snapshot of the ring, oldest first."""
    with _lock:
        return list(_ring) if _ring is not None else []


def clear() -> None:
    with _lock:
        if _ring is not None:
            _ring.clear()


def last_dump_path() -> Optional[str]:
    return _last_dump[0]


def _json_default(o):
    import numpy as np

    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def dump(reason: str, extra: Optional[Dict[str, Any]] = None,
         path: Optional[str] = None) -> Optional[str]:
    """Write the flight snapshot; returns the file's path, or None (a
    crash path must never raise out of its own postmortem)."""
    try:
        from .. import profiler
        from .registry import VERSION, registry

        payload = {"flight_recorder": 1, "reason": reason,
                   "time": time.time(), "pid": os.getpid(),
                   "version": VERSION, "entries": entries(),
                   "metrics": registry().snapshot(),
                   "compile_events": profiler.compile_events()[-64:]}
        if extra:
            payload["extra"] = extra
        if path is None:
            d = os.path.expanduser(_flags["observability_dump_dir"] or "")
            d = d or tempfile.gettempdir()
            os.makedirs(d, exist_ok=True)
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in reason)[:48]
            with _lock:
                _dump_count[0] += 1
                n = _dump_count[0]
            path = os.path.join(d, f"flight_{os.getpid()}_{n:03d}_{safe}.json")
        with open(path, "w") as f:
            json.dump(payload, f, default=_json_default)
        _last_dump[0] = path
        _log.warning("flight recorder dumped (%s) -> %s", reason, path)
        return path
    except Exception as e:  # noqa: BLE001 — never worsen a crash
        _log.error("flight recorder dump failed: %r", e)
        return None


def install_signal_handlers() -> bool:
    """SIGUSR2 -> dump (chaining any earlier handler). Main thread only:
    returns False, having installed nothing, elsewhere. The dump runs on
    a thread of its own, never in the handler: the handler runs on the
    main thread, which may hold the ring's lock mid-append. A SIGTERM
    flush belongs to its owner (``resilience.Supervisor``), as in the
    JAX package."""
    if threading.current_thread() is not threading.main_thread():
        return False
    prev = signal.getsignal(signal.SIGUSR2)

    def _handler(signum, frame):
        threading.Thread(target=dump, args=("sigusr2",),
                         name="pt-flight-dump", daemon=True).start()
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)

    signal.signal(signal.SIGUSR2, _handler)
    return True


def install_excepthook() -> None:
    """Chain ``sys.excepthook`` so that any uncaught exception dumps the
    ring before its traceback prints (opt-in)."""
    prev = sys.excepthook

    def _hook(exc_type, exc, tb):
        dump(f"uncaught:{exc_type.__name__}")
        prev(exc_type, exc, tb)

    sys.excepthook = _hook
