"""Profiler: ``torch.profiler`` behind the reference's context-manager
API, and the host-event log that ``tools_timeline`` renders.

The port's copy of ``paddle_tpu/profiler.py``. Reference:
python/paddle/fluid/profiler.py (the profiler context manager),
platform/profiler.h RecordEvent, tools/timeline.py (chrome trace).
Where the JAX package starts ``jax.profiler``, the port runs
``torch.profiler.profile`` over the CPU and, where there is a card, the
CUDA activities (CUPTI): its chrome trace (``trace.json`` in the log
directory) holds every kernel and every ``record_event`` /
``observability.tracing`` range. The host-event log, its lock
discipline, the stable per-thread ids and the compile history are the
JAX package's.

Status lines go through the ``paddle_tpu_torch.profiler`` logger, never
stdout: the serving HTTP server and pipe-reading tools share this
process's stdout.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import threading
import time

import torch

__all__ = ["profiler", "start_profiler", "stop_profiler", "reset_profiler",
           "cuda_profiler", "record_event", "emit_event", "host_trace",
           "host_events", "thread_tid", "thread_names", "record_compile",
           "compile_events", "TRACE_FILE"]

_log = logging.getLogger("paddle_tpu_torch.profiler")

# the device trace's name inside the log directory
TRACE_FILE = "trace.json"


def _default_profile_path() -> str:
    return os.path.join(tempfile.gettempdir(), "profile")


def _start_device_trace():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    kw = {}
    try:
        # the ranges of every thread (the loader's prefetch thread, the
        # pipelined step's feeder), not only this one's; a torch without
        # the option traces this thread's ranges and every kernel
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    prof = torch.profiler.profile(activities=acts, **kw)
    prof.__enter__()
    return prof


def _stop_device_trace(prof, logdir: str) -> str:
    prof.__exit__(None, None, None)
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None):
    """Trace the block: the device trace (``torch.profiler``, kernels and
    host ranges) goes to ``profile_path`` when it is a directory, else
    to a fresh temporary directory, and then ``profile_path`` receives
    the host-event chrome trace (``tools_timeline``). ``state`` and
    ``sorted_key`` are accepted as in the reference."""
    global _recording
    profile_path = profile_path or _default_profile_path()
    logdir = (profile_path if os.path.isdir(profile_path)
              else tempfile.mkdtemp(prefix="pt_prof_"))
    with _events_lock:
        _host_events.clear()  # fresh session: no stale events in the trace
    prof = _start_device_trace()
    _recording = True
    t0 = time.time()
    try:
        yield
    finally:
        _recording = False
        trace = _stop_device_trace(prof, logdir)
        if not os.path.isdir(profile_path):
            from .tools_timeline import save_chrome_trace

            save_chrome_trace(profile_path, host_events())
        _log.info("traced %.3fs -> %s (chrome://tracing or perfetto)",
                  time.time() - t0, trace)


# host-side event log (reference platform/profiler.cc's Event vector):
# filled by record_event while profiling is on; rendered to a chrome
# trace by tools_timeline.
#
# Appends arrive from ARBITRARY threads (serving workers, the loader's
# prefetch thread, the pipelined step's feeder) and the ring-trim below
# deletes a slice, so every mutation and snapshot goes through one
# module lock. The lock guards the LISTS only; ``_recording`` stays a
# plain bool (a racy read at worst drops the first/last event of a
# session, never corrupts state).
_events_lock = threading.Lock()
_host_events: list = []
_recording = False
# a session left recording for hours stays constant-memory: trim half
# past the cap
_HOST_EVENTS_CAP = 200_000

# stable per-thread trace ids: small, stable for a thread's lifetime,
# and carrying the thread's NAME (tools_timeline emits it as metadata)
_thread_tids: dict = {}
_thread_names: dict = {}


def thread_tid() -> int:
    """Small stable tid for the calling thread (registers its name on
    first use). The name is refreshed when it no longer matches: the OS
    reuses thread idents after a thread dies, and the reused ident must
    not carry a dead thread's label into the trace."""
    ident = threading.get_ident()
    name = threading.current_thread().name
    tid = _thread_tids.get(ident)
    if tid is None:
        with _events_lock:
            tid = _thread_tids.get(ident)
            if tid is None:
                tid = len(_thread_tids)
                _thread_tids[ident] = tid
            _thread_names[tid] = name
    elif _thread_names.get(tid) != name:
        with _events_lock:
            _thread_names[tid] = name
    return tid


def thread_names() -> dict:
    """tid -> thread name for every thread that ever emitted an event."""
    with _events_lock:
        return dict(_thread_names)


def _append_host_event(ev: dict) -> None:
    # caller holds _events_lock
    _host_events.append(ev)
    if len(_host_events) > _HOST_EVENTS_CAP:
        del _host_events[:_HOST_EVENTS_CAP // 2]


@contextlib.contextmanager
def record_event(name: str, args=None):
    """RAII event annotation (reference platform/profiler.h:124
    RecordEvent): a ``torch.profiler.record_function`` range in the
    device trace AND, while recording, an entry of the host-event log.
    ``args`` attaches structured metadata that tools_timeline renders as
    the chrome-trace event's args panel."""
    t0 = time.time()
    with torch.profiler.record_function(name):
        try:
            yield
        finally:
            if _recording:
                ev = {"name": name, "ts": t0, "dur": time.time() - t0,
                      "tid": thread_tid()}
                if args:
                    ev["args"] = dict(args)
                with _events_lock:
                    _append_host_event(ev)


def emit_event(name: str, ts: float, dur: float, args=None) -> None:
    """Append one pre-timed host event (nothing outside a recording
    session): the path of ``observability.tracing`` spans, which own
    their timing and their ``record_function`` range already."""
    if not _recording:
        return
    ev = {"name": name, "ts": ts, "dur": dur, "tid": thread_tid()}
    if args:
        ev["args"] = dict(args)
    with _events_lock:
        _append_host_event(ev)


@contextlib.contextmanager
def host_trace(clear: bool = True):
    """Capture host events (record_event / tracing spans) WITHOUT a
    device trace: the cheap host-only session tests and benchmarks use
    to observe spans deterministically."""
    global _recording
    if clear:
        with _events_lock:
            _host_events.clear()
    prev = _recording
    _recording = True
    try:
        yield
    finally:
        _recording = prev


def host_events():
    with _events_lock:
        return list(_host_events)


# compile-event history: kept unconditionally (when each step was first
# planned, when the kernel library was built) and mirrored into the
# host-event log while a session records. Ring-capped.
_compile_events: list = []
_COMPILE_EVENTS_CAP = 1000


def record_compile(name: str, dur: float):
    """One build of something a step needs: a ``BoundStep``'s first plan
    (``runtime/dispatch.py``) or the kernel library
    (``kernels/_build.py``)."""
    ev = {"name": name, "ts": time.time() - dur, "dur": dur,
          "tid": thread_tid()}
    with _events_lock:
        _compile_events.append(ev)
        if len(_compile_events) > _COMPILE_EVENTS_CAP:
            del _compile_events[:_COMPILE_EVENTS_CAP // 2]
        if _recording:
            _append_host_event(ev)
    # lazy import: observability imports this module
    from .observability import flight, registry

    registry.registry().counter(
        "paddle_compile_total", "steps planned and kernel libraries built"
    ).inc()
    registry.registry().gauge(
        "paddle_compile_last_s", "duration of the last compile").set(dur)
    flight.note("compile", name=name, dur=dur)


def compile_events():
    with _events_lock:
        return list(_compile_events)


_session: dict = {}


def start_profiler(state="All"):
    """Start a session that ``stop_profiler`` ends."""
    global _recording
    if _session:
        raise RuntimeError("a profiler session is already running")
    _session["logdir"] = tempfile.mkdtemp(prefix="pt_prof_")
    with _events_lock:
        _host_events.clear()  # fresh session
    _session["prof"] = _start_device_trace()
    _recording = True


def stop_profiler(sorted_key=None, profile_path=None):
    """End the session: the device trace goes to the session's log
    directory, the host-event chrome trace to ``profile_path`` if
    given. Returns the device trace's path."""
    global _recording
    if not _session:
        raise RuntimeError("stop_profiler without start_profiler")
    _recording = False
    prof, logdir = _session.pop("prof"), _session.pop("logdir")
    trace = _stop_device_trace(prof, logdir)
    if profile_path:
        from .tools_timeline import save_chrome_trace

        save_chrome_trace(profile_path, host_events())
    _log.info("trace in %s", trace)
    return trace


def reset_profiler():
    with _events_lock:
        _host_events.clear()


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """Reference profiler.py cuda_profiler: a ``profiler`` session (CUDA
    activity included on a card) whose host trace goes to
    ``output_file``."""
    with profiler(profile_path=output_file):
        yield
