"""Chrome-trace writer for host profiler events.

The port's copy of ``paddle_tpu/tools_timeline.py``: the same JSON for
the same events. Reference: tools/timeline.py:36
(_ChromeTraceFormatter) / :131 (Timeline) — converts profiler output to
the chrome://tracing JSON format. Device-side timing here comes from
``torch.profiler``'s trace (``profiler.TRACE_FILE`` in the session's log
directory); this writer covers the HOST event log
(profiler.record_event ranges + observability.tracing spans), same
viewer.

Three things beyond plain "X" ranges:

* **process lanes** — events may carry a ``pid`` (spans imported from
  another process via ``/v1/admin/trace/<id>`` are pid-stamped by
  ``observability.propagate.local_trace``); each pid becomes its own
  process group with a ``process_name`` metadata event (from
  ``process_names`` or the span's ``worker``/``process`` arg), so a
  cross-process trace renders router / prefill / page-store / decode
  as separate lanes instead of collapsing foreign spans onto local
  tids. Events without a pid land in process 0 ("paddle_tpu host",
  the JAX package's lane title, kept so that the two packages' traces
  are the same JSON).
* **thread metadata** — events carry the profiler's stable per-thread
  tids; each (pid, tid) gets a ``thread_name`` metadata event so lanes
  read "pt-serving-worker-1", not a bare number (names only apply to
  the local process — a foreign pid's tids are its own).
* **flow arrows** — spans carry ``span_id``/``parent_id`` (and
  optionally ``flow_from``, a list of source span ids) in their args.
  When parent and child ran on a DIFFERENT thread or process, a
  ``ph: s`` / ``ph: f`` flow-event pair is emitted so Perfetto draws
  the arrow: a serving request's submit span visibly hands off to the
  worker thread's batch-execute span, and a router's HTTP span hands
  off to the prefill worker's span one process lane over.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional


def to_chrome_trace(events: List[Dict],
                    thread_names: Optional[Dict[int, str]] = None,
                    process_names: Optional[Dict[int, str]] = None) -> Dict:
    """events: [{name, ts (s), dur (s), tid, pid?, args?}] -> chrome
    trace dict. ``thread_names`` overrides/extends the profiler's
    registry (tid -> display name, local process only);
    ``process_names`` names foreign pids (pid -> lane title)."""
    names = {}
    try:
        from . import profiler

        names.update(profiler.thread_names())
    except Exception:  # noqa: BLE001 — standalone use on raw event dicts
        pass
    names.update(thread_names or {})

    t0 = min((e["ts"] for e in events), default=0.0)
    # index span_id -> its rendered (pid, tid, ts, dur) for flow links
    span_index: Dict[str, Dict] = {}
    rendered = []
    seen_tids = set()            # (pid, tid) pairs
    pid_titles: Dict[int, str] = dict(process_names or {})
    seen_pids = set()
    for e in events:
        tid = int(e.get("tid", 0))
        pid = int(e.get("pid", 0))
        seen_tids.add((pid, tid))
        seen_pids.add(pid)
        ch = {
            "name": e["name"],
            "ph": "X",  # complete event
            "pid": pid,
            "tid": tid,
            "ts": (e["ts"] - t0) * 1e6,   # microseconds
            "dur": e["dur"] * 1e6,
            "cat": "host",
        }
        args = e.get("args") or {k: v for k, v in e.items()
                                 if k not in ("name", "ph", "ts", "dur",
                                              "tid", "pid", "kind", "t")}
        if args:
            ch["args"] = args  # structured span metadata
            sid = args.get("span_id")
            if sid:
                span_index[sid] = ch
            if pid not in pid_titles:
                lane = args.get("worker") or args.get("process")
                if lane:
                    pid_titles[pid] = str(lane)
        rendered.append(ch)

    trace_events = []
    for pid in sorted(seen_pids | set(pid_titles)):
        title = pid_titles.get(
            pid, "paddle_tpu host" if pid == 0 else f"pid {pid}")
        trace_events.append({
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": title},
        })
    for pid, tid in sorted(seen_tids):
        # thread names come from THIS process's profiler registry:
        # only meaningful for local (pid 0) lanes — a foreign pid's
        # tid numbering is its own
        name = names.get(tid) if pid == 0 else None
        if name:
            trace_events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": name},
            })

    trace_events.extend(rendered)

    # flow arrows for cross-thread/cross-process parentage: s at the
    # source span's midpoint, f (binding point "e": enclosing slice)
    # at the child's start
    flow_n = 0
    for ch in rendered:
        args = ch.get("args") or {}
        sources = []
        if args.get("parent_id"):
            sources.append(args["parent_id"])
        sources.extend(args.get("flow_from") or [])
        for src_id in sources:
            src = span_index.get(src_id)
            if (src is None or (src["tid"] == ch["tid"]
                                and src["pid"] == ch["pid"])):
                continue  # same-lane nesting needs no arrow
            flow_n += 1
            fid = f"flow{flow_n}"
            trace_events.append({
                "name": "handoff", "ph": "s", "cat": "flow", "id": fid,
                "pid": src["pid"], "tid": src["tid"],
                "ts": src["ts"] + src["dur"] * 0.5,
            })
            trace_events.append({
                "name": "handoff", "ph": "f", "bp": "e", "cat": "flow",
                "id": fid, "pid": ch["pid"], "tid": ch["tid"],
                "ts": ch["ts"],
            })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def save_chrome_trace(path: str, events: List[Dict],
                      thread_names: Optional[Dict[int, str]] = None,
                      process_names: Optional[Dict[int, str]] = None) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(events, thread_names, process_names), f)
    return path
