"""The port's profiler, timeline, flags and data-tier telemetry held to
the JAX package's on the CPU.

``tools_timeline.to_chrome_trace`` is pure host code in both packages:
for the same events (and thread names) the two must give the SAME JSON.
The host-event log (``record_event``, ``emit_event``, spans while a
session records), the compile history and the ``paddle_reader_*`` /
``paddle_step_overlap_*`` series are compared by name and label set.
``FLAGS_<name>`` environment overrides are read at import, so they are
held in fresh subprocesses of both packages.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import profiler as jprofiler
from paddle_tpu import tools_timeline as jtimeline
from paddle_tpu.observability import registry as jregistry
from paddle_tpu.reader import GeneratorLoader as JLoader
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch import tools_timeline as ttimeline
from paddle_tpu_torch.observability import flight, tracing
from paddle_tpu_torch.observability import registry as tregistry
from paddle_tpu_torch.reader import GeneratorLoader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = [tfluid.CPUPlace()]


# -- the chrome trace ----------------------------------------------------------


EVENT_SETS = {
    "plain": [
        {"name": "a", "ts": 10.0, "dur": 0.5, "tid": 0},
        {"name": "b", "ts": 10.25, "dur": 0.125, "tid": 1,
         "args": {"step": 3}},
    ],
    "flows": [
        {"name": "submit", "ts": 1.0, "dur": 0.25, "tid": 0,
         "args": {"span_id": "s1", "trace_id": "t"}},
        {"name": "work", "ts": 1.5, "dur": 0.5, "tid": 2,
         "args": {"span_id": "s2", "parent_id": "s1", "trace_id": "t"}},
        {"name": "nested", "ts": 1.6, "dur": 0.1, "tid": 2,
         "args": {"span_id": "s3", "parent_id": "s2", "trace_id": "t"}},
        {"name": "joined", "ts": 2.5, "dur": 0.1, "tid": 3,
         "args": {"span_id": "s4", "flow_from": ["s1", "s3"]}},
    ],
    "lanes": [
        {"name": "router", "ts": 5.0, "dur": 1.0, "tid": 0,
         "args": {"span_id": "r", "worker": "router"}},
        {"name": "prefill", "ts": 5.2, "dur": 0.5, "tid": 7, "pid": 4242,
         "args": {"span_id": "p", "parent_id": "r", "worker": "prefill-0"}},
        {"name": "decode", "ts": 5.8, "dur": 0.1, "tid": 7, "pid": 4343,
         "args": {"span_id": "d", "parent_id": "p"}},
        {"name": "flat", "ts": 6.0, "dur": 0.05, "tid": 1, "kind": "span",
         "t": 6.0, "extra": 1},
    ],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(EVENT_SETS))
def test_chrome_trace_json_equals_jax(name, tmp_path):
    events = EVENT_SETS[name]
    # every tid named here: each package's own registry of this process's
    # threads fills in the rest, and the two registries differ
    names = {0: "MainThread", 1: "pt-reader-prefetch", 2: "worker-2",
             3: "joiner", 7: "foreign"}
    procs = {4343: "decode-0"}
    t = ttimeline.to_chrome_trace(events, names, procs)
    j = jtimeline.to_chrome_trace(events, names, procs)
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)
    pt = ttimeline.save_chrome_trace(str(tmp_path / "t.json"), events, names,
                                     procs)
    pj = jtimeline.save_chrome_trace(str(tmp_path / "j.json"), events, names,
                                     procs)
    with open(pt) as a, open(pj) as b:
        assert json.load(a) == json.load(b)
    if name == "flows":
        flows = [e for e in t["traceEvents"] if e.get("cat") == "flow"]
        # an s and an f event an arrow: s1 -> s2, s1 -> s4, s3 -> s4
        assert len(flows) == 6


# -- the host-event log --------------------------------------------------------


def test_record_event_logs_only_while_recording():
    tprofiler.reset_profiler()
    with tprofiler.record_event("outside"):
        pass
    assert tprofiler.host_events() == []
    with tprofiler.host_trace():
        with tprofiler.record_event("inside", {"step": 1}):
            pass
        tprofiler.emit_event("pre-timed", 1.0, 0.5, {"k": "v"})
    evs = tprofiler.host_events()
    assert [e["name"] for e in evs] == ["inside", "pre-timed"]
    assert evs[0]["args"] == {"step": 1} and evs[0]["dur"] >= 0
    assert evs[1] == {"name": "pre-timed", "ts": 1.0, "dur": 0.5,
                      "tid": tprofiler.thread_tid(), "args": {"k": "v"}}
    tprofiler.emit_event("after", 1.0, 0.5)
    assert len(tprofiler.host_events()) == 2
    tprofiler.reset_profiler()
    assert tprofiler.host_events() == []


def test_thread_tids_are_small_stable_and_named():
    tids = {}
    # all four alive at once: a dead thread's ident (and so its tid) may
    # be reused by the next, renamed
    together = threading.Barrier(4)

    def worker(i):
        tids[i] = (tprofiler.thread_tid(), tprofiler.thread_tid())
        together.wait(timeout=10)
        assert tprofiler.thread_names()[tids[i][0]] == f"tw-{i}"

    threads = [threading.Thread(target=worker, args=(i,), name=f"tw-{i}")
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    for a, b in tids.values():
        assert a == b
    assert len({a for a, _ in tids.values()}) == 4


@pytest.mark.parametrize("tracing_on", [False, True])
def test_spans_reach_the_host_log_while_recording(tracing_on):
    """A span is a host event while a session records, with tracing off
    (a plain record_event) and on (with its ids), as in JAX."""
    saved = tfluid.get_flags(["observability_tracing"])
    tfluid.set_flags({"observability_tracing": tracing_on})
    try:
        with tprofiler.host_trace():
            with tracing.span("outer", {"step": 7}):
                with tracing.span("inner"):
                    pass
        evs = {e["name"]: e for e in tprofiler.host_events()}
    finally:
        tfluid.set_flags(saved)
    assert set(evs) == {"outer", "inner"}
    assert evs["outer"]["args"]["step"] == 7
    assert evs["outer"]["tid"] == tprofiler.thread_tid()
    if tracing_on:
        assert evs["inner"]["args"]["parent_id"] == \
            evs["outer"]["args"]["span_id"]
        trace = ttimeline.to_chrome_trace(tprofiler.host_events())
        assert {e["name"] for e in trace["traceEvents"]} >= {"outer",
                                                             "inner"}


def _mlp():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [8])
        y = tfluid.layers.data("y", [1], dtype="int64")
        loss = tfluid.layers.mean(tfluid.layers.softmax_with_cross_entropy(
            tfluid.layers.fc(x, 4), y))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss, x, y


def _feeds(n):
    for i in range(n):
        rng = np.random.RandomState(i)
        yield {"x": rng.rand(4, 8).astype("float32"),
               "y": rng.randint(0, 4, (4, 1)).astype("int64")}


def test_profiler_session_writes_both_traces(tmp_path):
    """``profiler(profile_path=FILE)``: the device trace of
    ``torch.profiler`` (CPU activity here) lands in the log directory
    with the reader's and the step's ranges; FILE receives the host
    chrome trace with the same spans."""
    main, startup, loss, x, y = _mlp()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    loader = GeneratorLoader([x, y], prefetch_depth=2)
    loader.set_batch_generator(lambda: _feeds(3), places=CPU)
    host = str(tmp_path / "host.json")
    with tprofiler.profiler(profile_path=host):
        losses = [o[0] for o in exe.run_pipelined(main, loader, [loss],
                                                  scope=scope)]
    assert len(losses) == 3
    with open(host) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"reader/prefetch", "dispatch/feed", "dispatch/step"} <= names
    logdirs = [e for e in os.listdir(os.path.dirname(host))]
    assert logdirs == ["host.json"]    # the device trace went elsewhere

    logdir = str(tmp_path / "logdir")
    os.makedirs(logdir)
    loader.set_batch_generator(lambda: _feeds(2), places=CPU)
    with tprofiler.profiler(profile_path=logdir):
        list(exe.run_pipelined(main, loader, [loss], scope=scope))
    with open(os.path.join(logdir, tprofiler.TRACE_FILE)) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    names = {e.get("name") for e in events}
    assert {"reader/prefetch", "dispatch/step"} <= names


def test_start_stop_profiler(tmp_path):
    host = str(tmp_path / "h.json")
    tprofiler.start_profiler("All")
    with pytest.raises(RuntimeError, match="already running"):
        tprofiler.start_profiler()
    with tprofiler.record_event("in-session"):
        pass
    trace = tprofiler.stop_profiler(profile_path=host)
    assert os.path.exists(trace)
    with open(host) as f:
        assert "in-session" in {e["name"] for e in
                                json.load(f)["traceEvents"]}
    with pytest.raises(RuntimeError, match="without start_profiler"):
        tprofiler.stop_profiler()


def test_cuda_profiler_writes_its_output_file(tmp_path):
    out = str(tmp_path / "cuda.json")
    with tprofiler.cuda_profiler(out):
        with tprofiler.record_event("x"):
            pass
    with open(out) as f:
        assert "x" in {e["name"] for e in json.load(f)["traceEvents"]}


# -- compile events --------------------------------------------------------------


def test_bind_records_a_compile_and_flight_keeps_it(tmp_path):
    main, startup, loss, _, _ = _mlp()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    before = len(tprofiler.compile_events())
    total = tregistry.registry().counter("paddle_compile_total").get()
    exe.run(startup, scope=scope)
    feed = next(_feeds(1))
    with tprofiler.host_trace():
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        logged = [e["name"] for e in tprofiler.host_events()]
    evs = tprofiler.compile_events()[before:]
    assert [e["name"] for e in evs] == [f"program_{startup.uid}",
                                        f"program_{main.uid}"]
    assert f"program_{main.uid}" in logged
    assert tregistry.registry().counter("paddle_compile_total").get() == \
        total + 2
    path = flight.dump("test", path=str(tmp_path / "f.json"))
    with open(path) as f:
        dumped = json.load(f)["compile_events"]
    assert dumped[-1]["name"] == f"program_{main.uid}"
    # JAX's compile event keys
    jprofiler.record_compile("probe", 0.0)
    assert set(dumped[-1]) == set(jprofiler.compile_events()[-1])


# -- the data tiers' series --------------------------------------------------------


def test_reader_series_names_equal_jax():
    # held here: the registries watch loaders through weak references
    live = (JLoader([], use_double_buffer=False),
            GeneratorLoader([], use_double_buffer=False))
    js = {n: sorted({tuple(sorted(lbl)) for lbl, _ in items})
          for n, items in jregistry._collect_loaders().items()}
    ts = {n: sorted({tuple(sorted(lbl)) for lbl, _ in items})
          for n, items in tregistry._collect_loaders().items()}
    assert ts == js
    assert sorted(ts) == sorted(
        f"paddle_reader_{s}" for s in (
            "queue_depth", "position", "capacity",
            "buffer_full_stall_total", "buffer_empty_stall_total",
            "prefetch_depth", "trainer_id", "num_trainers"))
    text = tfluid.observability.to_prometheus_text()
    assert f'paddle_reader_capacity{{loader="{live[1]._obs_id}"}} 64' in text


def test_overlap_series_names_equal_jax():
    t = tregistry.overlap_telemetry()
    j = jregistry.overlap_telemetry()
    assert sorted(t.collect()) == sorted(j.collect())
    assert sorted(t.snapshot()) == sorted(j.snapshot())
    a = tregistry._OverlapTelemetry()
    b = jregistry._OverlapTelemetry()
    for feed, wait in ((10.0, 2.0), (5.0, 0.0), (1.0, 7.5)):
        a.record(feed, wait)
        b.record(feed, wait)
    assert a.snapshot() == b.snapshot()


# -- flags ------------------------------------------------------------------------


ENV_FLAGS = {"FLAGS_reader_prefetch_depth": "5",
             "FLAGS_dispatch_pipeline_depth": "3",
             "FLAGS_reader_queue_speed_test_mode": "true",
             "FLAGS_tracer_profile_fname": "prof_out",
             "FLAGS_serving_batch_timeout_ms": "2.5",
             "FLAGS_observability_tracing": "1"}

_PROBE = """
import json, sys
mod = __import__(sys.argv[1] + ".flags", fromlist=["flag"])
names = {names!r}
print(json.dumps({{n: mod.flag(n) for n in names}}))
print(json.dumps(sorted(mod._explicit)))
"""


def _flags_in_child(pkg):
    env = dict(os.environ, **ENV_FLAGS, JAX_PLATFORMS="cpu",
               CUDA_VISIBLE_DEVICES="")
    names = [k[len("FLAGS_"):] for k in ENV_FLAGS]
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(names=names), pkg], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    vals, explicit = out.stdout.strip().splitlines()[-2:]
    return json.loads(vals), json.loads(explicit)


def test_flags_env_overrides_equal_jax():
    port, port_explicit = _flags_in_child("paddle_tpu_torch")
    jax, jax_explicit = _flags_in_child("paddle_tpu")
    assert port == jax
    assert port == {"reader_prefetch_depth": 5, "dispatch_pipeline_depth": 3,
                    "reader_queue_speed_test_mode": True,
                    "tracer_profile_fname": "prof_out",
                    "serving_batch_timeout_ms": 2.5,
                    "observability_tracing": True}
    assert set(port) <= set(port_explicit)
    assert set(port) <= set(jax_explicit)


def test_flag_generation_and_unknown_flags():
    g = tfluid.flags.generation()
    saved = tfluid.get_flags(["FLAGS_reader_prefetch_depth"])
    tfluid.set_flags({"FLAGS_reader_prefetch_depth": 3})
    try:
        assert tfluid.flags.generation() == g + 1
        assert tfluid.get_flags("reader_prefetch_depth") == {
            "reader_prefetch_depth": 3}
        assert "reader_prefetch_depth" in tfluid.flags._explicit
    finally:
        tfluid.set_flags({"reader_prefetch_depth":
                          saved["FLAGS_reader_prefetch_depth"]})
    with pytest.raises(ValueError, match="unknown flag"):
        tfluid.set_flags({"no_such_flag": 1})
    for name in ("dispatch_pipeline_depth", "reader_prefetch_depth",
                 "reader_queue_speed_test_mode", "tracer_profile_fname"):
        assert tfluid.flags.DEFAULTS[name] == jfluid.flags._FLAG_DEFS[name]
