"""Unified telemetry of the port (``paddle_tpu_torch.observability``)
held to the JAX package's: a twin of ``tests/test_observability.py`` and
``tests/test_fleet_obs.py``.

Each deterministic case runs one scenario against each package and
compares what came out: the same series give the same exposition text
(timing values and per-instance ids aside), a ``traceparent`` made by
either package parses in the other, the fleet merge of fixed
``/metrics`` texts is the same text, and the SLO monitor's miss ratio
and burn are the same numbers (within 1e-9) on the same injected clock.
The end-to-end cases run the port alone: a traced HTTP request through
a split prefill/decode service and a TCP page store is one connected
trace, and the supervisor's flight dumps hold the spans, step samples
and registry snapshot that led to the fault.
"""

import json
import os
import re
import signal
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid


def _pkg(name):
    if name == "jax":
        from paddle_tpu import observability
        from paddle_tpu.observability import (fleet, flight, propagate,
                                              registry, tracing)
        from paddle_tpu.serving.metrics import ServingMetrics
        flags = jfluid
    else:
        from paddle_tpu_torch import observability
        from paddle_tpu_torch.observability import (fleet, flight, propagate,
                                                    registry, tracing)
        from paddle_tpu_torch.serving.metrics import ServingMetrics
        flags = tfluid
    return types.SimpleNamespace(
        name=name, obs=observability, fleet=fleet, flight=flight,
        propagate=propagate, registry=registry, tracing=tracing,
        ServingMetrics=ServingMetrics, get_flags=flags.get_flags,
        set_flags=flags.set_flags)


JAX, PORT = _pkg("jax"), _pkg("torch")
_FLAGS = ("observability_metrics", "observability_tracing",
          "observability_flight", "observability_flight_capacity",
          "observability_dump_dir")


def _same(a, b, path="record"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert b == pytest.approx(a, abs=1e-9), (path, a, b)
    else:
        assert a == b, (path, a, b)


def both(scenario, *args):
    """``scenario(pkg, *args)`` on each package with its observability
    flags restored after; the records must be equal. Returns the port's
    record."""
    out = []
    for pkg in (JAX, PORT):
        saved = pkg.get_flags(list(_FLAGS))
        try:
            out.append(scenario(pkg, *args))
        finally:
            pkg.set_flags(saved)
    _same(*out)
    return out[1]


@pytest.fixture()
def port_flags():
    saved = tfluid.get_flags(list(_FLAGS))
    yield tfluid.set_flags
    tfluid.set_flags(saved)


# -- registry ---------------------------------------------------------------


def _instruments(pkg):
    reg = pkg.registry.MetricsRegistry()
    c = reg.counter("t_requests_total", "requests")
    c.inc()
    c.inc(2)
    g = reg.gauge("t_depth")
    g.set(7)
    g.labels(lane="b").set(3)
    h = reg.histogram("t_latency_ms")
    for v in (1.0, 2.0, 100.0):
        h.observe(v)
    same = reg.counter("t_requests_total") is c
    try:
        reg.gauge("t_requests_total")
        clash = None
    except ValueError as e:
        clash = str(e)
    snap = reg.snapshot()
    json.dumps(snap)
    return [same, clash, reg.to_prometheus_text(), snap]


def test_registry_instruments_and_exporters():
    """The same instruments give the same exposition text and snapshot,
    histogram quantiles included (the same log-spaced buckets)."""
    same, clash, text, snap = both(_instruments)
    assert same and "already registered" in clash
    assert "# TYPE t_requests_total counter" in text
    assert "t_requests_total 3" in text
    assert 't_depth{lane="b"} 3' in text
    assert "t_latency_ms_count 3" in text
    assert 't_latency_ms{quantile="0.5"}' in text
    assert snap["instruments"]["t_latency_ms"]["values"]["_"]["count"] == 3


def _bad_collector(pkg):
    reg = pkg.registry.MetricsRegistry()

    def bad():
        raise RuntimeError("scrape-time failure")

    reg.register_collector("bad", bad)
    reg.register_collector("good", lambda: {
        "t_ok_total": 1, "t_lab": [({"w": "a"}, 2.5)]})
    text = reg.to_prometheus_text()
    reg.unregister_collector("good")
    return [text, reg.to_prometheus_text()]


def test_registry_collector_survives_bad_collector():
    text, after = both(_bad_collector)
    assert "t_ok_total 1" in text and 't_lab{w="a"} 2.5' in text
    assert "t_ok_total" not in after


def _serving_series(pkg):
    sm = pkg.ServingMetrics()
    sm.inc("requests_total")
    sm.inc("responses_total")
    sm.observe_latency(3.0)
    sm.observe_batch(1, 1, 4)
    text = pkg.obs.to_prometheus_text()
    eid = sm._obs_id
    lines = sorted(line.replace(f'engine="{eid}"', 'engine="E"')
                   for line in text.splitlines()
                   if f'engine="{eid}"' in line)
    del sm
    return lines


def test_unified_scrape_serving_series_match_jax():
    """A ServingMetrics registers itself: its labeled series in the one
    scrape are the JAX package's line for line."""
    lines = both(_serving_series)
    assert 'paddle_serving_requests_total{engine="E"} 1.0' in lines
    assert any(line.startswith('paddle_serving_latency_ms_p50{engine="E"}')
               for line in lines)


def test_unified_snapshot_exposes_all_subsystem_families(tmp_path):
    """After each subsystem merely exists or ran, its family is in the
    one scrape: serving, executor, supervisor, step telemetry, traffic,
    the page store and the build stamp."""
    from paddle_tpu_torch import resilience
    from paddle_tpu_torch.disagg import HostPageStore
    from paddle_tpu_torch.traffic import TrafficController
    from tests.test_torch_resilience import build_model, feed_fn

    sm = PORT.ServingMetrics()
    sm.inc("requests_total")
    store = HostPageStore(page_size=4)
    main, startup, loss = build_model()
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        ck = str(tmp_path / "ck")
        sup = resilience.Supervisor(
            exe, main, checkpoint_dir=ck, feed_fn=feed_fn, fetch_list=[loss],
            policy=resilience.CheckpointPolicy(ck, every_steps=0,
                                               keep_last=2))
        sup.run_loop(2, resume=False, final_checkpoint=False)

    class _Eng:
        metrics = sm
        max_batch_size, num_workers, batch_timeout_s = 4, 1, 0.002
        queue_capacity = 8

    ctl = TrafficController(_Eng(), start=False)
    text = PORT.obs.to_prometheus_text()
    for family in ("paddle_serving_requests_total",
                   "paddle_executor_bound_hits",
                   "paddle_executor_compiled_blocks",
                   "paddle_resilience_steps_completed",
                   "paddle_step_total", "paddle_traffic_queue_depth",
                   "paddle_disagg_pages", "paddle_build_info"):
        assert family in text, f"{family} missing from the unified scrape"
    snap = PORT.obs.snapshot()
    json.dumps(snap)
    assert "paddle_resilience_steps_completed" in snap["collected"]
    ctl.close(drain=False)
    del sm, store, sup


# -- tracing ----------------------------------------------------------------


def _parentage(pkg):
    pkg.set_flags({"observability_tracing": True,
                   "observability_flight": True})
    pkg.flight.clear()
    T = pkg.tracing
    with T.span("outer") as outer:
        cur_is_outer = T.current() == outer
        with T.span("inner") as inner:
            same_trace = inner.trace_id == outer.trace_id
    handoff = {}

    def worker():
        with T.attach(outer):
            with T.span("worker_side") as ctx:
                handoff["ctx"] = ctx

    t = threading.Thread(target=worker)
    t.start()
    t.join()

    @T.traced("decorated")
    def deco():
        return T.current() is not None

    inside = deco()
    spans = {e["name"]: e for e in pkg.flight.entries()
             if e["kind"] == "span"}
    with T.span("root", parent=None) as root:
        fresh = root.trace_id != outer.trace_id
    return [cur_is_outer, same_trace,
            handoff["ctx"].trace_id == outer.trace_id,
            spans["inner"]["parent_id"] == outer.span_id,
            spans["worker_side"]["parent_id"] == outer.span_id,
            "decorated" in spans and inside, fresh, T.current() is None,
            sorted(spans)]


def test_span_parentage_and_cross_thread_attach():
    assert both(_parentage)[:8] == [True] * 8


def _disabled(pkg):
    pkg.set_flags({"observability_tracing": False})
    pkg.flight.clear()
    with pkg.tracing.span("plain_event") as ctx:
        got = ctx
    return [got, [e for e in pkg.flight.entries() if e["kind"] == "span"]]


def test_span_disabled_yields_no_context():
    assert both(_disabled) == [None, []]


def test_concurrent_span_emission_loses_and_duplicates_nothing(port_flags):
    n_threads, k = 8, 150
    port_flags({"observability_tracing": True, "observability_flight": True,
                "observability_flight_capacity": 2 * n_threads * k})
    flight, tracing = PORT.flight, PORT.tracing
    flight.clear()
    stop = threading.Event()
    errors = []

    def reader():
        while not stop.is_set():
            try:
                flight.entries()
            except Exception as e:  # noqa: BLE001 — a torn snapshot
                errors.append(e)

    def writer(i):
        for j in range(k):
            with tracing.span(f"w{i}", {"j": j}):
                pass

    rt = threading.Thread(target=reader)
    rt.start()
    threads = [threading.Thread(target=writer, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    rt.join()
    ring = [e for e in flight.entries() if e["kind"] == "span"]
    assert not errors
    assert len(ring) == n_threads * k
    assert len({e["span_id"] for e in ring}) == n_threads * k


# -- flight recorder --------------------------------------------------------


def _ring(pkg):
    pkg.set_flags({"observability_flight": True,
                   "observability_flight_capacity": 32})
    pkg.flight.clear()
    for i in range(500):
        pkg.flight.note("event", i=i)
    ent = pkg.flight.entries()
    rec = [len(ent), ent[-1]["i"], ent[0]["i"]]
    pkg.set_flags({"observability_flight_capacity": 4})
    for i in range(40):
        pkg.flight.note("event", i=i)
    rec.append(len(pkg.flight.entries()))
    return rec


def test_flight_ring_is_bounded():
    assert both(_ring) == [32, 499, 468, 16]


def _collide(pkg):
    pkg.set_flags({"observability_tracing": True,
                   "observability_flight": True})
    pkg.flight.clear()
    with pkg.tracing.span("collide", {"name": "user-name", "dur": 7,
                                      "step": 3}):
        pass
    (entry,) = [e for e in pkg.flight.entries() if e["kind"] == "span"]
    return [entry["name"], entry["step"], sorted(entry)]


def test_span_args_cannot_collide_with_recorder_keys():
    assert both(_collide)[:2] == ["collide", 3]


def _supervised(tmp_path, fault, **sup_kw):
    from paddle_tpu_torch import resilience
    from tests.test_torch_resilience import build_model, feed_fn

    main, startup, loss = build_model()
    scope = tfluid.Scope()
    ck = str(tmp_path / "ck")
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        sup = resilience.Supervisor(
            exe, main, checkpoint_dir=ck, feed_fn=feed_fn, fetch_list=[loss],
            policy=resilience.CheckpointPolicy(ck, every_steps=3,
                                               keep_last=2),
            fault_injector=resilience.FaultInjector(fault), **sup_kw)
        return sup.run_loop(8)


def test_flight_dump_on_injected_nan(tmp_path, port_flags):
    """The NaN rollback's dump holds the spans and the step samples that
    led to it and the registry's snapshot, in the JAX layout."""
    port_flags({"observability_tracing": True, "observability_flight": True,
                "observability_dump_dir": str(tmp_path / "dumps")})
    PORT.flight.clear()
    stats = _supervised(tmp_path, "nan@5")
    assert stats["nan_events"] == 1 and stats["rollbacks"] == 1
    with open(stats["flight_dumps"][0]) as f:
        dump = json.load(f)
    assert dump["reason"] == "nan_rollback"
    kinds = {e["kind"] for e in dump["entries"]}
    assert {"span", "step"} <= kinds, kinds
    assert any(e["kind"] == "span" and e["name"] == "resilience/step"
               for e in dump["entries"])
    assert "instruments" in dump["metrics"]
    assert "paddle_resilience_rollbacks" in dump["metrics"]["collected"]
    assert dump["version"] == "0.1.0"


def test_flight_dump_survives_bad_dump_dir(port_flags):
    port_flags({"observability_dump_dir": "/proc/definitely/not/writable"})
    assert PORT.flight.dump("unwritable") is None


def test_sigusr2_dumps_the_ring(tmp_path, port_flags):
    """``install_signal_handlers`` (main thread only) dumps on SIGUSR2,
    chaining the handler it found."""
    port_flags({"observability_dump_dir": str(tmp_path)})
    prev = signal.getsignal(signal.SIGUSR2)
    seen = []
    signal.signal(signal.SIGUSR2, lambda s, f: seen.append(s))
    try:
        assert PORT.flight.install_signal_handlers() is True
        box = {}
        t = threading.Thread(target=lambda: box.setdefault(
            "r", PORT.flight.install_signal_handlers()))
        t.start()
        t.join()
        assert box["r"] is False
        os.kill(os.getpid(), signal.SIGUSR2)
        t_end = time.monotonic() + 10
        while time.monotonic() < t_end and not list(tmp_path.iterdir()):
            time.sleep(0.02)
        (path,) = list(tmp_path.iterdir())
        assert json.loads(path.read_text())["reason"] == "sigusr2"
        assert seen == [signal.SIGUSR2]
    finally:
        signal.signal(signal.SIGUSR2, prev)


# -- the trace-context codec -------------------------------------------------


def test_traceparent_made_by_either_parses_in_the_other(port_flags):
    port_flags({"observability_tracing": True})
    old = jfluid.get_flags(["observability_tracing"])
    jfluid.set_flags({"observability_tracing": True})
    try:
        for mk, rd in ((JAX, PORT), (PORT, JAX)):
            with mk.tracing.span("codec") as ctx:
                header = mk.propagate.format_traceparent(ctx)
                assert rd.propagate.parse_traceparent(header) == \
                    (ctx.trace_id, ctx.span_id)
                assert rd.propagate.format_traceparent(
                    rd.propagate.parse_traceparent(header)) == header
                carrier = mk.propagate.inject(ctx)
                assert tuple(rd.propagate.extract(carrier)) == tuple(ctx)
                env = mk.propagate.to_env(ctx)
                assert tuple(rd.propagate.from_env(env)) == tuple(ctx)
                assert rd.propagate.current_traceparent() is None
    finally:
        jfluid.set_flags(old)


def test_traceparent_round_trip_w3c_widths():
    tid, sid = "0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331"
    for pkg in (JAX, PORT):
        ctx = pkg.propagate.parse_traceparent(f"00-{tid}-{sid}-01")
        assert ctx == (tid, sid)
        assert tid in pkg.propagate.format_traceparent(ctx)


@pytest.mark.parametrize("garbage", [
    None, "", "zz-nothex", "00-xyz-abc-01", "00--­-01", "0" * 500,
    "00-" + "g" * 32 + "-" + "b" * 16 + "-01"])
def test_parse_garbage_degrades_to_none(garbage):
    assert both(lambda pkg: pkg.propagate.parse_traceparent(garbage)) is None


def _spellings(pkg):
    P = pkg.propagate
    ctx = P.SpanContext("ab" * 11, "cd" * 11)
    carrier = P.inject(ctx)
    return [carrier, tuple(P.extract(carrier)),
            tuple(P.extract({"traceparent": carrier["traceparent"]})),
            tuple(P.extract({"X-Trace": ctx.trace_id})),
            P.extract({}), P.to_env(ctx), P.from_env({})]


def test_inject_extract_header_spellings():
    rec = both(_spellings)
    assert rec[1] == rec[2] == ("ab" * 11, "cd" * 11)
    assert rec[3][0] == "ab" * 11 and rec[4] is None and rec[6] is None


def _orphans(pkg):
    spans = [{"span_id": "a", "parent_id": None},
             {"span_id": "b", "parent_id": "a"},
             {"span_id": "c", "parent_id": "missing"}]
    return [[s["span_id"] for s in pkg.propagate.orphan_spans(spans)],
            pkg.propagate.orphan_spans(spans, known_parents=("missing",))]


def test_orphan_spans():
    assert both(_orphans) == [["c"], []]


# -- one trace across HTTP, the split and the page store ----------------------

CFG_KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
              ffn_size=64, max_position=64, hidden_dropout=0.0,
              attention_dropout=0.0)


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    from paddle_tpu.generation.model import GPTConfig, build_lm_program

    d = str(tmp_path_factory.mktemp("torch_obs_lm"))
    main, startup, _feeds, fetches = build_lm_program(GPTConfig(**CFG_KW),
                                                      48)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(d, ["tokens"], [fetches["logits"]],
                                       exe, main)
    return d


def test_http_to_disagg_to_wire_one_trace(lm_dir, port_flags):
    """A traced HTTP /v1/generate against a split prefill/decode service
    over a TCP page store is ONE connected trace (the serving span, the
    handoff, both phases and the page-store RPCs under the caller's
    trace id, no orphans), served by /v1/admin/trace/<id> and assembled
    by ``assemble_trace``."""
    from paddle_tpu_torch.disagg import (DecodeWorker, DisaggService,
                                         PageStoreClient, PageStoreServer,
                                         PrefillWorker)
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.observability import assemble_trace
    from paddle_tpu_torch.serving import ServingEngine, ServingServer

    port_flags({"observability_tracing": True,
                "observability_flight_capacity": 2048})
    flight, propagate, tracing = PORT.flight, PORT.propagate, PORT.tracing
    flight.clear()
    cfg = GPTConfig(**CFG_KW)
    store_srv = PageStoreServer(page_size=4)
    kw = dict(page_size=4, num_pages=64, max_decode_batch=4, chunk_tokens=6)

    def pred():
        return create_predictor(Config(lm_dir), device="cpu")

    pf = PrefillWorker(pred(), cfg, PageStoreClient(
        store_srv.host, store_srv.port, page_size=4), **kw)
    dw = DecodeWorker(pred(), cfg, PageStoreClient(
        store_srv.host, store_srv.port, page_size=4), **kw)
    svc = DisaggService(prefill=[pf], decode=[dw])
    eng = ServingEngine(pred(), num_workers=1)
    srv = ServingServer(eng, port=0, generation_engine=svc)
    try:
        client = tracing.SpanContext(tracing._new_id(), tracing._new_id())
        prompt = [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14]
        req = urllib.request.Request(
            srv.address + "/v1/generate",
            data=json.dumps({"tokens": prompt, "max_new_tokens": 3,
                             "eos_id": None}).encode(),
            headers={"Content-Type": "application/json",
                     **propagate.inject(client)})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.headers["X-Trace"] == client.trace_id
            lines = [json.loads(ln) for ln in resp if ln.strip()]
        assert lines[0]["trace_id"] == client.trace_id
        assert lines[0]["index"] == 0 and "token" in lines[0]
        assert lines[-1]["trace_id"] == client.trace_id
        assert lines[-1]["request_id"]
        with urllib.request.urlopen(
                srv.address + f"/v1/admin/trace/{client.trace_id}",
                timeout=30) as r:
            local = json.loads(r.read())
        spans = local["spans"]
        names = {s["name"] for s in spans}
        assert {"serving/http_generate", "disagg/handoff",
                "disagg/prefill_phase", "disagg/decode_submit"} <= names
        assert any(n.startswith("pagestore/") for n in names)
        assert all(s["trace_id"] == client.trace_id for s in spans)
        assert all(s["pid"] == os.getpid() for s in spans)
        assert propagate.orphan_spans(
            spans, known_parents=(client.span_id,)) == []
        merged = assemble_trace(client.trace_id, [srv.address])
        assert len(merged["spans"]) == len(spans)
    finally:
        srv.close()
        eng.close()
        svc.close(drain=True)
        store_srv.close()
    for w in svc._prefill + svc._decode:
        w.engine.cache.check_integrity()
        assert w.engine.stats()["cache"]["pages_in_use"] == 0


def _unknown_trace(pkg, lm_dir):
    if pkg.name == "jax":
        from paddle_tpu.inference import Config, create_predictor
        from paddle_tpu.serving import ServingEngine, ServingServer
        pred = create_predictor(Config(lm_dir))
    else:
        from paddle_tpu_torch.inference import Config, create_predictor
        from paddle_tpu_torch.serving import ServingEngine, ServingServer
        pred = create_predictor(Config(lm_dir), device="cpu")
    eng = ServingEngine(pred, num_workers=1)
    srv = ServingServer(eng, port=0)
    try:
        try:
            urllib.request.urlopen(
                srv.address + "/v1/admin/trace/deadbeef", timeout=30)
            return None
        except urllib.error.HTTPError as e:
            body = json.loads(e.read())
            return [e.code, sorted(body), bool(body["request_id"]),
                    body["spans"], body["trace_id"]]
    finally:
        srv.close()
        eng.close()


def test_unknown_trace_is_404(lm_dir):
    assert both(_unknown_trace, lm_dir)[:3] == [
        404, ["host", "pid", "request_id", "spans", "trace_id"], True]


# -- fleet aggregation -------------------------------------------------------


def _serve_text(text, *, delay_s=0.0):
    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            if delay_s:
                time.sleep(delay_s)
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def test_parse_prometheus_text():
    text = ('# HELP x y\n# TYPE a counter\n'
            'a_total{cls="interactive",q="a\\"b"} 3\n'
            "plain 1.5\n"
            "broken{ 7\n")
    got = both(lambda pkg: pkg.fleet.parse_prometheus_text(text))
    names = {n: (lb, v) for n, lb, v in got}
    assert names["a_total"] == ({"cls": "interactive", "q": 'a\\"b'}, 3.0)
    assert names["plain"] == ({}, 1.5) and "broken" not in names


_TEXT1 = ('# TYPE paddle_x_total counter\npaddle_x_total 3\n'
          'paddle_traffic_completed_total{cls="interactive"} 100\n'
          'paddle_traffic_deadline_miss_total{cls="interactive"} 4\n'
          "paddle_generation_ttft_ms_p99 40\n")
_TEXT2 = ('paddle_x_total 5\n'
          'paddle_traffic_completed_total{cls="interactive"} 50\n'
          'paddle_traffic_deadline_miss_total{cls="interactive"} 1\n')


def _fleet_text(text):
    """Merged exposition with the scrape-time values (wall times) out."""
    return [line for line in text.splitlines()
            if not re.match(r"paddle_fleet_(last_scrape_ms|scrape_age_s|"
                            r"scrape_ms)", line)]


def _merge(pkg, urls):
    (u1, u2), F = urls, pkg.fleet
    agg = F.FleetAggregator(timeout_s=2.0, slo=F.SLOMonitor(
        budget=0.01, ttft_p99_ms=200.0, clock=lambda: 1000.0))
    agg.add_endpoint(u1, worker="prefill-0", phase="prefill")
    agg.add_endpoint(u2, worker="decode-0", phase="decode", rank=1)
    r = agg.scrape()
    vals = sorted((lb["worker"], v) for lb, v in agg.series("paddle_x_total"))
    text = _fleet_text(agg.to_prometheus_text(scrape=False))
    return [r["live"], r["stale"], vals, text]


def test_fleet_merges_labels_and_marks_dead_stale():
    """The merge of two fixed /metrics texts equals the JAX package's
    merge line for line ({worker=,phase=,rank=} labels, the fleet and
    SLO gauges); then a dead backend goes stale with its last-good
    samples kept."""
    s1, u1 = _serve_text(_TEXT1)
    s2, u2 = _serve_text(_TEXT2)
    try:
        live, stale, vals, text = both(_merge, (u1, u2))
        assert (live, stale) == (2, 0)
        assert vals == [("decode-0", 5.0), ("prefill-0", 3.0)]
        joined = "\n".join(text)
        assert ('paddle_x_total{phase="prefill",worker="prefill-0"} 3.0'
                in joined)
        assert "paddle_slo_deadline_miss_ratio" in joined
        agg = PORT.fleet.FleetAggregator(timeout_s=2.0)
        agg.add_endpoint(u1, worker="prefill-0", phase="prefill")
        agg.add_endpoint(u2, worker="decode-0", phase="decode", rank=1)
        agg.scrape()
        s2.shutdown()
        s2.server_close()
        r = agg.scrape()
        assert r["live"] == 1 and r["stale"] == 1
        got = {lb["worker"]: v for lb, v in agg.series("paddle_x_total")}
        assert got["decode-0"] == 5.0
        assert re.search(r'paddle_fleet_stale\{[^}]*worker="decode-0"'
                         r'[^}]*\} 1', agg.to_prometheus_text(scrape=False))
    finally:
        s1.shutdown()
        s1.server_close()


def test_fleet_scrape_bounded_by_hung_backend():
    s1, u1 = _serve_text("paddle_y 1\n")
    s2, u2 = _serve_text("paddle_y 2\n", delay_s=3.0)
    try:
        agg = PORT.fleet.FleetAggregator(timeout_s=0.5)
        agg.add_endpoint(u1, worker="ok")
        agg.add_endpoint(u2, worker="hung")
        t0 = time.monotonic()
        r = agg.scrape()
        assert time.monotonic() - t0 < 2.5   # the hang is cut at 0.5 s
        assert r["live"] == 1 and r["stale"] == 1
        assert {lb["worker"] for lb, _v in agg.series("paddle_y")} == {"ok"}
    finally:
        for s in (s1, s2):
            s.shutdown()
            s.server_close()


# -- SLO burn rate on a fake clock -------------------------------------------


def _burn(pkg):
    clk = {"t": 1000.0}
    dumps = []
    mon = pkg.fleet.SLOMonitor(budget=0.01, window_s=30.0,
                               burn_threshold=10.0, clock=lambda: clk["t"],
                               on_burn=dumps.append)
    tot = {"c": 0, "m": 0}
    trail = []

    def tick(completed, missed):
        clk["t"] += 10
        tot["c"] += completed
        tot["m"] += missed
        mon.record("interactive", completed_total=tot["c"],
                   deadline_missed_total=tot["m"])
        g = mon.gauges()
        trail.append({k: sorted((tuple(sorted(lb.items())), v)
                                for lb, v in g[k]) for k in sorted(g)})

    mon.record("interactive", completed_total=0, deadline_missed_total=0)
    tick(1000, 1)
    for _ in range(7):
        tick(100, 20)
    for _ in range(5):
        tick(100, 0)
    for _ in range(8):
        tick(100, 20)
    return [trail, dumps]


def _gauge(step, name, cls="interactive"):
    for lb, v in step[name]:
        if dict(lb).get("cls") == cls:
            return v
    raise KeyError((name, cls))


def test_slo_burn_math_and_latched_dump():
    """Miss ratio, burn and the sustained-burn latch tick for tick equal
    the JAX package's; one dump per sustained episode."""
    trail, dumps = both(_burn)
    assert _gauge(trail[0], "paddle_slo_deadline_miss_ratio") == \
        pytest.approx(0.001)
    assert _gauge(trail[0], "paddle_slo_error_budget_burn") == \
        pytest.approx(0.1)
    assert _gauge(trail[6], "paddle_slo_error_budget_burn") == \
        pytest.approx(20.0, rel=0.01)
    assert _gauge(trail[6], "paddle_slo_sustained_burn") == 1.0
    assert _gauge(trail[12], "paddle_slo_sustained_burn") == 0.0
    assert dumps == ["slo-burn-interactive", "slo-burn-interactive"]


def _targets(pkg):
    mon = pkg.fleet.SLOMonitor(ttft_p99_ms=200.0, itl_p99_ms=20.0,
                               clock=lambda: 0.0)
    mon.record("all", ttft_p99_ms=150.0, itl_p99_ms=30.0)
    g = mon.gauges()
    return {k: sorted((tuple(sorted(lb.items())), v) for lb, v in g[k])
            for k in sorted(g)}


def test_slo_latency_targets():
    g = both(_targets)
    assert _gauge(g, "paddle_slo_ttft_target_ratio", "all") == \
        pytest.approx(0.75)
    assert _gauge(g, "paddle_slo_itl_target_ratio", "all") == \
        pytest.approx(1.5)


def _ingest(pkg, url):
    F = pkg.fleet
    mon = F.SLOMonitor(budget=0.01, ttft_p99_ms=200.0, clock=lambda: 5.0)
    agg = F.FleetAggregator(slo=mon, timeout_s=2.0)
    agg.add_endpoint(url, worker="w0", phase="decode")
    return [line for line in _fleet_text(agg.to_prometheus_text())
            if line.startswith("paddle_slo_")]


def test_slo_ingests_fleet_scrape():
    s1, u1 = _serve_text(_TEXT1)
    try:
        lines = "\n".join(both(_ingest, u1))
        assert "paddle_slo_deadline_miss_ratio" in lines
        assert "paddle_slo_error_budget_burn" in lines
    finally:
        s1.shutdown()
        s1.server_close()


def test_fleet_snapshot_and_configure(tmp_path):
    """``configure_fleet`` / ``fleet_snapshot``: the process-default
    aggregator, JSON-clean, as the JAX package builds it."""
    s1, u1 = _serve_text(_TEXT2)
    try:
        out = []
        for pkg in (JAX, PORT):
            pkg.fleet.configure_fleet([{"url": u1, "worker": "w"}],
                                      timeout_s=2.0)
            snap = pkg.obs.fleet_snapshot()
            json.dumps(snap)
            out.append(sorted(snap))
            pkg.fleet.configure_fleet([])
        assert out[0] == out[1]
    finally:
        s1.shutdown()
        s1.server_close()
