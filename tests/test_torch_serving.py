"""The port's ServingEngine and ServingServer, on the CPU: twins of the
17 tests of tests/test_serving.py, with every output held to the JAX
predictor's on the same saved model; the HTTP generation tests of
tests/test_generation.py with tokens held to the JAX engine's; and the
surfaces left to ROADMAP A9 (501 answers, NotImplementedError).

Every server binds port 0 and is closed in ``finally`` (or a ``with``);
every thread is joined with a timeout. Deterministic coalescing uses
``ServingEngine(start=False)``: requests queue first, the batcher
starts after.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.generation import GenerationEngine as JaxEngine
from paddle_tpu.generation.model import GPTConfig as JaxGPTConfig
from paddle_tpu.generation.model import build_lm_program as jax_build_lm
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_create_predictor

from paddle_tpu_torch import set_flags
from paddle_tpu_torch.adapters import AdapterStore
from paddle_tpu_torch.generation import GenerationEngine
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.serving import (DeadlineExceeded, EngineClosed,
                                      Overloaded, RequestCancelled,
                                      ServingEngine, ServingError,
                                      ServingServer, StreamingHistogram)

RTOL, ATOL = 1e-5, 1e-6


def _export_static_model(path):
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), jfluid.unique_name.guard():
        x = jfluid.layers.data("x", [6])
        h = jfluid.layers.fc(x, 12, act="relu")
        out = jfluid.layers.fc(h, 3, act="softmax")
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(path, ["x"], [out], exe, main)


def _export_masked_model(path):
    """Mask-aware pooled classifier: padding cannot change its outputs,
    so coalesced results must equal solo ones."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), jfluid.unique_name.guard():
        ids = jfluid.layers.data("ids", [-1], dtype="int64")
        mask = jfluid.layers.data("mask", [-1], dtype="float32")
        emb = jfluid.layers.embedding(ids, size=[50, 8])
        m = jfluid.layers.unsqueeze(mask, [2])
        pooled = jfluid.layers.elementwise_div(
            jfluid.layers.reduce_sum(
                jfluid.layers.elementwise_mul(emb, m), dim=[1]),
            jfluid.layers.reduce_sum(m, dim=[1]))
        out = jfluid.layers.fc(pooled, 16, act="softmax")
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(path, ["ids", "mask"], [out], exe,
                                       main)


@pytest.fixture(scope="module")
def static_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_srv_static"))
    _export_static_model(d)
    return d


@pytest.fixture(scope="module")
def static_pred(static_dir):
    return create_predictor(Config(static_dir), device="cpu")


@pytest.fixture(scope="module")
def jax_static(static_dir):
    return jax_create_predictor(JaxConfig(static_dir))


@pytest.fixture(scope="module")
def masked_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_srv_masked"))
    _export_masked_model(d)
    return d


def _xv(seed=0, rows=1):
    return np.random.RandomState(seed).randn(rows, 6).astype("float32")


def _jax_out(jpred, feeds):
    return np.asarray(jpred.run(feeds)[0])


# -- coalescing -------------------------------------------------------------


def test_concurrent_requests_coalesce_into_one_batch(static_pred, jax_static):
    xv = _xv()
    oracle = _jax_out(jax_static, [xv])
    eng = ServingEngine(static_pred, max_batch_size=4, batch_timeout_ms=100,
                        num_workers=2, start=False)
    try:
        futs = [eng.submit({"x": xv}) for _ in range(4)]
        eng.start()
        for f in futs:
            (got,) = f.result(timeout=60)
            np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
        snap = eng.metrics.snapshot()
    finally:
        eng.close()
    assert snap["batches_total"] == 1, snap
    assert snap["batch_occupancy"]["max"] == 4
    assert snap["batch_occupancy"]["mean"] > 1
    assert snap["requests_total"] == snap["responses_total"] == 4


def test_threaded_clients_coalesce(static_pred, jax_static):
    xv = _xv(1)
    oracle = _jax_out(jax_static, [xv])
    eng = ServingEngine(static_pred, max_batch_size=8, batch_timeout_ms=150,
                        num_workers=2)
    barrier = threading.Barrier(8)
    errors = []

    def client(i):
        try:
            barrier.wait(timeout=30)
            (got,) = eng.predict({"x": xv}, timeout=60)
            np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
        except Exception as e:  # noqa: BLE001
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not [t for t in threads if t.is_alive()], "hung clients"
        assert not errors, errors
        snap = eng.metrics.snapshot()
    finally:
        eng.close()
    assert snap["responses_total"] == 8
    assert snap["batch_occupancy"]["max"] > 1, snap
    assert snap["batches_total"] < 8, snap


def test_bucketed_mixed_lengths_share_one_batch(masked_dir):
    cfg = Config(masked_dir)
    cfg.enable_shape_bucketing(seq_buckets=(32,), batch_buckets=(4, 8))
    pred = create_predictor(cfg, device="cpu")
    jref = jax_create_predictor(JaxConfig(masked_dir))
    rng = np.random.RandomState(0)
    reqs = []
    for length, rows in ((7, 1), (21, 2), (30, 1)):
        ids = rng.randint(1, 50, (rows, length)).astype("int64")
        mask = np.ones((rows, length), np.float32)
        reqs.append((ids, mask, _jax_out(jref, [ids, mask])))
    eng = ServingEngine(pred, max_batch_size=8, batch_timeout_ms=100,
                        num_workers=2, start=False)
    try:
        futs = [eng.submit({"ids": i, "mask": m}) for i, m, _ in reqs]
        eng.start()
        for (ids, mask, want), f in zip(reqs, futs):
            (got,) = f.result(timeout=60)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        snap = eng.metrics.snapshot()
        stats = eng.predictor_stats()
    finally:
        eng.close()
    assert snap["batches_total"] == 1, snap
    assert snap["batch_occupancy"]["max"] == 3
    assert snap["padding_waste"] > 0
    assert stats["runs"] == 1
    assert sum(stats["bucket_hits"].values()) == 1, stats


def test_per_token_outputs_keep_true_length_when_coalesced(tmp_path):
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), jfluid.unique_name.guard():
        ids = jfluid.layers.data("ids", [-1], dtype="int64")
        emb = jfluid.layers.embedding(ids, size=[50, 8])  # [B, L, 8]
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(str(tmp_path), ["ids"], [emb], exe,
                                       main)
    cfg = Config(str(tmp_path))
    cfg.enable_shape_bucketing(seq_buckets=(32,), batch_buckets=(4, 8))
    pred = create_predictor(cfg, device="cpu")
    jref = jax_create_predictor(JaxConfig(str(tmp_path)))
    rng = np.random.RandomState(0)
    reqs = []
    for length in (7, 21):
        a = rng.randint(1, 50, (2, length)).astype("int64")
        want = _jax_out(jref, [a])
        assert want.shape == (2, length, 8)
        reqs.append((a, want))
    eng = ServingEngine(pred, max_batch_size=8, batch_timeout_ms=100,
                        num_workers=1, start=False)
    try:
        futs = [eng.submit({"ids": a}) for a, _ in reqs]
        eng.start()
        for (a, want), f in zip(reqs, futs):
            (got,) = f.result(timeout=60)
            assert got.shape == want.shape, (got.shape, want.shape)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        snap = eng.metrics.snapshot()
    finally:
        eng.close()
    assert snap["batches_total"] == 1, snap


def test_incompatible_shapes_do_not_batch(static_pred, jax_static):
    good = _xv(2)
    eng = ServingEngine(static_pred, max_batch_size=8, batch_timeout_ms=50,
                        num_workers=1, start=False)
    try:
        f_good = eng.submit({"x": good})
        f_bad = eng.submit({"x": np.zeros((1, 4), "float32")})
        eng.start()
        (got,) = f_good.result(timeout=60)
        np.testing.assert_allclose(got, _jax_out(jax_static, [good]),
                                   rtol=RTOL, atol=ATOL)
        with pytest.raises(ServingError):
            f_bad.result(timeout=60)
        snap = eng.metrics.snapshot()
    finally:
        eng.close()
    assert snap["batches_total"] == 2
    assert snap["errors_total"] == 1
    assert snap["responses_total"] == 1


# -- admission control / deadlines / cancellation / drain -------------------


def test_queue_full_rejects_with_overloaded(static_pred):
    eng = ServingEngine(static_pred, max_batch_size=2, batch_timeout_ms=20,
                        queue_capacity=2, start=False)
    try:
        xv = _xv()
        eng.submit({"x": xv})
        eng.submit({"x": xv})
        with pytest.raises(Overloaded, match="queue full"):
            eng.submit({"x": xv})
        assert eng.metrics.snapshot()["rejected_total"] == 1
        eng.start()
    finally:
        eng.close(drain=True)
    assert eng.metrics.snapshot()["responses_total"] == 2


def test_deadline_expired_request_never_batched(static_pred):
    eng = ServingEngine(static_pred, max_batch_size=2, batch_timeout_ms=50,
                        start=False)
    try:
        fut = eng.submit({"x": _xv()}, deadline_ms=1)
        time.sleep(0.01)
        eng.start()
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=30)
    finally:
        eng.close()
    snap = eng.metrics.snapshot()
    assert snap["expired_total"] == 1
    assert snap["batches_total"] == 0


def test_generous_deadline_is_met(static_pred, jax_static):
    eng = ServingEngine(static_pred, max_batch_size=2, batch_timeout_ms=5)
    try:
        (got,) = eng.predict({"x": _xv(3)}, deadline_ms=60_000, timeout=60)
    finally:
        eng.close()
    assert got.shape == (1, 3)
    np.testing.assert_allclose(got, _jax_out(jax_static, [_xv(3)]),
                               rtol=RTOL, atol=ATOL)


def test_cancel_before_batching(static_pred):
    eng = ServingEngine(static_pred, max_batch_size=2, batch_timeout_ms=50,
                        start=False)
    try:
        fut = eng.submit({"x": _xv()})
        assert fut.cancel() is True
        assert fut.cancel() is False
        eng.start()
        with pytest.raises(RequestCancelled):
            fut.result(timeout=30)
    finally:
        eng.close()
    snap = eng.metrics.snapshot()
    assert snap["cancelled_total"] == 1
    assert snap["batches_total"] == 0


def test_drain_on_shutdown_completes_queued_requests(static_pred, jax_static):
    xv = _xv(4)
    oracle = _jax_out(jax_static, [xv])
    eng = ServingEngine(static_pred, max_batch_size=8, batch_timeout_ms=30,
                        num_workers=2)
    try:
        futs = [eng.submit({"x": xv}) for _ in range(5)]
    finally:
        eng.close(drain=True)
    for f in futs:
        (got,) = f.result(timeout=0)
        np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    with pytest.raises(EngineClosed):
        eng.submit({"x": xv})
    assert eng.metrics.snapshot()["responses_total"] == 5


def test_close_without_drain_fails_queued(static_pred):
    eng = ServingEngine(static_pred, max_batch_size=4, batch_timeout_ms=50,
                        start=False)
    futs = [eng.submit({"x": _xv()}) for _ in range(3)]
    eng.close(drain=False)
    for f in futs:
        with pytest.raises(EngineClosed):
            f.result(timeout=10)


def test_feed_validation(static_pred):
    eng = ServingEngine(static_pred, start=False)
    try:
        with pytest.raises(ValueError, match="mismatch"):
            eng.submit({"wrong_name": _xv()})
        with pytest.raises(ValueError, match="expected 1 feeds"):
            eng.submit([_xv(), _xv()])
    finally:
        eng.close()


# -- metrics ----------------------------------------------------------------


def test_streaming_histogram_quantiles():
    from paddle_tpu.serving import StreamingHistogram as JaxHistogram

    h, j = StreamingHistogram(), JaxHistogram()
    for v in range(1, 1001):
        h.record(float(v))
        j.record(float(v))
    s = h.snapshot()
    assert s == j.snapshot()
    assert s["count"] == 1000
    assert s["min"] == 1.0 and s["max"] == 1000.0
    assert abs(s["p50"] - 500) / 500 < 0.15, s
    assert abs(s["p99"] - 990) / 990 < 0.15, s
    assert s["p50"] <= s["p95"] <= s["p99"]
    assert StreamingHistogram().snapshot()["p99"] == 0.0


def test_metrics_snapshot_sane_and_json_serializable(static_pred):
    eng = ServingEngine(static_pred, max_batch_size=4, batch_timeout_ms=10)
    try:
        for i in range(6):
            eng.predict({"x": _xv(i)}, timeout=60)
        snap = eng.metrics.snapshot()
    finally:
        eng.close()
    json.dumps(snap)
    assert snap["requests_total"] == snap["responses_total"] == 6
    assert snap["rejected_total"] == snap["errors_total"] == 0
    assert snap["batches_total"] >= 1
    lat = snap["latency_ms"]
    assert lat["count"] == 6
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"]
    assert snap["queue_wait_ms"]["count"] == 6
    assert snap["queue_depth"] == 0
    assert 0 < snap["batch_fill"] <= 1.0
    json.dumps(eng.stats())


def test_predictor_bucket_hits_histogram(masked_dir):
    cfg = Config(masked_dir)
    cfg.enable_shape_bucketing(seq_buckets=(16, 32), pad_batch=False)
    pred = create_predictor(cfg, device="cpu")
    rng = np.random.RandomState(0)
    for length in (7, 11, 20):
        ids = rng.randint(1, 50, (2, length)).astype("int64")
        pred.run([ids, np.ones((2, length), np.float32)])
    st = pred.bucket_stats()
    assert sum(st["bucket_hits"].values()) == st["runs"] == 3
    assert len(st["bucket_hits"]) == st["compiled_shapes"] == 2
    assert st["bucket_hits"] == {"2,16|2,16": 2, "2,32|2,32": 1}
    assert pred.clone().bucket_stats()["bucket_hits"] == {}


# -- HTTP front end ---------------------------------------------------------


def _http(conn, method, path, payload=None, raw_body=None, headers=None):
    """One request/response on a keep-alive connection; always reads the
    body (an unread body poisons the next request)."""
    body = raw_body if raw_body is not None else (
        json.dumps(payload).encode() if payload is not None else None)
    h = {"Content-Type": "application/json"} if body is not None else {}
    h.update(headers or {})
    conn.request(method, path, body=body, headers=h)
    r = conn.getresponse()
    return r.status, r.read(), r


def test_http_endpoints(static_pred, jax_static):
    xv = _xv(7)
    oracle = _jax_out(jax_static, [xv])
    out_name = static_pred.get_output_names()[0]
    eng = ServingEngine(static_pred, max_batch_size=4, batch_timeout_ms=10)
    try:
        with ServingServer(eng) as srv:
            conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
            status, body, _ = _http(conn, "GET", "/healthz")
            assert status == 200 and json.loads(body)["status"] == "ok"

            status, body, r = _http(conn, "POST", "/v1/predict",
                                    {"inputs": {"x": xv.tolist()}},
                                    headers={"X-Request-Id": "rid-7"})
            assert status == 200
            assert r.getheader("X-Request-Id") == "rid-7"
            np.testing.assert_allclose(
                np.array(json.loads(body)["outputs"][out_name]), oracle,
                rtol=1e-5, atol=1e-5)

            status, body, _ = _http(conn, "GET", "/metrics")
            text = body.decode()
            assert status == 200
            # the unified registry, as the JAX server serves it: this
            # engine's series are labeled with its registry id
            eid = eng.metrics._obs_id
            assert f'paddle_serving_requests_total{{engine="{eid}"}} 1' in text
            assert f'paddle_serving_responses_total{{engine="{eid}"}} 1' \
                in text
            assert f'paddle_serving_latency_ms_p50{{engine="{eid}"}}' in text
            assert "paddle_serving_predictor_runs" in text

            status, body, r = _http(conn, "POST", "/v1/predict",
                                    raw_body=b"not json")
            assert status == 400
            assert json.loads(body)["request_id"] == \
                r.getheader("X-Request-Id")

            status, body, _ = _http(conn, "POST", "/v1/predict",
                                    {"inputs": {"x": xv.tolist()},
                                     "deadline_ms": "50"})
            assert status == 400
            assert "deadline_ms" in json.loads(body)["error"]

            status, _, _ = _http(conn, "GET", "/nope")
            assert status == 404

            eng.close(drain=True)
            status, body, _ = _http(conn, "GET", "/healthz")
            assert status == 503 and json.loads(body)["status"] == "draining"
            status, body, _ = _http(conn, "POST", "/v1/predict",
                                    {"inputs": {"x": xv.tolist()}})
            assert status == 503 and json.loads(body)["kind"] == "closed"
            conn.close()
    finally:
        eng.close()


def test_http_deadline_maps_to_504(static_pred):
    eng = ServingEngine(static_pred, max_batch_size=2, batch_timeout_ms=40,
                        start=False)  # never started: queued forever
    try:
        with ServingServer(eng) as srv:
            conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
            status, body, _ = _http(conn, "POST", "/v1/predict",
                                    {"inputs": {"x": _xv().tolist()},
                                     "deadline_ms": 5, "timeout_s": 0.5})
            assert status == 504
            assert json.loads(body)["kind"] == "deadline"
            conn.close()
    finally:
        eng.close()


def test_http_overloaded_is_503_with_retry_after(static_pred):
    eng = ServingEngine(static_pred, queue_capacity=1, start=False)
    try:
        eng.submit({"x": _xv()})
        with ServingServer(eng) as srv:
            conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
            status, body, r = _http(conn, "POST", "/v1/predict",
                                    {"inputs": {"x": _xv().tolist()}})
            assert status == 503
            assert json.loads(body)["kind"] == "overloaded"
            assert int(r.getheader("Retry-After")) >= 1
            conn.close()
    finally:
        eng.close(drain=False)


def test_host_tier_surfaces_name_a9(static_pred, tmp_path):
    """The host-tier surfaces that used to be refused naming A9 now
    construct and answer: every argument builds a server, and every
    endpoint answers as the JAX server does without a fleet attached
    (see test_host_tier_surface_matches_jax for each case against it)."""
    from paddle_tpu_torch.observability import FleetAggregator
    from paddle_tpu_torch.traffic import TrafficController

    set_flags({"observability_dump_dir": str(tmp_path)})
    eng = ServingEngine(static_pred, start=False)
    ctl = TrafficController(eng, start=False)
    try:
        for kw in ({"traffic": ctl}, {"fleet": FleetAggregator()},
                   {"phase": "prefill"}, {"reuse_port": True}):
            ServingServer(eng, **kw).close()
        with ServingServer(eng) as srv:
            conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
            for method, path, code in (("GET", "/metrics/fleet", 404),
                                       ("GET", "/v1/admin/trace/abc", 404),
                                       ("POST", "/v1/admin/flight/dump", 200)):
                status, body, _ = _http(conn, method, path,
                                        {} if method == "POST" else None)
                assert status == code, path
                assert "A9" not in body.decode()
            conn.close()
    finally:
        set_flags({"observability_dump_dir": ""})
        ctl.close(drain=False)
        eng.close()


def _surface(pkg, pred, case, tmp):
    """Serve ``pred`` through ``pkg``'s ServingServer set up for one
    host-tier case; returns what the case's requests answered: status
    codes and the parts of the bodies both packages must agree on."""
    if pkg == "jax":
        from paddle_tpu import flags as jflags
        from paddle_tpu.observability import FleetAggregator
        from paddle_tpu.serving import ServingEngine as Eng
        from paddle_tpu.serving import ServingServer as Srv
        from paddle_tpu.traffic import TrafficController as Ctl
        set_f = jflags.set_flags
    else:
        from paddle_tpu_torch.observability import FleetAggregator
        from paddle_tpu_torch.traffic import TrafficController as Ctl
        Eng, Srv, set_f = ServingEngine, ServingServer, set_flags
    set_f({"observability_dump_dir": str(tmp / pkg)})
    eng = Eng(pred, max_batch_size=4, batch_timeout_ms=5)
    extra = []
    kw = {}
    if case == "traffic":
        kw["traffic"] = Ctl(eng)
        extra.append(kw["traffic"])
    elif case == "fleet":
        kw["fleet"] = FleetAggregator(timeout_s=2.0)
    elif case == "phase":
        kw["phase"] = "prefill"
    elif case == "reuse_port":
        kw["reuse_port"] = True
    out = {}
    try:
        with Srv(eng, **kw) as srv:
            if case == "reuse_port":
                # a sibling binds the same port
                extra.append(Srv(eng, port=srv.port, reuse_port=True))
            if case == "fleet":
                kw["fleet"].add_endpoint(srv.address, worker="self",
                                         phase="both")
            conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
            xv = _xv(3)
            if case in ("traffic", "reuse_port", "phase"):
                status, body, r = _http(
                    conn, "POST", "/v1/predict",
                    {"inputs": {"x": xv.tolist()}},
                    headers={"X-Tenant": "alice", "X-Priority": "batch"})
                out["predict"] = (status, np.asarray(
                    next(iter(json.loads(body)["outputs"].values()))))
            if case == "traffic":
                status, body, _ = _http(conn, "GET", "/healthz")
                out["health"] = sorted(json.loads(body)["traffic"])
            if case == "phase":
                status, body, _ = _http(conn, "GET", "/healthz")
                out["phase"] = (status, json.loads(body).get("phase"))
            if case in ("fleet", "no_fleet"):
                status, body, _ = _http(conn, "GET", "/metrics/fleet")
                names = set()
                if status == 200:
                    for line in body.decode().splitlines():
                        if line.startswith("paddle_fleet_") or \
                                line.startswith("paddle_slo_"):
                            names.add(line.split("{")[0].split(" ")[0])
                out["fleet"] = (status, sorted(names))
            if case == "trace":
                status, body, _ = _http(conn, "GET", "/v1/admin/trace/abc")
                out["trace"] = (status, sorted(json.loads(body)))
            if case == "flight":
                status, body, _ = _http(conn, "POST",
                                        "/v1/admin/flight/dump", {})
                got = json.loads(body)
                with open(got["path"]) as f:
                    dumped = json.load(f)
                out["flight"] = (status, sorted(got),
                                 dumped["reason"].startswith("admin:"),
                                 sorted(dumped))
            conn.close()
    finally:
        for x in extra:
            x.close()
        eng.close()
        set_f({"observability_dump_dir": ""})
    return out


@pytest.mark.parametrize("case", ["traffic", "fleet", "phase", "reuse_port",
                                  "no_fleet", "trace", "flight"])
def test_host_tier_surface_matches_jax(static_pred, jax_static, tmp_path,
                                       case):
    """One case per argument (traffic=, fleet=, phase=, reuse_port=) and
    per endpoint (/metrics/fleet without a fleet, /v1/admin/trace/<id>,
    /v1/admin/flight/dump) that used to be refused: the port answers as
    the JAX server does. Outputs within 1e-5; the flight dump's keys,
    ``compile_events`` included."""
    want = _surface("jax", jax_static, case, tmp_path)
    got = _surface("torch", static_pred, case, tmp_path)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if k == "predict":
            assert g[0] == w[0] == 200
            np.testing.assert_allclose(g[1], w[1], rtol=1e-5, atol=1e-5)
        elif k == "flight":
            assert g[:3] == w[:3]
            assert set(g[3]) == set(w[3])
        else:
            assert g == w, k


# -- HTTP /v1/generate --------------------------------------------------------

GEN_KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
              ffn_size=64, max_position=64, hidden_dropout=0.0,
              attention_dropout=0.0)
GEN_SEQ = 48


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_srv_lm"))
    main, startup, _f, fetches = jax_build_lm(JaxGPTConfig(**GEN_KW), GEN_SEQ)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(d, ["tokens"], [fetches["logits"]],
                                       exe, main)
    return d


@pytest.fixture(scope="module")
def lm_pred(lm_dir):
    return create_predictor(Config(lm_dir), device="cpu")


def _gen_engine(pred, **kw):
    return GenerationEngine(pred, pred.gpt_config, page_size=4, num_pages=64,
                            max_decode_batch=4, chunk_tokens=6, **kw)


def _jax_tokens(lm_dir, prompts, n):
    jpred = jax_create_predictor(JaxConfig(lm_dir))
    with JaxEngine(jpred, JaxGPTConfig(**GEN_KW), page_size=4, num_pages=64,
                   max_decode_batch=4, chunk_tokens=6) as jeng:
        return [jeng.generate(p, max_new_tokens=n, timeout=300)
                for p in prompts]


def _read_stream(resp):
    lines = []
    for raw in resp:
        if raw.strip():
            lines.append(json.loads(raw))
    return lines


def test_http_generate_streams_before_done(lm_dir, lm_pred):
    prompts = [[5, 17, 3, 40, 8, 2, 9], [11, 4, 60]]
    want = _jax_tokens(lm_dir, prompts, 10)
    serve = ServingEngine(lm_pred, start=False)
    eng = _gen_engine(lm_pred)
    srv = ServingServer(serve, generation_engine=eng)
    try:
        for p, w in zip(prompts, want):
            conn = http.client.HTTPConnection(srv.host, srv.port, timeout=300)
            conn.request("POST", "/v1/generate", json.dumps(
                {"tokens": p, "max_new_tokens": 10}),
                {"Content-Type": "application/json",
                 "X-Request-Id": "gen-1"})
            resp = conn.getresponse()
            assert resp.status == 200
            assert resp.getheader("Content-Type") == "application/x-ndjson"
            assert resp.getheader("X-Request-Id") == "gen-1"
            first = json.loads(resp.readline())
            # the first token arrives while the engine still serves
            assert first["index"] == 0 and first["token"] == w[0]
            assert first["request_id"] == "gen-1"
            assert not eng.closed
            lines = [first] + _read_stream(resp)
            conn.close()
            tail = lines[-1]
            assert tail["done"] and tail["finish_reason"] == "length"
            assert tail["n_tokens"] == 10
            assert tail["usage"]["prompt_tokens"] == len(p)
            assert tail["request_id"] == "gen-1"
            assert [ln["token"] for ln in lines[:-1]] == w
    finally:
        srv.close()
        serve.close()
        eng.close()


def test_http_generate_nonstream_and_errors(lm_dir, lm_pred):
    (want,) = _jax_tokens(lm_dir, [[3, 4, 5]], 4)
    serve = ServingEngine(lm_pred, start=False)
    eng = _gen_engine(lm_pred)
    srv = ServingServer(serve, generation_engine=eng)
    try:
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=300)
        status, body, _ = _http(conn, "POST", "/v1/generate",
                                {"tokens": [3, 4, 5], "max_new_tokens": 4,
                                 "stream": False})
        body = json.loads(body)
        assert status == 200 and body["tokens"] == want
        assert body["finish_reason"] == "length"
        status, _, _ = _http(conn, "POST", "/v1/generate", {"tokens": []})
        assert status == 400
        status, _, _ = _http(conn, "POST", "/v1/generate",
                             {"tokens": [1], "deadline_ms": "soon"})
        assert status == 400
        # no adapter store: an adapter request is a client error
        status, body, _ = _http(conn, "POST", "/v1/generate",
                                {"tokens": [1, 2], "max_new_tokens": 4,
                                 "adapter": "ad0"})
        assert status == 400 and "no adapter store" in \
            json.loads(body)["error"]
        status, body, _ = _http(conn, "POST", "/v1/admin/adapters",
                                {"adapter_id": "ad0", "factors": {}})
        assert status == 404
        # "base" names the base model, not an adapter
        status, body, _ = _http(conn, "POST", "/v1/generate",
                                {"tokens": [3, 4, 5], "max_new_tokens": 4,
                                 "stream": False, "model": "base"})
        assert status == 200 and json.loads(body)["tokens"] == want
        status, body, _ = _http(conn, "GET", "/healthz")
        assert json.loads(body)["models"]["base"]["version"] == "base"
        status, body, _ = _http(conn, "GET", "/metrics")
        assert "paddle_generation_responses_total" in body.decode()
        conn.close()
    finally:
        srv.close()
        serve.close()
        eng.close()


def test_http_generate_404_without_engine(lm_pred):
    serve = ServingEngine(lm_pred, start=False)
    srv = ServingServer(serve)
    try:
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
        status, _, _ = _http(conn, "POST", "/v1/generate",
                             {"tokens": [1, 2]})
        assert status == 404
        conn.close()
    finally:
        srv.close()
        serve.close()


def _factors(store, rank, seed):
    rng = np.random.RandomState(seed)
    return {t: ((rng.randn(k, rank) * 0.05).astype(np.float32),
                (rng.randn(rank, n) * 0.05).astype(np.float32))
            for t, (k, n) in sorted(store.targets.items())}


def test_http_adapter_admin_and_routing(lm_pred):
    """Upload over HTTP equals an in-process upload of the same factors,
    row for row; 404 for an unknown adapter; evict is 409 while pinned
    and 200 after; the deadline 504 and the slow-reader cancel."""
    store = AdapterStore.for_model(lm_pred.lm, rank_buckets=(8, 16),
                                   slots_per_bucket=2)
    serve = ServingEngine(lm_pred, start=False)
    eng = _gen_engine(lm_pred, adapter_store=store, start=False)
    srv = ServingServer(serve, generation_engine=eng)
    try:
        fac = _factors(store, 8, 3)
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=300)
        status, body, _ = _http(conn, "POST", "/v1/admin/adapters", {
            "adapter_id": "http-ad", "alpha": 16.0,
            "factors": {t: {"a": a.tolist(), "b": b.tolist()}
                        for t, (a, b) in fac.items()}})
        assert status == 200, body
        assert json.loads(body)["uploaded"]["id"] == "http-ad"
        store.upload("local-ad", fac, alpha=16.0)
        status, body, _ = _http(conn, "POST", "/v1/admin/adapters",
                                {"adapter_id": "x", "factors": "nope"})
        assert status == 400
        # pinned by a queued request (the loop is not started yet)
        pinned = eng.submit([3, 4, 5], max_new_tokens=4, adapter="http-ad")
        status, body, _ = _http(conn, "POST", "/v1/admin/adapters/evict",
                                {"adapter_id": "http-ad"})
        assert status == 409 and json.loads(body)["kind"] == "in_use"
        eng.start()
        got_pinned = pinned.result(timeout=300)
        outs = {}
        for aid, hdr in (("http-ad", {}), ("local-ad", {}),
                         (None, {"X-Adapter": "local-ad"})):
            payload = {"tokens": [3, 4, 5], "max_new_tokens": 4,
                       "stream": False}
            if aid is not None:
                payload["adapter"] = aid
            status, body, _ = _http(conn, "POST", "/v1/generate", payload,
                                    headers=hdr)
            assert status == 200, body
            outs[aid or "header"] = json.loads(body)["tokens"]
        assert outs["http-ad"] == outs["local-ad"] == outs["header"] \
            == got_pinned
        status, body, _ = _http(conn, "POST", "/v1/generate",
                                {"tokens": [1, 2], "max_new_tokens": 4,
                                 "adapter": "ghost"})
        assert status == 404 and json.loads(body)["kind"] == "adapter"
        status, body, _ = _http(conn, "POST", "/v1/admin/adapters/evict",
                                {"adapter_id": "http-ad"})
        assert status == 200 and json.loads(body)["evicted"]["id"] == \
            "http-ad"
        status, body, _ = _http(conn, "POST", "/v1/admin/adapters/evict",
                                {"adapter_id": "http-ad"})
        assert status == 404
        # a deadline that passes before the first token
        status, body, _ = _http(conn, "POST", "/v1/generate",
                                {"tokens": [3, 4, 5], "max_new_tokens": 40,
                                 "stream": False, "deadline_ms": 0.001})
        assert status == 504 and json.loads(body)["kind"] == "deadline"
        conn.close()
    finally:
        srv.close()
        serve.close()
        eng.close()


def test_http_generate_slow_reader_is_cancelled():
    """A client that stops reading a long stream hits the write timeout:
    its sequence is cancelled before its budget and its pages return to
    the pool, while the engine serves on."""
    import socket

    from paddle_tpu_torch.generation.model import GPTLM
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(**dict(GEN_KW, max_position=1024))
    rng = np.random.RandomState(0)
    params = {n: (rng.randn(*p.shape) * 0.05).astype(np.float32)
              for n, p in GPTLM(cfg, "meta").jax_params().items()}
    pred = create_predictor(Config().set_params(cfg, params), device="cpu")
    serve = ServingEngine(pred, start=False)
    eng = GenerationEngine(pred, cfg, page_size=16, num_pages=80,
                           max_decode_batch=2, chunk_tokens=6)
    srv = ServingServer(serve, generation_engine=eng,
                        stream_write_timeout_s=0.2, sndbuf=1024)
    sock = None
    try:
        sock = socket.socket()
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1024)
        sock.settimeout(30)
        sock.connect((srv.host, srv.port))
        body = json.dumps({"tokens": [3, 4, 5], "max_new_tokens": 1000})
        sock.sendall((f"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n{body}").encode())
        sock.recv(256)          # the headers and a first token, then stall
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            st = eng.stats()
            if st["cancelled_total"] >= 1 and \
                    st["cache"]["pages_in_use"] == 0:
                break
            time.sleep(0.05)
        st = eng.stats()
        assert st["cancelled_total"] == 1, st
        assert st["cache"]["pages_in_use"] == 0
        assert st["decode_tokens_total"] < 1000
        # the engine serves on
        assert len(eng.generate([7, 8], max_new_tokens=3, timeout=60)) == 3
    finally:
        if sock is not None:
            sock.close()
        srv.close()
        serve.close()
        eng.close()


def test_serving_flags_are_the_references():
    from paddle_tpu import flags as jflags

    from paddle_tpu_torch import flags

    for k in ("serving_max_batch_size", "serving_batch_timeout_ms",
              "serving_queue_capacity", "serving_num_workers",
              "traffic_stream_write_timeout_s"):
        assert flags.flag(k) == jflags.flag(k), k
    set_flags({"serving_num_workers": 3})
    try:
        eng = ServingEngine.__new__(ServingEngine)
        assert flags.flag("serving_num_workers") == 3
        del eng
    finally:
        set_flags({"serving_num_workers": 2})
