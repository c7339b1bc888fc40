"""The traffic tier of the port (``paddle_tpu_torch.traffic``) held to the
JAX package's (``paddle_tpu.traffic``): a twin of ``tests/test_traffic.py``.

Every deterministic case is a *scenario*: one function that drives a
controller through the JAX test's steps on an injected fake clock and a
fake engine (futures completed by the test), and returns what the
controller decided: shed kinds, dispatch order, Retry-After values,
stats. The scenario runs once against each package; the port must make
the JAX package's decisions exactly (floats within 1e-9), and the JAX
test's own expectations are asserted on the port's record.

The HTTP cases run the real stack on the CPU (a tiny MLP saved by the
JAX package and loaded by both, and a tiny LM of seeded weights for the
stalled-client case), and the ``WorkerPool`` case spawns two CPU workers
behind SO_REUSEPORT through a zero-drop rolling restart.
"""

import json
import socket
import threading
import time
import types

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

TOL = 1e-9


def _pkg(name):
    """The names a scenario needs, from one package."""
    if name == "jax":
        from paddle_tpu import observability, traffic
        from paddle_tpu.serving import DeadlineExceeded, RequestCancelled
        from paddle_tpu.serving.metrics import ServingMetrics
        flags = jfluid
    else:
        from paddle_tpu_torch import observability, traffic
        from paddle_tpu_torch.serving import (DeadlineExceeded,
                                              RequestCancelled)
        from paddle_tpu_torch.serving.metrics import ServingMetrics
        flags = tfluid
    return types.SimpleNamespace(
        name=name, traffic=traffic, observability=observability,
        DeadlineExceeded=DeadlineExceeded,
        RequestCancelled=RequestCancelled, ServingMetrics=ServingMetrics,
        get_flags=flags.get_flags, set_flags=flags.set_flags)


JAX, PORT = _pkg("jax"), _pkg("torch")


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
        assert b == pytest.approx(a, abs=TOL), (path, a, b)
    else:
        assert a == b, (path, a, b)


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on each package; the records must be
    equal. Returns the port's record."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    _same(want, got)
    return got


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakeFuture:
    """Mirrors the ServingFuture completion contract."""

    def __init__(self):
        self._ev = threading.Event()
        self._cbs = []
        self._res = None
        self._err = None

    def complete(self, result=None, error=None):
        self._res, self._err = result, error
        self._ev.set()
        for cb in self._cbs:
            cb(self)

    def add_done_callback(self, fn):
        if self._ev.is_set():
            fn(self)
        else:
            self._cbs.append(fn)

    def result(self, timeout=None):
        if not self._ev.wait(timeout):
            raise TimeoutError
        if self._err is not None:
            raise self._err
        return self._res

    def exception(self, timeout=None):
        self._ev.wait(timeout)
        return self._err

    def cancel(self):
        return False


class FakeEngine:
    """The ServingEngine submit contract, completion owned by the test:
    ``submitted`` records (feed, future) in dispatch order."""

    max_batch_size = 4
    num_workers = 1
    batch_timeout_s = 0.002
    queue_capacity = 64

    def __init__(self, pkg):
        self.metrics = pkg.ServingMetrics()
        self.submitted = []

    def submit(self, feed, deadline_ms=None):
        fut = FakeFuture()
        self.submitted.append((feed, fut))
        return fut


def _controller(pkg, clock=None, **cfg_kw):
    T = pkg.traffic
    cfg = T.TrafficConfig(**cfg_kw) if cfg_kw else T.TrafficConfig()
    eng = FakeEngine(pkg)
    ctl = T.TrafficController(eng, config=cfg, start=False,
                              clock=clock or time.monotonic)
    # no estimate unless a scenario sets one: the process-wide step
    # telemetry the estimator reads holds whatever steps earlier tests
    # in this process ran
    ctl.estimator.predict_service_ms = lambda: None
    return ctl, eng


def _shed(fn):
    """(kind, retry_after_s) of the TrafficShed ``fn`` raises."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the record holds the kind
        return [type(e).__name__, getattr(e, "kind", None),
                getattr(e, "retry_after_s", None)]
    return None


def _stats(ctl):
    st = ctl.stats()
    keep = ("admitted", "shed", "goodput", "deadline_miss", "aged_total",
            "deadline_miss_ratio", "slo_dumps_total", "max_inflight")
    return {k: st[k] for k in keep if k in st}


# -- admission primitives ----------------------------------------------------


def _bucket(pkg):
    clk = FakeClock()
    b = pkg.traffic.TokenBucket(rate=10.0, burst=2.0, clock=clk)
    rec = [b.try_take(), b.try_take(), b.try_take(), b.time_until()]
    clk.advance(0.1)
    rec += [b.try_take(), b.try_take()]
    clk.advance(10.0)
    rec.append(b.available())
    unl = pkg.traffic.TokenBucket(0.0, clock=clk)
    rec += [unl.try_take(), unl.time_until()]
    return rec


def test_token_bucket_semantics_fake_clock():
    rec = both(_bucket)
    assert rec[:3] == [True, True, False]
    assert rec[3] == pytest.approx(0.1)
    assert rec[4:6] == [True, False]
    assert rec[6] == pytest.approx(2.0)
    assert rec[7:] == [True, 0.0]


def _parse(pkg):
    T = pkg.traffic
    specs = T.parse_tenants("alice=100:200, bob=50")
    rec = [[specs["alice"].rate, specs["alice"].burst],
           [specs["bob"].rate, specs["bob"].burst], T.parse_tenants("")]
    for bad in ("alice=1,bogus", "=5", "a=fast"):
        try:
            T.parse_tenants(bad)
            rec.append(None)
        except ValueError as e:
            rec.append(str(e))
    q = T.parse_adapter_quotas("alice:summarize=10:20,*:translate=5")
    rec.append(sorted((k, v.rate, v.burst) for k, v in q.items()))
    return rec


def test_parse_tenants_syntax_and_diagnostics():
    rec = both(_parse)
    assert rec[0] == [100.0, 200.0] and rec[1] == [50.0, None]
    assert rec[2] == {}
    assert "entry 1" in rec[3] and "empty tenant name" in rec[4]
    assert "must be numbers" in rec[5]


def _queues(pkg):
    q = pkg.traffic.ClassQueues(capacity=2)
    rec = [q.push("interactive", "a", 1), q.push("interactive", "b", 2),
           q.push("interactive", "a", 3), q.push("batch", "a", 4),
           q.depth("interactive"), q.depth(), sorted(q.heads()),
           q.pop("interactive", "a"), q.remove(2), q.remove(2), q.drain(),
           q.depth()]
    return rec


def test_class_queues_bounded_per_class_and_fifo_per_tenant():
    rec = both(_queues)
    assert rec[:6] == [True, True, False, True, 2, 3]
    assert ("interactive", "a", 1) in rec[6] and ("batch", "a", 4) in rec[6]
    assert rec[7:] == [1, True, False, [4], 0]


def _config(pkg):
    names = ["traffic_queue_capacity", "traffic_tenants", "traffic_aging_ms"]
    old = pkg.get_flags(names)
    pkg.set_flags({"traffic_queue_capacity": 17, "traffic_tenants": "t1=7:9",
                   "traffic_aging_ms": 123.0})
    try:
        cfg = pkg.traffic.TrafficConfig.from_flags()
        rec = [cfg.queue_capacity, cfg.tenants["t1"].rate, cfg.aging_ms,
               pkg.traffic.TrafficConfig.from_flags(
                   queue_capacity=3).queue_capacity]
        d = pkg.traffic.TrafficConfig.from_flags(tenants={})
        rec.append([d.default_rate, d.default_burst, d.shed_headroom,
                    d.max_inflight, d.slo_miss_threshold, d.slo_window_s])
    finally:
        pkg.set_flags(old)
    return rec


def test_config_from_flags_round_trip():
    rec = both(_config)
    assert rec[:4] == [17, 7.0, 123.0, 3]


# -- controller: quota, queueing, priority, aging ----------------------------


def _quota(pkg):
    clk = FakeClock()
    T = pkg.traffic
    ctl, eng = _controller(
        pkg, clock=clk, queue_capacity=8,
        tenants={"bob": T.TenantSpec("bob", rate=2.0, burst=1.0)})
    ctl.submit({"x": 1}, tenant="bob")
    rec = [_shed(lambda: ctl.submit({"x": 2}, tenant="bob")),
           ctl.queue_depths(), len(eng.submitted), _stats(ctl)]
    ctl.close(drain=False)
    return rec


def test_quota_shed_raises_with_refill_retry_after():
    rec = both(_quota)
    assert rec[0][:2] == ["TrafficShed", "quota"]
    assert rec[0][2] == pytest.approx(0.5)
    assert rec[1]["batch"] == 1 and rec[2] == 0
    assert rec[3]["shed"] == {"batch/bob/quota": 1}


def _queue_full(pkg):
    ctl, eng = _controller(pkg, queue_capacity=2)
    ctl.submit({"x": 1})
    ctl.submit({"x": 2})
    rec = [_shed(lambda: ctl.submit({"x": 3})), len(eng.submitted)]
    ctl.close(drain=False)
    return rec


def test_queue_full_sheds_before_engine():
    rec = both(_queue_full)
    assert rec[0][1] == "queue_full" and rec[0][2] > 0 and rec[1] == 0


def _priority(pkg):
    ctl, eng = _controller(pkg, queue_capacity=16)
    ctl.submit({"id": "be"}, priority="best_effort")
    ctl.submit({"id": "b"}, priority="batch")
    ctl.submit({"id": "i"}, priority="interactive")
    rec = [ctl.pump(3), [f["id"] for f, _ in eng.submitted]]
    ctl.close(drain=False)
    return rec


def test_strict_priority_dispatch_order():
    assert both(_priority) == [3, ["i", "b", "be"]]


def _unknown_priority(pkg):
    ctl, eng = _controller(pkg, queue_capacity=8)
    ctl.submit({"x": 1}, priority="urgent!!")
    rec = ctl.queue_depths()
    ctl.close(drain=False)
    return rec


def test_unknown_priority_admits_as_batch():
    assert both(_unknown_priority) == {"interactive": 0, "batch": 1,
                                       "best_effort": 0}


def _aging(pkg):
    clk = FakeClock()
    ctl, eng = _controller(pkg, clock=clk, queue_capacity=16, aging_ms=100.0)
    ctl.submit({"id": "be-old"}, priority="best_effort")
    clk.advance(0.25)
    ctl.submit({"id": "b-fresh"}, priority="batch")
    ctl.submit({"id": "i-fresh"}, priority="interactive")
    rec = [ctl.pump(3), [f["id"] for f, _ in eng.submitted], _stats(ctl)]
    ctl.close(drain=False)
    return rec


def test_aging_prevents_starvation_without_priority_inversion():
    rec = both(_aging)
    assert rec[:2] == [3, ["i-fresh", "be-old", "b-fresh"]]
    assert rec[2]["aged_total"] == 1


def _cancel(pkg):
    ctl, eng = _controller(pkg, queue_capacity=8)
    t = ctl.submit({"x": 1})
    rec = [t.cancel(), type(t.exception(0.1)).__name__, ctl.pump(2),
           len(eng.submitted)]
    ctl.close(drain=False)
    return rec


def test_cancel_while_queued_never_dispatches():
    assert both(_cancel) == [True, "RequestCancelled", 0, 0]


# -- deadline-aware shedding -------------------------------------------------


def _infeasible(pkg):
    clk = FakeClock()
    ctl, eng = _controller(pkg, clock=clk, queue_capacity=8,
                           shed_headroom=1.5)
    ctl.estimator.predict_service_ms = lambda: 40.0
    rec = [_shed(lambda: ctl.submit({"x": 1}, deadline_ms=30.0)),
           ctl.queue_depths()]
    t = ctl.submit({"x": 2}, deadline_ms=70.0)
    clk.advance(0.05)
    rec.append(ctl.pump(1))
    err = t.exception(1.0)
    rec += [type(err).__name__, err.kind, err.retry_after_s,
            "in queue" in str(err), len(eng.submitted)]
    series = ctl.metrics.collect()
    rec.append(series["paddle_traffic_shed_before_batch_total"][0][1])
    rec.append(sum(v for _, v in series["paddle_traffic_shed_total"]))
    ctl.close(drain=False)
    return rec


def test_infeasible_deadline_sheds_before_batch_slot():
    rec = both(_infeasible)
    assert rec[0][1] == "infeasible" and rec[0][2] > 0
    assert rec[1] == {"interactive": 0, "batch": 0, "best_effort": 0}
    assert rec[2:5] == [1, "TrafficShed", "infeasible"]
    assert rec[6] is True and rec[7] == 0      # zero batch slots spent
    assert rec[8] == rec[9] == 2


def _feasible(pkg):
    clk = FakeClock()
    ctl, eng = _controller(pkg, clock=clk, queue_capacity=8)
    ctl.estimator.predict_service_ms = lambda: 5.0
    t = ctl.submit({"x": 1}, deadline_ms=500.0)
    clk.advance(0.1)
    rec = [ctl.pump(1), len(eng.submitted)]
    eng.submitted[0][1].complete(result=[np.zeros(2)])
    rec += [list(t.result(1.0)[0].shape), _stats(ctl)]
    ctl.close(drain=False)
    return rec


def test_feasible_deadline_dispatches_with_remaining_budget():
    rec = both(_feasible)
    assert rec[:3] == [1, 1, [2]]
    assert rec[3]["goodput"] == {"batch/default": 1}
    assert rec[3]["deadline_miss"] == {}


def _no_estimate(pkg):
    ctl, eng = _controller(pkg, queue_capacity=8)
    ctl.estimator.predict_service_ms = lambda: None
    ctl.submit({"x": 1}, deadline_ms=1.0)
    rec = [ctl.pump(1), len(eng.submitted)]
    ctl.close(drain=False)
    return rec


def test_no_estimate_means_no_shedding():
    assert both(_no_estimate) == [1, 1]


def _late(pkg):
    clk = FakeClock()
    ctl, eng = _controller(pkg, clock=clk, queue_capacity=8)
    t = ctl.submit({"x": 1}, deadline_ms=50.0)
    rec = [ctl.pump(1)]
    clk.advance(0.2)
    eng.submitted[0][1].complete(result=[1])
    t.result(1.0)
    rec.append(_stats(ctl))
    ctl.close(drain=False)
    return rec


def test_late_completion_counts_as_deadline_miss():
    rec = both(_late)
    assert rec[1]["deadline_miss"] == {"batch/default": 1}
    assert rec[1]["goodput"] == {}


# -- SLO breach -> flight dump -----------------------------------------------


def _breach(pkg, tmp):
    old = pkg.get_flags(["observability_dump_dir"])
    pkg.set_flags({"observability_dump_dir": str(tmp / pkg.name)})
    clk = FakeClock()
    try:
        ctl, eng = _controller(pkg, clock=clk, queue_capacity=64,
                               slo_miss_threshold=0.5, slo_window_s=1.0)
        for i in range(30):
            t = ctl.submit({"x": i}, deadline_ms=10.0)
            assert ctl.pump(1) == 1
            clk.advance(0.08)
            eng.submitted[-1][1].complete(
                error=pkg.DeadlineExceeded("too late"))
            t.exception(1.0)
        st = _stats(ctl)
        paths = list(ctl.slo_dump_paths)
        dump = json.loads(open(paths[0]).read())
        rec = [st, len(paths), dump["reason"],
               dump["extra"]["deadline_miss_ratio"],
               sorted(dump["extra"]), sorted(dump["extra"]["traffic"])]
        ctl.close(drain=False)
    finally:
        pkg.set_flags(old)
    return rec


def test_sustained_slo_breach_dumps_flight_recorder(tmp_path):
    rec = both(_breach, tmp_path)
    assert rec[0]["deadline_miss_ratio"] >= 0.5
    assert rec[0]["slo_dumps_total"] == 1 and rec[1] == 1
    assert rec[2] == "slo_breach" and rec[3] >= 0.5


# -- metrics / observability -------------------------------------------------


def _scrape(pkg):
    ctl, eng = _controller(pkg, queue_capacity=8)
    ctl.submit({"x": 1}, tenant="alice", priority="interactive")
    text = pkg.observability.to_prometheus_text()
    cid = ctl._obs_id
    mine = sorted(line.replace(f'ctrl="{cid}"', 'ctrl="C"')
                  for line in text.splitlines()
                  if line.startswith("paddle_traffic_")
                  and f'ctrl="{cid}"' in line)
    json.dumps(pkg.observability.snapshot())
    ctl.close(drain=False)
    return mine


def test_traffic_series_join_the_unified_scrape():
    """The controller's series in the unified scrape equal the JAX
    package's line for line (its ctrl= id aside)."""
    lines = both(_scrape)
    text = "\n".join(lines)
    assert "paddle_traffic_admitted_total" in text
    assert 'cls="interactive"' in text and 'tenant="alice"' in text
    assert "paddle_traffic_queue_depth" in text
    assert "paddle_traffic_shed_before_batch_total" in text


def _health(pkg):
    ctl, eng = _controller(pkg, queue_capacity=8)
    ctl.submit({"x": 1}, priority="interactive")
    h = ctl.health()
    ctl.close(drain=False)
    return [h, ctl.health()["draining"]]


def test_health_fragment_has_router_signals():
    rec = both(_health)
    assert rec[0]["queue_depth"]["interactive"] == 1
    assert rec[0]["draining"] is False and rec[1] is True
    assert set(rec[0]["classes"]) == set(JAX.traffic.CLASSES)


def _retry_after(pkg):
    eng = FakeEngine(pkg)
    return [pkg.traffic.engine_retry_after(eng),
            pkg.traffic.engine_retry_after(object()),
            pkg.traffic.generation_retry_after(object())]


def test_engine_retry_after_is_clamped_and_safe():
    rec = both(_retry_after)
    assert 0.05 <= rec[0] <= 30.0 and rec[1:] == [1.0, 1.0]


def _needs_gen(pkg):
    ctl, eng = _controller(pkg, queue_capacity=8)
    try:
        ctl.submit_generation([1, 2, 3])
        rec = None
    except Exception as e:  # noqa: BLE001
        rec = [type(e).__name__, "GenerationEngine" in str(e)]
    ctl.close(drain=False)
    return rec


def test_generation_requires_engine():
    assert both(_needs_gen)[1] is True


# -- the real stack over HTTP ------------------------------------------------


@pytest.fixture(scope="module")
def mlp_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_traffic_mlp"))
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), jfluid.unique_name.guard():
        x = jfluid.layers.data("x", [16])
        out = jfluid.layers.fc(x, 10, act="softmax")
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(d, ["x"], [out], exe, main)
    return d


def _http_quota(pkg, model_dir):
    import http.client

    T = pkg.traffic
    if pkg.name == "jax":
        from paddle_tpu.inference import Config, create_predictor
        from paddle_tpu.serving import ServingEngine, ServingServer
        pred = create_predictor(Config(model_dir))
    else:
        from paddle_tpu_torch.inference import Config, create_predictor
        from paddle_tpu_torch.serving import ServingEngine, ServingServer
        pred = create_predictor(Config(model_dir), device="cpu")
    eng = ServingEngine(pred, max_batch_size=4, batch_timeout_ms=2,
                        num_workers=1)
    ctl = T.TrafficController(eng, config=T.TrafficConfig(
        queue_capacity=32,
        tenants={"alice": T.TenantSpec("alice", rate=1.0, burst=1.0)}))
    srv = ServingServer(eng, traffic=ctl)
    rec = []
    try:
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
        body = json.dumps({"inputs": {"x": np.ones((1, 16)).tolist()},
                           "deadline_ms": 5000}).encode()
        for _ in range(2):
            conn.request("POST", "/v1/predict", body,
                         {"X-Tenant": "alice", "X-Priority": "interactive"})
            r = conn.getresponse()
            payload = json.loads(r.read())
            rec.append([r.status, r.getheader("Retry-After"),
                        payload.get("kind"),
                        payload.get("retry_after_s") is not None])
            if r.status == 200:
                rec.append(np.asarray(payload["outputs"][
                    pred.get_output_names()[0]]).round(5).tolist())
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        h = json.loads(r.read())
        rec.append([r.status, sorted(h["traffic"]["queue_depth"]),
                    h["traffic"]["draining"]])
        st = ctl.stats()
        rec.append([st["admitted"], st["shed"]])
        conn.close()
    finally:
        srv.close()
        ctl.close(drain=False)
        eng.close(drain=False)
    return rec


def test_http_tenant_priority_and_retry_after(mlp_dir):
    """Headers route tenant and class through admission; the second
    request drains alice's one-token bucket and answers 429 with a
    Retry-After, as the JAX server does (outputs within 1e-5)."""
    rec = both(_http_quota, mlp_dir)
    assert rec[0][0] == 200 and rec[2][:3] == [429, "1", "shed:quota"]
    assert rec[3] == [200, sorted(JAX.traffic.CLASSES), False]
    assert rec[4] == [{"interactive/alice": 1},
                      {"interactive/alice/quota": 1}]


LM_KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
             ffn_size=64, max_position=64, hidden_dropout=0.0,
             attention_dropout=0.0)


def test_slow_client_stalled_socket_cancels_and_frees_pages():
    """A /v1/generate client that stops reading, routed through the
    traffic tier, is cancelled and its pages free long before its
    generation would end, while a healthy concurrent stream completes
    with the tokens the engine gives it alone."""
    import http.client

    from paddle_tpu_torch.generation import GenerationEngine
    from paddle_tpu_torch.generation.model import GPTLM
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.serving import ServingEngine, ServingServer
    from paddle_tpu_torch.traffic import TrafficController

    cfg = GPTConfig(**dict(LM_KW, max_position=1024))
    rng = np.random.RandomState(0)
    params = {n: (rng.randn(*p.shape) * 0.05).astype(np.float32)
              for n, p in GPTLM(cfg, "meta").jax_params().items()}
    pred = create_predictor(Config().set_params(cfg, params), device="cpu")
    gen = GenerationEngine(pred, cfg, page_size=16, num_pages=80,
                           max_decode_batch=2, chunk_tokens=6)
    alone = gen.generate([2, 4], max_new_tokens=8, eos_id=None)
    eng = ServingEngine(pred, num_workers=1, start=False)
    ctl = TrafficController(eng, generation_engine=gen)
    srv = ServingServer(eng, generation_engine=gen, traffic=ctl,
                        stream_write_timeout_s=0.2, sndbuf=1024)
    max_new = 1000
    s = socket.socket()
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1024)
        s.settimeout(30)
        s.connect((srv.host, srv.port))
        body = json.dumps({"tokens": [3, 5, 7], "max_new_tokens": max_new,
                           "eos_id": None}).encode()
        s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        s.recv(256)          # the headers and a first token, then stall
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=60)
        conn.request("POST", "/v1/generate", json.dumps(
            {"tokens": [2, 4], "max_new_tokens": 8, "eos_id": None,
             "stream": False}).encode())
        healthy = json.loads(conn.getresponse().read())["tokens"]
        conn.close()
        t_end = time.monotonic() + 120
        while time.monotonic() < t_end:
            st = gen.stats()
            if st["cancelled_total"] >= 1 and \
                    st["cache"]["pages_in_use"] == 0:
                break
            time.sleep(0.05)
        st = gen.stats()
        assert healthy == alone
        assert st["cancelled_total"] == 1, st
        assert st["cache"]["pages_in_use"] == 0
        assert st["decode_tokens_total"] < max_new
        tst = ctl.stats()
        assert tst["admitted"] == {"batch/default": 2}
    finally:
        s.close()
        srv.close()
        ctl.close(drain=False)
        eng.close(drain=False)
        gen.close(drain=False)


# -- the worker pool ----------------------------------------------------------


def test_worker_pool_rolling_restart_drops_nothing(mlp_dir):
    """Two spawned CPU workers share one port through SO_REUSEPORT; 48
    requests from 4 threads run through a rolling restart with zero
    failures (a connection reset before any response byte is retried,
    as the JAX harness does), every answer equal to the JAX predictor's
    (within 1e-5),
    and the pool's metrics endpoint merges under the fleet labels.
    Bounded: every request has a 60 s timeout and the test gives up
    after 240 s."""
    import http.client

    from paddle_tpu.inference import Config as JaxConfig
    from paddle_tpu.inference import create_predictor as jax_pred
    from paddle_tpu_torch.observability import FleetAggregator
    from paddle_tpu_torch.traffic import WorkerPool, reuseport_supported

    assert reuseport_supported()
    x = np.linspace(-1, 1, 16, dtype=np.float32).reshape(1, 16)
    want = np.asarray(jax_pred(JaxConfig(mlp_dir)).run([x])[0])
    t0 = time.monotonic()
    pool = WorkerPool(mlp_dir, num_workers=2, use_reuseport=True,
                      device="cpu", warmup_shapes={"x": [1, 16]},
                      batch_buckets=[1], ready_timeout_s=120.0)
    results, errors = [], []

    retries = []

    def client(n):
        for _ in range(n):
            # a connection that a closing listener's backlog held dies
            # before any response byte and is retried, as a load balancer
            # does (the JAX harness's rule); a request that got a status
            # line and then failed is a failure
            for _attempt in range(5):
                conn = http.client.HTTPConnection(pool.host, pool.port,
                                                  timeout=60)
                try:
                    conn.request("POST", "/v1/predict", json.dumps(
                        {"inputs": {"x": x.tolist()}}).encode(),
                        {"Connection": "close"})
                    r = conn.getresponse()
                except OSError as e:
                    conn.close()
                    retries.append(repr(e))
                    time.sleep(0.02)
                    continue
                try:
                    body = json.loads(r.read())
                    if r.status != 200:
                        errors.append((r.status, body))
                    else:
                        results.append(np.asarray(
                            next(iter(body["outputs"].values()))))
                except Exception as e:  # noqa: BLE001 — severed mid-response
                    errors.append(repr(e))
                conn.close()
                break
            else:
                errors.append("no response in 5 connections")
            time.sleep(0.01)

    try:
        assert [w.info["device"] for w in pool.workers] == ["cpu", "cpu"]
        threads = [threading.Thread(target=client, args=(12,))
                   for _ in range(4)]
        for t in threads:
            t.start()
        report = pool.rolling_restart()
        for t in threads:
            t.join(max(1.0, 240 - (time.monotonic() - t0)))
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        assert len(results) == 48
        for got in results:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert len(report["replacements"]) == 2
        assert all(d.get("forced") is None for d in report["drained"])
        agg = FleetAggregator(pool.metrics_endpoints(), timeout_s=5.0)
        text = agg.to_prometheus_text()
        assert 'worker="pool"' in text
        assert "paddle_serving_requests_total" in text
    finally:
        pool.close()


def _trace_through(pkg):
    """The engine's ambient span at submit, when the request was submitted
    inside a traced span and dispatched by the controller's pump."""
    from types import SimpleNamespace

    seen = []

    class _Gen:
        queue_capacity = 8
        metrics = SimpleNamespace(snapshot=lambda: {
            "ttft_ms": {"count": 0}})

        def queue_depth(self):
            return 0

        def submit(self, prompt, max_new_tokens=None, eos_id="default",
                   deadline_ms=None, on_token=None):
            seen.append(pkg.observability.tracing.current())
            fut = FakeFuture()
            fut.tokens, fut.first_token_at = [], None
            return fut

    old = pkg.get_flags(["observability_tracing"])
    pkg.set_flags({"observability_tracing": True})
    try:
        ctl = pkg.traffic.TrafficController(
            FakeEngine(pkg), generation_engine=_Gen(), start=False)
        with pkg.observability.tracing.span("client") as ctx:
            ctl.submit_generation([1, 2, 3], max_new_tokens=2)
        ctl.pump(1)
        ctl.close(drain=False)
    finally:
        pkg.set_flags(old)
    return ctx, seen


def test_controller_dispatch_keeps_the_trace():
    """A request submitted inside a span reaches the engine under that
    span, so a traced HTTP request behind the traffic tier stays one
    trace. The JAX controller submits from its dispatcher thread with no
    ambient span (ROADMAP §C, a fault of the reference not copied)."""
    ctx, seen = _trace_through(PORT)
    assert seen == [ctx]
    _ctx, jax_seen = _trace_through(JAX)
    assert jax_seen == [None]
