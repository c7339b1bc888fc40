"""Disaggregated prefill/decode serving in the port
(``paddle_tpu_torch.disagg``) held to the JAX package's
(``paddle_tpu.disagg``): a twin of ``tests/test_disagg.py``.

Each case is a *scenario* run once against each package on the same
seeded inputs: the page codec's bytes, the store's answers and stats,
the engines' tokens, ``radix_stats`` and store counters must be equal.
Tolerances: the wire bytes are compared exactly (``raw``, int8 verbatim
and ``int8_block`` alike: both packages divide by the scale in float32
on the CPU and round half to even, so the levels agree); decoded pages
within ``blockwise_error_bound``; tokens exactly. The model is the
tiny LM of ``tests/test_disagg.py``, saved once by the JAX package and
loaded by both (the port through its A13 loader), on the CPU.
"""

import json
import time
import types
import urllib.request

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.generation.model import GPTConfig, build_lm_program

CFG = GPTConfig(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                ffn_size=64, max_position=64, hidden_dropout=0.0,
                attention_dropout=0.0)
SEQ = 48


def _pkg(name):
    if name == "jax":
        from paddle_tpu import disagg, observability, traffic
        from paddle_tpu.generation import GenerationEngine, PagedKVCache
        from paddle_tpu.inference import Config, create_predictor
        from paddle_tpu.kernels.quant import blockwise_error_bound
        from paddle_tpu.serving import ServingEngine, ServingServer
        flags, dev = jfluid, {}
    else:
        from paddle_tpu_torch import disagg, observability, traffic
        from paddle_tpu_torch.generation import (GenerationEngine,
                                                 PagedKVCache)
        from paddle_tpu_torch.inference import Config, create_predictor
        from paddle_tpu_torch.kernels.quant import blockwise_error_bound
        from paddle_tpu_torch.serving import ServingEngine, ServingServer
        flags, dev = tfluid, {"device": "cpu"}
    return types.SimpleNamespace(
        name=name, disagg=disagg, observability=observability,
        traffic=traffic, GenerationEngine=GenerationEngine,
        PagedKVCache=PagedKVCache, bound=blockwise_error_bound,
        ServingEngine=ServingEngine, ServingServer=ServingServer,
        predictor=lambda d: create_predictor(Config(d), **dev),
        cache_kw=dev, get_flags=flags.get_flags, set_flags=flags.set_flags)


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
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    elif isinstance(a, float) or isinstance(b, float):
        assert b == pytest.approx(a, abs=1e-9), (path, a, b)
    else:
        assert a == b, (path, a, b)


def both(scenario, *args):
    """``scenario(pkg, *args)`` on each package; the records must be
    equal. Returns the port's record."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    _same(want, got)
    return got


class _Flags:
    def __init__(self, pkg, **kv):
        self._pkg, self._kv = pkg, kv

    def __enter__(self):
        self._old = self._pkg.get_flags(list(self._kv))
        self._pkg.set_flags(self._kv)

    def __exit__(self, *exc):
        self._pkg.set_flags(self._old)


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_disagg_lm"))
    main, startup, _feeds, fetches = build_lm_program(CFG, SEQ)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(d, ["tokens"],
                                       [fetches["logits"]], exe, main)
    return d


@pytest.fixture(scope="module")
def oracle(lm_dir):
    """The JAX predictor's teacher-forced greedy decode."""
    pred = JAX.predictor(lm_dir)

    def _decode(prompt, n):
        toks = [int(t) for t in prompt]
        out = []
        for _ in range(n):
            arr = np.zeros((1, SEQ), np.int64)
            arr[0, :len(toks)] = toks
            (logits,) = pred.run([arr])
            t = int(np.argmax(logits[0, len(toks) - 1]))
            toks.append(t)
            out.append(t)
        return out
    return _decode


def _engine(pkg, pred, **kw):
    kw.setdefault("page_size", 4)
    kw.setdefault("num_pages", 64)
    kw.setdefault("max_decode_batch", 4)
    kw.setdefault("chunk_tokens", 6)
    return pkg.GenerationEngine(pred, CFG, **kw)


def _toks(*vals):
    return np.asarray(vals, dtype=np.int64)


def _page(seed, L=2, kvh=4, ps=4, hd=32):
    rng = np.random.RandomState(seed)
    return (rng.randn(L, kvh, ps, hd).astype(np.float32),
            rng.randn(L, kvh, ps, hd).astype(np.float32))


def _drained(eng):
    eng.cache.check_integrity()
    assert eng.stats()["cache"]["pages_in_use"] == 0


# -- wire encoding -----------------------------------------------------------


def _wire_int8_block(pkg):
    D = pkg.disagg
    k, v = _page(3)
    blob = D.encode_page(k, v)
    n, kr, vr, _ks, _vs = D.run_for_pool([blob], np.float32)
    errs = []
    for orig, got in ((k, kr[0]), (v, vr[0])):
        bound = pkg.bound(orig.reshape(-1, orig.shape[-1]), orig.shape[-1])
        errs.append([float(np.abs(orig - got).max()), float(bound)])
    return [blob, n, D.decode_page(blob)["enc"], kr, vr, errs]


def test_wire_int8_block_error_bound():
    rec = both(_wire_int8_block)
    assert rec[1] == 1 and rec[2] == "int8_block"
    for err, bound in rec[5]:
        assert err <= bound + 1e-6, (err, bound)


def _wire_raw(pkg):
    D = pkg.disagg
    k, v = _page(5)
    blob = D.encode_page(k, v, encoding="raw")
    _, kr, vr, ks, vs = D.run_for_pool([blob], np.float32)
    return [blob, ks is None and vs is None, np.array_equal(kr[0], k),
            np.array_equal(vr[0], v)]


def test_wire_raw_bitwise():
    assert both(_wire_raw)[1:] == [True, True, True]


def _wire_int8(pkg):
    D = pkg.disagg
    rng = np.random.RandomState(7)
    L, kvh, ps, hd = 2, 4, 4, 8
    k8 = rng.randint(-127, 128, (L, kvh, ps, hd)).astype(np.int8)
    v8 = rng.randint(-127, 128, (L, kvh, ps, hd)).astype(np.int8)
    ks = rng.rand(L, kvh, ps).astype(np.float32) + 0.01
    vs = rng.rand(L, kvh, ps).astype(np.float32) + 0.01
    blob = D.encode_page(k8, v8, ks, vs)
    _, kr, vr, ksr, vsr = D.run_for_pool([blob], np.int8)
    # the mixed case: a raw blob into an int8 pool quantizes on ingest
    raw = D.encode_page(*_page(9, hd=hd), encoding="raw")
    mixed = D.run_for_pool([raw], np.int8)
    return [blob, str(kr.dtype), np.array_equal(kr[0], k8),
            np.array_equal(vr[0], v8), np.array_equal(ksr[0], ks),
            np.array_equal(vsr[0], vs), list(mixed[1:])]


def test_wire_int8_pages_ship_verbatim():
    assert both(_wire_int8)[1:6] == ["int8", True, True, True, True]


def _wire_ratio(pkg):
    D = pkg.disagg
    blob = D.encode_page(*_page(11, hd=32))
    fp = D.fp32_page_bytes(2, 4, 4, 32)
    # the full-width page: 24 layers, 16 heads, 16 slots, head_dim 128
    big = D.encode_page(*_page(12, L=24, kvh=16, ps=16, hd=128))
    return [len(blob), fp, len(big), D.fp32_page_bytes(24, 16, 16, 128)]


def test_wire_ratio_gate():
    rec = both(_wire_ratio)
    assert rec[0] <= 0.3 * rec[1], rec
    assert rec[2] <= 0.3 * rec[3], rec


def test_encode_pages_equals_encode_page_per_page():
    """The port's run encoder (what ``spill_run`` calls on the exported
    run) gives ``encode_page``'s bytes page by page, for float32 pages
    under both encodings and int8 pages with scale planes."""
    import torch

    D = PORT.disagg
    ks, vs = zip(*[_page(20 + i) for i in range(3)])
    k_run, v_run = np.stack(ks), np.stack(vs)
    for enc in ("raw", "int8_block"):
        got = D.encode_pages(torch.from_numpy(k_run), torch.from_numpy(v_run),
                             encoding=enc)
        assert got == [JAX.disagg.encode_page(k, v, encoding=enc)
                       for k, v in zip(ks, vs)]
    q = (k_run * 20).astype(np.int8)
    sc = np.ones(q.shape[:-1], np.float32)
    got = D.encode_pages(torch.from_numpy(q), torch.from_numpy(q),
                         torch.from_numpy(sc), torch.from_numpy(sc))
    assert got == [JAX.disagg.encode_page(q[i], q[i], sc[i], sc[i])
                   for i in range(3)]


# -- host page store ---------------------------------------------------------


def _store_ops(pkg):
    D = pkg.disagg
    store = D.HostPageStore(page_size=4)
    k, v = _page(13)
    blobs = [D.encode_page(*_page(13 + i)) for i in range(3)]
    toks = np.arange(1, 13, dtype=np.int64)
    rec = [store.put_run(toks, blobs),
           store.put_run(toks, [D.encode_page(k, v)] * 3)]
    got = store.match(toks)
    fork = np.concatenate([toks[:8], _toks(90, 91, 92, 93)])
    rec += [[bytes(b) == bytes(w) for b, w in zip(got, blobs)],
            len(store.match(fork)), store.match_pages(toks),
            len(store.match(toks, max_pages=1)), store.stats()]
    return rec


def test_store_put_match_dedup():
    rec = both(_store_ops)
    assert rec[:2] == [3, 0] and rec[2] == [True] * 3
    assert rec[3:6] == [2, 3, 1]
    assert rec[6]["pages"] == 3 and rec[6]["dup_pages_total"] == 3


def _store_lru(pkg):
    D = pkg.disagg
    blob = D.encode_page(*_page(17))
    store = D.HostPageStore(page_size=4, max_bytes=int(len(blob) * 2.5))
    a = np.arange(1, 9, dtype=np.int64)
    b = np.arange(50, 54, dtype=np.int64)
    store.put_run(a, [blob, blob])
    store.match(a)
    store.put_run(b, [blob])
    return [store.stats(), store.match_pages(a), store.match_pages(b)]


def test_store_byte_cap_lru_eviction():
    rec = both(_store_lru)
    assert rec[0]["evictions_total"] >= 1
    assert rec[0]["bytes"] <= rec[0]["max_bytes"]


def _tcp(pkg, server_pkg):
    """``pkg``'s client against ``server_pkg``'s server: the frames are
    the same on the wire, so either client talks to either server."""
    D = pkg.disagg
    srv = server_pkg.disagg.PageStoreServer(page_size=4)
    host, port = srv.endpoint.split(":")
    cli = D.PageStoreClient(host, int(port), page_size=4)
    try:
        blobs = [D.encode_page(*_page(19 + i)) for i in range(2)]
        toks = np.arange(1, 9, dtype=np.int64)
        rec = [cli.put_run(toks, blobs), cli.match_pages(toks),
               [bytes(x) == bytes(b) for x, b in zip(cli.match(toks), blobs)],
               srv.store.stats(), cli.stats()]
        cs = cli.stats_numeric()
        rec.append([cs["client_bytes_sent_total"],
                    cs["client_bytes_received_total"]])
        cli.clear()
        rec.append(srv.store.stats()["pages"])
    finally:
        cli.close()
        srv.close()
    return rec


def test_store_tcp_roundtrip_and_counters():
    rec = both(_tcp, PORT)
    assert rec[:3] == [2, 2, [True, True]]
    assert rec[3]["pages"] == 2 and rec[3]["wire_ratio"] <= 0.3
    assert rec[5][0] > 0 and rec[5][1] > 0 and rec[6] == 0
    # and across packages: the JAX client against the port's server
    _same(_tcp(JAX, PORT), rec)


def _endpoint(pkg, monkeypatch):
    D = pkg.disagg
    monkeypatch.setenv("PADDLE_PAGESTORE_ENDPOINT", "10.0.0.7:9999")
    rec = [D.store_endpoint_from_env()]
    monkeypatch.delenv("PADDLE_PAGESTORE_ENDPOINT")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       "10.0.0.1:8672,10.0.0.2:8672")
    rec.append(D.store_endpoint_from_env())
    monkeypatch.delenv("PADDLE_TRAINER_ENDPOINTS")
    rec.append(D.store_endpoint_from_env())
    with _Flags(pkg, disagg_store_endpoint="10.0.0.9:7000"):
        rec.append(D.store_endpoint_from_env())
        cli = D.discover_store(page_size=4)
        rec.append([cli.host, cli.port, cli.page_size])
        cli.close()
    return rec


def test_store_endpoint_from_env(monkeypatch):
    rec = both(_endpoint, monkeypatch)
    assert rec[:4] == ["10.0.0.7:9999", "10.0.0.1:8793", None,
                       "10.0.0.9:7000"]


# -- tenant quotas -----------------------------------------------------------


def _quota_cache(pkg):
    c = pkg.PagedKVCache(2, 4, 8, num_pages=32, page_size=4, max_seqs=4,
                         max_pages_per_seq=12, prefix_cache=True,
                         tenant_quota_pages=2, **pkg.cache_kw)
    pa = np.arange(1, 13, dtype=np.int64)
    slot, _ = c.acquire(pa)
    c.advance(slot, 12)
    rec = [c.publish(slot, pa, tenant="alice"), c.radix_stats()]
    c.release(slot)
    pb = np.arange(60, 68, dtype=np.int64)
    s2, _ = c.acquire(pb)
    c.advance(s2, 8)
    rec += [c.publish(s2, pb, tenant="bob"), c.radix_stats()]
    c.check_integrity()
    c.release(s2)
    rec.append(c.drop_trie())
    c.check_integrity()
    rec.append(c.stats()["pages_in_use"])
    return rec


def test_tenant_quota_cache_level():
    rec = both(_quota_cache)
    st = rec[1]
    assert st["tenant_pages"].get("alice", 0) <= 2
    assert (st["tenant_leaf_evictions"].get("alice", 0)
            + st["tenant_quota_rejections_total"]) >= 1
    assert rec[2] == 2 and rec[3]["tenant_pages"]["bob"] == 2
    assert rec[5] == 0


def _quota_engine(pkg, lm_dir):
    with _Flags(pkg, generation_trie_tenant_quota=2):
        with _engine(pkg, pkg.predictor(lm_dir), prefix_cache=True) as eng:
            rng = np.random.RandomState(71)
            p = rng.randint(1, CFG.vocab_size, 14).astype(np.int64)
            toks = eng.submit(p, max_new_tokens=4, tenant="acme").result(600)
            st = eng.cache.radix_stats()
            eng.cache.check_integrity()
            eng.cache.drop_trie()
        _drained(eng)
    return [toks, st]


def test_tenant_quota_through_engine(lm_dir):
    rec = both(_quota_engine, lm_dir)
    st = rec[1]
    assert st["tenant_quota_pages"] == 2
    assert 0 < sum(st["tenant_pages"].values()) <= 2
    assert set(st["tenant_pages"]) <= {"acme"}


def _forwards_tenant(pkg, lm_dir):
    T = pkg.traffic
    with _engine(pkg, pkg.predictor(lm_dir), prefix_cache=True) as eng:
        ctl = T.TrafficController(engine=None, generation_engine=eng,
                                  config=T.TrafficConfig.from_flags(),
                                  start=False)
        tk = ctl.submit_generation(_toks(5, 6, 7, 8, 9, 10),
                                   tenant="tenant-z", max_new_tokens=3)
        while not tk.done():
            ctl.pump()
            time.sleep(0.01)
        toks = tk.result(timeout=600)
        st = eng.cache.radix_stats()
        ctl.close(drain=True)
        eng.cache.drop_trie()
    _drained(eng)
    return [toks, st["tenant_pages"], ctl.stats()["admitted"]]


def test_controller_forwards_tenant(lm_dir):
    rec = both(_forwards_tenant, lm_dir)
    assert rec[0] and "tenant-z" in rec[1]


# -- estimator pricing -------------------------------------------------------


def _handoff_pricing(pkg):
    class _Gen:
        mode = "ragged"
        chunk_tokens = 0
        prefix_cache = False
        default_max_new = 4

        class metrics:
            @staticmethod
            def snapshot():
                return {"ttft_ms": {"count": 5, "p50": 10.0},
                        "itl_ms": {"p50": 2.0},
                        "decode_step_ms": {"p50": 2.0}}

        @staticmethod
        def handoff_overhead_ms():
            return 7.0

    est = pkg.traffic.controller.ServiceTimeEstimator(generation_engine=_Gen())
    bare = pkg.traffic.controller.ServiceTimeEstimator(
        generation_engine=type("_G", (_Gen,), {"handoff_overhead_ms": None})())
    return [est.generate_service_ms(4), bare.generate_service_ms(4)]


def test_estimator_prices_handoff():
    rec = both(_handoff_pricing)
    assert rec[0] == pytest.approx(10.0 + 7.0 + 2.0 * 3)
    assert rec[1] == pytest.approx(10.0 + 2.0 * 3)


# -- cross-engine persistence (the splice path) ------------------------------


def _warm_start(pkg, lm_dir):
    D = pkg.disagg
    store = D.HostPageStore(page_size=4)
    rng = np.random.RandomState(83)
    p = rng.randint(1, CFG.vocab_size, 20).astype(np.int64)
    with _Flags(pkg, disagg_wire_encoding="raw"):
        with _engine(pkg, pkg.predictor(lm_dir), prefix_cache=True,
                     page_store=store) as eng_a:
            cold = eng_a.generate(p, max_new_tokens=6, timeout=600)
            spilled = eng_a.spill_run(p)
            exported = eng_a.cache.radix_stats()["exported_pages_total"]
            eng_a.cache.drop_trie()
        _drained(eng_a)
        after_a = store.stats()
        with _engine(pkg, pkg.predictor(lm_dir), prefix_cache=True,
                     page_store=store) as eng_b:
            warm = eng_b.generate(p, max_new_tokens=6, timeout=600)
            st = eng_b.stats()["store"]
            radix = eng_b.cache.radix_stats()
            eng_b.cache.check_integrity()
            eng_b.cache.drop_trie()
        _drained(eng_b)
    return [cold, warm, spilled, exported, after_a, st, radix,
            store.stats()]


def test_spill_then_warm_start(lm_dir, oracle):
    """Engine A publishes and spills; a fresh engine B splices the run
    at admission, resumes at the fork point and emits the oracle's
    tokens. Store stats and radix_stats equal the JAX package's."""
    rec = both(_warm_start, lm_dir)
    cold, warm = rec[:2]
    assert rec[2] == 5 and rec[3] == 5 and rec[4]["pages"] == 5
    # the >=1-token-to-prefill cap: 5 pages spilled, 4 spliced
    assert rec[5]["hits_total"] == 1 and rec[5]["pages_pulled_total"] == 4
    assert rec[6]["ingested_pages_total"] == 4
    rng = np.random.RandomState(83)
    p = rng.randint(1, CFG.vocab_size, 20).astype(np.int64)
    assert warm == cold == oracle(p, 6)


def _drain_spill(pkg, lm_dir):
    D = pkg.disagg
    store = D.HostPageStore(page_size=4)
    rng = np.random.RandomState(89)
    p = rng.randint(1, CFG.vocab_size, 16).astype(np.int64)
    with _Flags(pkg, disagg_wire_encoding="raw"):
        eng = _engine(pkg, pkg.predictor(lm_dir), prefix_cache=True,
                      page_store=store)
        cold = eng.generate(p, max_new_tokens=5, timeout=600)
        eng.close(drain=True)
        _drained(eng)
        rec = [eng.store_pages_spilled_total, store.stats()]
        with _engine(pkg, pkg.predictor(lm_dir), prefix_cache=True,
                     page_store=store) as eng_b:
            warm = eng_b.generate(p, max_new_tokens=5, timeout=600)
            rec.append(eng_b.stats()["store"])
            eng_b.cache.drop_trie()
        _drained(eng_b)
    return [cold, warm] + rec


def test_drain_spills_trie_to_store(lm_dir, oracle):
    rec = both(_drain_spill, lm_dir)
    assert rec[2] >= 4 and rec[3]["pages"] >= 4
    assert rec[4]["hits_total"] == 1
    rng = np.random.RandomState(89)
    p = rng.randint(1, CFG.vocab_size, 16).astype(np.int64)
    assert rec[0] == rec[1] == oracle(p, 5)


# -- the split topology ------------------------------------------------------


def _split(pkg, lm_dir, store, *, kv_dtype="float32", decode_kw=None):
    D = pkg.disagg
    pf = D.PrefillWorker(pkg.predictor(lm_dir), CFG, store, page_size=4,
                         num_pages=64, max_decode_batch=4, chunk_tokens=6,
                         kv_dtype=kv_dtype)
    dkw = dict(page_size=4, num_pages=64, max_decode_batch=4,
               chunk_tokens=6, kv_dtype=kv_dtype)
    dkw.update(decode_kw or {})
    dw = D.DecodeWorker(pkg.predictor(lm_dir), CFG, store, **dkw)
    return D.DisaggService(prefill=[pf], decode=[dw])


def _split_drained(svc):
    for w in svc._prefill + svc._decode:
        _drained(w.engine)


_NUMERIC = ("requests_total", "responses_total", "rejected_total",
            "handoffs_total", "handoff_failures_total", "cancelled_total",
            "prefill_workers", "decode_workers", "pages_shipped_total",
            "pages_pulled_total", "store_lookups_total", "store_hits_total",
            "store_hit_rate", "store_pages", "wire_bytes_total",
            "fp32_bytes_total", "wire_ratio")


def _identity(pkg, lm_dir, kv_dtype, encoding):
    rng = np.random.RandomState(97)
    pre = rng.randint(1, CFG.vocab_size, 12).astype(np.int64)
    prompts = [np.concatenate([pre, rng.randint(
        1, CFG.vocab_size, 3 + i).astype(np.int64)]) for i in range(3)]
    with _engine(pkg, pkg.predictor(lm_dir), prefix_cache=True,
                 kv_dtype=kv_dtype) as coloc:
        want = [coloc.generate(p, max_new_tokens=8, timeout=600)
                for p in prompts]
        coloc.cache.drop_trie()
    _drained(coloc)
    with _Flags(pkg, disagg_wire_encoding=encoding):
        store = pkg.disagg.HostPageStore(page_size=4)
        svc = _split(pkg, lm_dir, store, kv_dtype=kv_dtype)
        try:
            got = [svc.generate(p, max_new_tokens=8, timeout=600)
                   for p in prompts]
            sn = svc.stats_numeric()
            # queue depths and active counts race the loops' gauges
            ph = sorted((w["worker"], w["phase"])
                        for w in svc.phase_health())
            radix = [w.engine.cache.radix_stats()
                     for w in svc._prefill + svc._decode]
            stores = [w.engine.stats()["store"]
                      for w in svc._prefill + svc._decode]
            # the pages spliced on the decode side, against the store's
            dec = svc._decode[0].engine
            n, k_run, v_run, ks, vs = dec.cache.export_run(prompts[0])
            blobs = store.match(prompts[0])[:n]
            stored = pkg.disagg.run_for_pool(blobs, kv_dtype)
            spliced = (n > 0 and np.array_equal(k_run, stored[1])
                       and np.array_equal(v_run, stored[2])
                       and (ks is None or np.array_equal(ks, stored[3])))
        finally:
            svc.close(drain=True)
        _split_drained(svc)
    return [want, got, {k: sn[k] for k in _NUMERIC}, ph, radix, stores,
            spliced, store.stats()]


@pytest.mark.parametrize("kv_dtype,encoding", [
    ("float32", "raw"), ("int8", "int8_block")])
def test_split_token_identity(lm_dir, oracle, kv_dtype, encoding):
    """Prefill tier -> store -> decode tier emits exactly the co-located
    engine's greedy tokens (the oracle's for float32), the port's split
    equals the JAX split, its store stats and radix_stats equal JAX's,
    and the decode side's spliced pages equal the stored ones bit for
    bit."""
    want, got, sn, ph, radix, stores, spliced, st = both(
        _identity, lm_dir, kv_dtype, encoding)
    assert got == want
    assert sn["handoffs_total"] == 3 and sn["pages_shipped_total"] >= 3
    assert sn["store_hits_total"] >= 1 and sn["pages_pulled_total"] >= 1
    assert ph == [("decode-0", "decode"), ("prefill-0", "prefill")]
    assert spliced is True
    if kv_dtype == "float32":
        rng = np.random.RandomState(97)
        pre = rng.randint(1, CFG.vocab_size, 12).astype(np.int64)
        prompts = [np.concatenate([pre, rng.randint(
            1, CFG.vocab_size, 3 + i).astype(np.int64)]) for i in range(3)]
        for p, toks in zip(prompts, got):
            assert toks == oracle(p, 8), list(p)


def _churn(pkg, lm_dir):
    rng = np.random.RandomState(101)
    pre = rng.randint(1, CFG.vocab_size, 8).astype(np.int64)
    prompts = [np.concatenate([pre, rng.randint(
        1, CFG.vocab_size, 2 + i).astype(np.int64)]) for i in range(4)]
    with _Flags(pkg, disagg_wire_encoding="raw"):
        svc = _split(pkg, lm_dir, pkg.disagg.HostPageStore(page_size=4),
                     decode_kw=dict(num_pages=16, max_decode_batch=3))
        try:
            streams = [svc.submit(p, max_new_tokens=18) for p in prompts]
            outs = [s.result(timeout=600) for s in streams]
            evicted = svc._decode[0].engine.stats()["evicted_total"]
        finally:
            svc.close(drain=True)
        _split_drained(svc)
    return [prompts, outs, evicted]


def test_split_churn_eviction_resume(lm_dir, oracle):
    """Token identity through mid-flight eviction and resume on a small
    decode pool, while spliced store runs are live. The tokens equal
    the oracle's; the eviction count depends on the handoff threads'
    timing, so it is asserted, not compared."""
    prompts, outs, evicted = _churn(PORT, lm_dir)
    assert evicted >= 1, "must exercise eviction/resume"
    for p, got in zip(prompts, outs):
        assert got == oracle(p, 18), list(p)


def _cancel(pkg, lm_dir):
    rng = np.random.RandomState(103)
    p = rng.randint(1, CFG.vocab_size, 16).astype(np.int64)
    with _Flags(pkg, disagg_wire_encoding="raw"):
        svc = _split(pkg, lm_dir, pkg.disagg.HostPageStore(page_size=4))
        try:
            svc._handoff_hook = lambda job: job.stream.cancel()
            s = svc.submit(p, max_new_tokens=8)
            try:
                s.result(timeout=600)
                err = None
            except Exception as e:  # noqa: BLE001
                err = str(e)
            sn = svc.metrics.snapshot()
            dw = svc._decode[0].engine
            rec = [s.finish_reason, "cancelled" in (err or ""),
                   sn["cancelled_total"], sn["handoffs_total"],
                   svc._decode[0].store.stats()["pages"],
                   dw.metrics.snapshot()["requests_total"]]
            svc._handoff_hook = None
            rec.append(svc.generate(p, max_new_tokens=4, timeout=600))
            rec.append(dw.stats()["store"])
        finally:
            svc.close(drain=True)
        _split_drained(svc)
    return rec


def test_cancel_mid_handoff(lm_dir):
    rec = both(_cancel, lm_dir)
    assert rec[:4] == ["cancelled", True, 1, 0]
    assert rec[4] >= 3 and rec[5] == 0
    assert rec[6] and rec[7]["hits_total"] == 1


def _gauges(pkg, lm_dir):
    with _Flags(pkg, disagg_wire_encoding="raw"):
        svc = _split(pkg, lm_dir, pkg.disagg.HostPageStore(page_size=4))
        try:
            svc.generate(_toks(3, 4, 5, 6, 7, 8, 9, 10), max_new_tokens=3,
                         timeout=600)
            text = pkg.observability.to_prometheus_text()
            sid = svc._obs_id
            mine = sorted(
                line.split(" ")[0].replace(f'svc="{sid}"', 'svc="S"')
                for line in text.splitlines()
                if line.startswith("paddle_disagg_")
                and f'svc="{sid}"' in line)
        finally:
            svc.close(drain=True)
        _split_drained(svc)
    return mine


def test_disagg_gauges_reach_prometheus(lm_dir):
    """The service's paddle_disagg_* series in the unified scrape have
    the JAX package's names and labels, one for one."""
    names = "\n".join(both(_gauges, lm_dir))
    for family in ("paddle_disagg_handoffs_total",
                   "paddle_disagg_pages_shipped_total",
                   "paddle_disagg_store_hit_rate",
                   "paddle_disagg_handoff_ms_p50",
                   "paddle_disagg_wire_bytes_total"):
        assert family in names, family


def _healthz(pkg, lm_dir):
    pred = pkg.predictor(lm_dir)
    eng = pkg.ServingEngine(pred, max_batch_size=2, batch_timeout_ms=1)
    with _engine(pkg, pred, prefix_cache=True,
                 page_store=pkg.disagg.HostPageStore(page_size=4),
                 phase="decode") as gen:
        srv = pkg.ServingServer(eng, port=0, generation_engine=gen)
        try:
            with urllib.request.urlopen(srv.address + "/healthz",
                                        timeout=10) as r:
                body = json.loads(r.read())
        finally:
            srv.close()
            eng.close()
        gen.cache.drop_trie()
    _drained(gen)
    return [body["phase"], body["status"], body["models"]["phase"]]


def test_healthz_phase_fragment(lm_dir):
    """/healthz carries the worker phase so that a router tells the
    tiers apart from the probe it already polls."""
    assert both(_healthz, lm_dir) == ["decode", "ok", "decode"]


def test_page_store_with_adapters_is_refused(lm_dir):
    """The store keys a page by its tokens alone: an adapter store and
    a page store together are refused, where the JAX engine would
    splice one adapter's K/V into another adapter's row."""
    from paddle_tpu_torch.adapters import AdapterStore

    pred = PORT.predictor(lm_dir)
    store = AdapterStore.for_model(pred.lm, rank_buckets=(8,),
                                   slots_per_bucket=1)
    with pytest.raises(ValueError, match="not keyed by adapter"):
        _engine(PORT, pred, page_store=PORT.disagg.HostPageStore(4),
                adapter_store=store, start=False)


def test_dead_store_degrades_to_cold_prefill(lm_dir, oracle):
    """A store that errors on every fetch counts store_errors_total and
    the request runs a cold prefill with the oracle's tokens, as in the
    JAX engine (its :1109-1113)."""
    class _Dead:
        def match(self, tokens, max_pages=0):
            raise ConnectionError("store down")

        def match_pages(self, tokens):
            raise ConnectionError("store down")

    p = np.arange(3, 23, dtype=np.int64)
    got = []
    for pkg in (JAX, PORT):
        with _engine(pkg, pkg.predictor(lm_dir), prefix_cache=True,
                     page_store=_Dead()) as eng:
            toks = eng.generate(p, max_new_tokens=4, timeout=600)
            got.append([toks, eng.stats()["store"]["errors_total"]])
            eng.cache.drop_trie()
        _drained(eng)
    assert got[0] == got[1] == [oracle(p, 4), 1]


def _consult_race(pkg, lm_dir):
    """A request that arrives while the loop is fetching another's run
    from the store: is it consulted before its prefill?"""
    import threading

    class _Slow(pkg.disagg.HostPageStore):
        def __init__(self):
            super().__init__(page_size=4)
            self.entered, self.release = threading.Event(), \
                threading.Event()

        def match(self, tokens, max_pages=0):
            if not self.entered.is_set():
                self.entered.set()
                self.release.wait(60)
            return super().match(tokens, max_pages)

    store = _Slow()
    with _engine(pkg, pkg.predictor(lm_dir), prefix_cache=True,
                 page_store=store) as eng:
        a = eng.submit(np.arange(3, 23, dtype=np.int64), max_new_tokens=3)
        assert store.entered.wait(60)
        b = eng.submit(np.arange(40, 60, dtype=np.int64), max_new_tokens=3)
        store.release.set()
        toks = [a.result(600), b.result(600)]
        lookups = eng.stats()["store"]["lookups_total"]
        eng.cache.drop_trie()
    _drained(eng)
    return toks, lookups


def test_a_request_queued_during_a_fetch_is_consulted(lm_dir):
    """The loop fetches from the store outside its lock, so a request can
    arrive mid-fetch. The port consults it at the next iteration before
    any prefill (2 lookups); the JAX engine admits it unconsulted in the
    same iteration and cold-prefills it (1 lookup): ROADMAP §C, a fault
    of the reference not copied. The tokens are the same either way."""
    jax_toks, jax_lookups = _consult_race(JAX, lm_dir)
    toks, lookups = _consult_race(PORT, lm_dir)
    assert toks == jax_toks
    assert lookups == 2 and jax_lookups == 1
