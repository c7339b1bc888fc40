"""paddle_tpu_torch's batched LoRA (K12's plain path, the AdapterStore,
the step-model rewrite and the mixed-adapter engine) against the JAX
package, on the CPU.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.adapters import AdapterStore as JaxStore
from paddle_tpu.adapters import lora_targets as jax_lora_targets
from paddle_tpu.generation import GenerationEngine as JaxEngine
from paddle_tpu.generation.model import CacheGeometry as JaxGeometry
from paddle_tpu.generation.model import GPTConfig as JaxGPTConfig
from paddle_tpu.generation.model import (build_lm_program,
                                         build_ragged_step_program)
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_create_predictor
from paddle_tpu.kernels import lora as jlora
from paddle_tpu.kernels import quant_matmul as jqm
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.adapters import (AdapterError, AdapterInUse,
                                       AdapterMissing, AdapterPoolFull,
                                       AdapterQuotaExceeded, AdapterStore,
                                       lora_targets, rewrite_for_lora)
from paddle_tpu_torch.generation import GenerationEngine
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.kernels import lora as plora
from paddle_tpu_torch.kernels import quant_matmul as pqm

CFG = JaxGPTConfig(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                   ffn_size=64, max_position=64, hidden_dropout=0.0,
                   attention_dropout=0.0)
SEQ = 40


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pools(rng, S, K_, r, N):
    a = (rng.randn(S, K_, r) * 0.1).astype(np.float32)
    b = (rng.randn(S, r, N) * 0.1).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    sc = rng.rand(S).astype(np.float32)
    sc[0] = 0.0
    return a, b, sc


# -- the delta and the matmul --------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 24, 8, 16), (16, 128, 16, 128),
                                   (3, 70, 8, 33), (5, 24, 1, 17)])
def test_plain_delta_matches_jax_reference_and_interpret(shape):
    """Against JAX's reference gather (float32 sums in another order:
    1e-5 of the scale), the Pallas body in interpret mode (JAX's own
    1e-4 bound) and the dense-merge oracle; slot-0 rows exactly 0."""
    import jax.numpy as jnp

    M, K_, r, N = shape
    rng = np.random.RandomState(1)
    a, b, sc = _pools(rng, 4, K_, r, N)
    slots = rng.randint(0, 4, M).astype(np.int32)
    slots[0] = 0
    x = rng.randn(M, K_).astype(np.float32)
    got = plora.batched_lora_delta(_t(x), _t(a), _t(b), _t(sc),
                                   _t(slots)).numpy()
    args = [jnp.asarray(v) for v in (x, a, b, sc, slots)]
    ref = np.asarray(jlora._reference_lora_delta(*args))
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() <= 1e-5 * scale
    pal = np.asarray(jlora._lora_delta_pallas(*args, interpret=True))
    assert np.abs(got - pal).max() <= 1e-4 * scale
    merged = np.stack([x[m] @ (sc[s] * a[s] @ b[s])
                       for m, s in enumerate(slots)])
    assert np.abs(got - merged).max() <= 5e-5 * scale
    assert np.all(got[slots == 0] == 0.0)


@pytest.mark.parametrize("base_kind", ["dense", "int8", "int8_block", "fp8"])
def test_plain_batched_lora_matmul_matches_jax(base_kind):
    """Two rank buckets (8 and 16), slots [R, 2] broadcast over chunked
    rows (M = 3 R), every base kind: the base product is the exact
    quantized_matmul call, the deltas added in bucket order."""
    import jax.numpy as jnp

    rng = np.random.RandomState(2)
    R, C, K_, N = 4, 3, 40, 24
    x = rng.randn(R, C, K_).astype(np.float32)
    w = (rng.randn(K_, N) * 0.2).astype(np.float32)
    a8, b8, s8 = _pools(rng, 3, K_, 8, N)
    a16, b16, s16 = _pools(rng, 3, K_, 16, N)
    slots = np.array([[0, 0], [1, 0], [0, 2], [2, 0]], np.int32)
    if base_kind == "dense":
        jw, js, pw, ps = jnp.asarray(w), None, _t(w), None
    else:
        jw, js = jqm.quantize_weight(w, base_kind, block=16)
        pw, ps = pqm.quantize_weight(_t(w), base_kind, block=16)
    want = np.asarray(jlora.batched_lora_matmul(
        jnp.asarray(x), jw, [jnp.asarray(a8), jnp.asarray(a16)],
        [jnp.asarray(b8), jnp.asarray(b16)],
        [jnp.asarray(s8), jnp.asarray(s16)], jnp.asarray(slots),
        base_kind=base_kind, weight_scale=js, quant_block=16))
    got = plora.batched_lora_matmul(
        _t(x), pw, [_t(a8), _t(a16)], [_t(b8), _t(b16)], [_t(s8), _t(s16)],
        _t(slots), base_kind=base_kind, weight_scale=ps,
        quant_block=16).numpy()
    assert got.shape == (R, C, N)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # base-only rows are the base product, bit for bit
    x2 = _t(x.reshape(-1, K_))
    base = (x2 @ pw if base_kind == "dense" else
            pqm.quantized_matmul(x2, pw, ps, mode=base_kind,
                                 block=16)).numpy()
    np.testing.assert_array_equal(got[0], base.reshape(R, C, N)[0])
    with pytest.raises(ValueError, match="broadcast"):
        plora.batched_lora_matmul(_t(x[:, :2]).reshape(-1, K_)[:7], pw,
                                  [_t(a8)], [_t(b8)], [_t(s8)], _t(slots),
                                  base_kind=base_kind, weight_scale=ps,
                                  quant_block=16)
    assert K.batched_lora_add_.launches == 0      # CPU: the plain path


def test_pool_geometry_equals_jax():
    for k, n, r, s in ((16, 24, 8, 3), (2048, 32000, 16, 5)):
        assert plora.lora_pool_shapes(k, n, r, s) == \
            jlora.lora_pool_shapes(k, n, r, s)
        assert plora.lora_slot_bytes(k, n, r) == jlora.lora_slot_bytes(k, n, r)


# -- the store -------------------------------------------------------------------

TARGETS = {"w1": (16, 24), "w2": (24, 16)}


def _f(rng, k, r, n):
    return ((rng.randn(k, r) * 0.1).astype(np.float32),
            (rng.randn(r, n) * 0.1).astype(np.float32))


def test_store_slot0_reserved_and_upload_shapes():
    st = AdapterStore(TARGETS, rank_buckets=(8, 16), slots_per_bucket=3)
    ref = JaxStore(TARGETS, rank_buckets=(8, 16), slots_per_bucket=3)
    assert st.slots == ref.slots and st.capacity_bytes() == \
        ref.capacity_bytes()
    rng = np.random.RandomState(0)
    A, B = _f(rng, 16, 8, 24)
    row = st.upload("a1", {"w1": (A, B)}, alpha=16.0)
    assert row == ref.upload("a1", {"w1": (A, B)}, alpha=16.0)
    assert row["slot"] >= 1 and row["rank_bucket"] == 8
    a, b, sc = st.pools("w1")
    np.testing.assert_array_equal(a[0][row["slot"]].numpy(), A)
    np.testing.assert_array_equal(b[0][row["slot"]].numpy(), B)
    assert float(sc[0][row["slot"]]) == 2.0
    for pool in (a[0], b[0], sc[0]):
        assert bool((pool[0] == 0).all())          # the zero adapter
    # rank 9 rounds up into the 16 bucket, zero-padded
    A9, B9 = _f(rng, 24, 9, 16)
    row2 = st.upload("a2", {"w2": (A9, B9)})
    assert (row2["rank"], row2["rank_bucket"]) == (9, 16)
    a2 = st.pools("w2")[0][1][row2["slot"]]
    np.testing.assert_array_equal(a2[:, :9].numpy(), A9)
    assert bool((a2[:, 9:] == 0).all())
    # a partial adapter leaves its other targets at zero
    assert bool((st.pools("w1")[0][1][row2["slot"]] == 0).all())
    assert list(st.slots_row("a2")) == [0, row2["slot"]]
    assert list(st.slots_row(None)) == [0, 0]
    with pytest.raises(AdapterError, match="rank"):
        st.upload("a3", {"w1": _f(rng, 16, 20, 24)})
    with pytest.raises(AdapterError, match="unknown target"):
        st.upload("a4", {"bogus": _f(rng, 4, 8, 4)})
    with pytest.raises(AdapterError, match="wants"):
        st.upload("a5", {"w1": _f(rng, 15, 8, 24)})
    assert [r["id"] for r in st.resident()] == ["a1", "a2"]


def test_evict_under_load_refcount_integrity():
    st = AdapterStore(TARGETS, rank_buckets=(8,), slots_per_bucket=4)
    rng = np.random.RandomState(1)
    for i in range(2):
        st.upload(f"a{i}", {"w1": _f(rng, 16, 8, 24)})
    slot0 = st.slots_row("a0")[0]
    st.acquire("a0")
    st.acquire("a0")
    with pytest.raises(AdapterInUse):
        st.evict("a0")
    assert st.is_resident("a0")
    st.release("a0")
    with pytest.raises(AdapterInUse):
        st.evict("a0")
    st.release("a0")
    st.evict("a0")
    assert not st.is_resident("a0")
    assert bool((st.pools("w1")[0][0][slot0] == 0).all())   # zeroed
    with pytest.raises(AdapterMissing):
        st.acquire("a0")
    st.acquire("a1")
    st.evict("a1", force=True)
    assert not st.is_resident("a1")
    with pytest.raises(AdapterMissing, match="vanished"):
        st.slots_row("a1")
    assert st.used_bytes() == 0
    s = st.stats_numeric()
    assert s["evict_refusals_total"] >= 2 and s["resident"] == 0


def test_lru_and_tenant_quota_eviction():
    st = AdapterStore(TARGETS, rank_buckets=(8,), slots_per_bucket=2)
    rng = np.random.RandomState(2)
    st.upload("a0", {"w1": _f(rng, 16, 8, 24)})
    st.upload("a1", {"w1": _f(rng, 16, 8, 24)})
    st.upload("a2", {"w1": _f(rng, 16, 8, 24)})    # evicts a0 (LRU)
    assert not st.is_resident("a0") and st.is_resident("a2")
    assert st.stats_numeric()["lru_evictions_total"] == 1
    st.acquire("a1")
    st.acquire("a2")
    with pytest.raises(AdapterPoolFull):
        st.upload("a3", {"w1": _f(rng, 16, 8, 24)})
    st2 = AdapterStore(TARGETS, rank_buckets=(8,), slots_per_bucket=8,
                       tenant_quota=2)
    for i in range(3):
        st2.upload(f"t{i}", {"w1": _f(rng, 16, 8, 24)}, tenant="alice")
    assert not st2.is_resident("t0")
    assert st2.stats_numeric()["quota_evictions_total"] == 1
    st2.upload("b0", {"w1": _f(rng, 16, 8, 24)}, tenant="bob")
    st2.acquire("t1")
    st2.acquire("t2")
    with pytest.raises(AdapterQuotaExceeded):
        st2.upload("t3", {"w1": _f(rng, 16, 8, 24)}, tenant="alice")
    assert st2.is_resident("b0")


# -- the rewrite and the engine -------------------------------------------------


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_adapter_lm"))
    main, startup, _feeds, fetches = build_lm_program(CFG, SEQ)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.TPUPlace())
        exe.run(startup)
        fluid.io.save_inference_model(d, ["tokens"], [fetches["logits"]],
                                      exe, main)
    return d


def _port_pred(lm_dir, mode=None):
    c = Config(lm_dir)
    if mode:
        c.enable_weight_quantization(mode)
    return create_predictor(c, device="cpu")


def test_targets_equal_jax_and_rewrite_is_idempotent(lm_dir):
    prog, _ = build_ragged_step_program(
        CFG, JaxGeometry(num_pages=16, page_size=4, max_pages_per_seq=16), 6)
    want = jax_lora_targets(prog)
    pred = _port_pred(lm_dir)
    assert lora_targets(pred.lm) == want
    eng = GenerationEngine(pred, pred.gpt_config, quantize_weights="int8",
                           adapter_store=AdapterStore.for_model(
                               pred.lm, slots_per_bucket=2), start=False)
    rep = eng.lora_report
    assert rep.n_repointed == 9
    assert {r["base_kind"] for r in rep.rows} == {"int8"}
    assert {r["op"] for r in rep.rows} == {"quantized_fc"}
    assert rep.targets() == sorted(want)
    again = rewrite_for_lora(eng._step_model, eng.adapter_store)
    assert again.n_repointed == 0
    assert all(r["reason"] == "already a batched-LoRA op" for r in again.rows)
    # the predictor is untouched: its forward takes no adapters
    logits = pred.lm(torch.zeros((1, 5), dtype=torch.long))
    assert bool(torch.isfinite(logits).all())
    # a store over other shapes leaves those weights alone
    other = AdapterStore({"dec0_qkv.w": (32, 96), "gpt_head.w": (31, 97)})
    from paddle_tpu_torch.generation import CacheGeometry, RaggedStepModel

    step = RaggedStepModel(pred.lm, CacheGeometry(16, 4, 16), 6)
    rep2 = rewrite_for_lora(step, other)
    assert rep2.targets() == ["dec0_qkv.w"]
    assert "shape mismatch" in [r for r in rep2.rows
                                if r["target"] == "gpt_head.w"][0]["reason"]
    eng.close()


def _factors(rng, targets, rank, names):
    out = {}
    for t in names:
        k, n = targets[t]
        out[t] = ((rng.randn(k, rank) * 0.05).astype(np.float32),
                  (rng.randn(rank, n) * 0.05).astype(np.float32))
    return out


def _adapters(targets, seed=7):
    """Four seeded adapters, two per rank bucket, one of them partial
    (the ffn targets only)."""
    rng = np.random.RandomState(seed)
    names = sorted(targets)
    ffn = [t for t in names if "_ffn" in t]
    spec = (("ad0", 8, names), ("ad1", 16, names), ("ad2", 8, ffn),
            ("ad3", 16, names))
    return [(aid, _factors(rng, targets, r, ts), 2.0 * r)
            for aid, r, ts in spec]


def _jax_engine(lm_dir, mode, lanes, slots=4, kv="int8"):
    c = JaxConfig(lm_dir)
    if mode != "off":
        c.enable_weight_quantization(mode)
    fluid.set_flags({"adapter_pool_max_bytes": 1,
                     "adapter_slots_per_bucket": slots})
    try:
        return JaxEngine(jax_create_predictor(c), CFG, page_size=4,
                         num_pages=64, max_decode_batch=lanes,
                         chunk_tokens=6, kv_dtype=kv, quantize_weights=mode)
    finally:
        fluid.set_flags({"adapter_pool_max_bytes": 0,
                         "adapter_slots_per_bucket": 0})


def _port_engine(lm_dir, mode, lanes, slots=4, kv="int8", store=True,
                 start=True):
    pred = _port_pred(lm_dir)
    st = (AdapterStore.for_model(pred.lm, rank_buckets=(8, 16),
                                 slots_per_bucket=slots) if store else None)
    return GenerationEngine(pred, pred.gpt_config, page_size=4, num_pages=64,
                            max_decode_batch=lanes, chunk_tokens=6,
                            kv_dtype=kv, quantize_weights=mode,
                            adapter_store=st, start=start)


PROMPTS = [np.asarray(p, np.int64) for p in
           ([3, 11, 5, 2, 17, 8], [9, 4, 4, 30, 1], [60, 2, 7, 7, 7, 7, 3, 1],
            [5, 50, 5])]


def _mixed_run(eng):
    """4 adapters (one per prompt) and 2 base rows, all in one batch."""
    for aid, fac, alpha in _adapters(eng.adapter_store.targets):
        eng.adapter_store.upload(aid, fac, alpha=alpha)
    streams = [eng.submit(p, max_new_tokens=8, adapter=f"ad{i}")
               for i, p in enumerate(PROMPTS)]
    streams += [eng.submit(p, max_new_tokens=8) for p in PROMPTS[:2]]
    return [s.result(timeout=600) for s in streams]


@pytest.mark.parametrize("mode,kv", [("int8", "int8"), ("off", "float32")])
def test_mixed_adapter_engine_matches_jax(lm_dir, mode, kv):
    with _jax_engine(lm_dir, mode, lanes=6, kv=kv) as jeng:
        want = _mixed_run(jeng)
    with _port_engine(lm_dir, mode, lanes=6, kv=kv) as eng:
        got = _mixed_run(eng)
        assert all(r["refcount"] == 0 for r in eng.adapter_store.resident())
        st = eng.stats()
    assert got == want
    assert st["adapters"]["active_refs"] == 0
    assert st["cache"]["pages_in_use"] == 0
    # an adapter changes the tokens of its prompt
    assert got[0] != got[4] or got[1] != got[5]


def test_mixed_batch_rows_equal_dedicated_engines(lm_dir):
    """The slot-0 contract and the per-row independence: base rows equal
    an engine without a store; each adapter row equals an engine that
    holds only that adapter (int8 weights, int8 KV)."""
    with _port_engine(lm_dir, "int8", lanes=6) as eng:
        mixed = _mixed_run(eng)
    with _port_engine(lm_dir, "int8", lanes=2, store=False) as base:
        assert [base.generate(p, max_new_tokens=8, timeout=600)
                for p in PROMPTS[:2]] == mixed[4:]
    for i in (1, 2):
        aid, fac, alpha = _adapters(eng.adapter_store.targets)[i]
        with _port_engine(lm_dir, "int8", lanes=2, slots=1) as solo:
            row = solo.adapter_store.upload(aid, fac, alpha=alpha)
            assert row["slot"] == 1
            out = solo.generate(PROMPTS[i], max_new_tokens=8, adapter=aid,
                                timeout=600)
        assert out == mixed[i], f"{aid} diverged from a dedicated engine"


@pytest.mark.parametrize("mode,kv", [("int8", "int8"), ("off", "float32")])
def test_hot_swap_zero_drop_same_graph(lm_dir, mode, kv):
    """Hot base swap under live submissions (the twin of
    tests/test_adapters.py::test_hot_swap_zero_drop_same_executable):
    zero failed requests, the SAME bound step object, one swap counted,
    and afterwards the tokens of JAX's engine after the same swap on the
    same weights, which differ from the tokens before it. A mismatched
    shape is refused."""
    import threading

    rng = np.random.RandomState(9)
    prompt = np.asarray([2, 9, 4, 11, 6], np.int64)
    saved = port_io.read_params_file(lm_dir)
    eng = _port_engine(lm_dir, mode, lanes=3, kv=kv)
    try:
        aid, fac, alpha = _adapters(eng.adapter_store.targets)[0]
        eng.adapter_store.upload(aid, fac, alpha=alpha)
        before = eng.generate(prompt, max_new_tokens=8, timeout=600)
        bound = eng._ragged_bound
        new_w = {t: saved[t] + rng.randn(*saved[t].shape).astype(
                     np.float32) * 0.02
                 for t in sorted(eng.adapter_store.targets)}
        failures, done, stop = [], [], threading.Event()

        def pump():
            i = 0
            while not stop.is_set():
                try:
                    s = eng.submit(prompt, max_new_tokens=3,
                                   adapter=aid if i % 2 else None)
                    s.result(timeout=300)
                    done.append(1)
                except Exception as e:  # noqa: BLE001
                    failures.append(repr(e))
                i += 1

        th = threading.Thread(target=pump, daemon=True)
        th.start()
        while not done:
            th.join(0.01)
        label = eng.swap_base(new_w, version="v2")
        stop.set()
        th.join(60)
        assert not th.is_alive()
        assert label == "v2" and eng.model_version == "v2"
        assert eng.model_swaps == 1 and eng.stats()["model_swaps"] == 1
        assert eng.models_fragment()["base"]["version"] == "v2"
        assert failures == [] and len(done) >= 1
        assert eng._ragged_bound is bound
        after = eng.generate(prompt, max_new_tokens=8, timeout=600)
        after_ad = eng.generate(prompt, max_new_tokens=8, adapter=aid,
                                timeout=600)
        assert after != before
        with pytest.raises(ValueError, match="signature-identical"):
            eng.swap_base({"dec0_qkv.w": np.zeros((3, 3), "float32")})
        with pytest.raises(ValueError, match="signature-identical"):
            eng.swap_base({"dec0_nope.w": np.zeros((3, 3), "float32")})
        assert eng.model_swaps == 1
    finally:
        eng.close(drain=True)
    with _jax_engine(lm_dir, mode, lanes=3, kv=kv) as jeng:
        jeng.adapter_store.upload(factors=fac, adapter_id=aid, alpha=alpha)
        assert jeng.generate(prompt, max_new_tokens=8, timeout=600) == before
        jeng.swap_base(new_w, version="v2")
        assert jeng.generate(prompt, max_new_tokens=8, timeout=600) == after
        assert jeng.generate(prompt, max_new_tokens=8, adapter=aid,
                             timeout=600) == after_ad


def test_adapter_missing_refcounts_and_forced_eviction(lm_dir):
    """AdapterMissing at submit; adapters pinned from submit to the
    request's end; a forced eviction fails only that adapter's rows, at
    the next step."""
    eng = _port_engine(lm_dir, "int8", lanes=3, start=False)
    st = eng.adapter_store
    with pytest.raises(AdapterMissing):
        eng.submit(PROMPTS[0], max_new_tokens=2, adapter="ghost")
    for aid, fac, alpha in _adapters(st.targets)[:2]:
        st.upload(aid, fac, alpha=alpha)
    doomed = eng.submit(PROMPTS[0], max_new_tokens=6, adapter="ad0")
    kept = eng.submit(PROMPTS[1], max_new_tokens=6, adapter="ad1")
    base = eng.submit(PROMPTS[2], max_new_tokens=6)
    assert [r["refcount"] for r in st.resident()] == [1, 1]
    with pytest.raises(AdapterInUse):
        st.evict("ad0")
    st.evict("ad0", force=True)
    eng.start()
    assert len(kept.result(timeout=600)) == 6
    assert len(base.result(timeout=600)) == 6
    with pytest.raises(Exception, match="vanished"):
        doomed.result(timeout=600)
    assert doomed.finish_reason == "error"
    eng.close()
    assert [r["refcount"] for r in st.resident()] == [0]
    frag = eng.models_fragment()
    assert [r["id"] for r in frag["adapters"]] == ["ad1"]
    assert frag["base"]["quantized"] == "int8"
    plain = _port_engine(lm_dir, "off", lanes=2, kv="float32", store=False,
                         start=False)
    with pytest.raises(ValueError, match="no adapter store"):
        plain.submit(PROMPTS[0], max_new_tokens=2, adapter="ad1")
    plain.close()


def test_adapter_flags_build_a_store(lm_dir):
    pred = _port_pred(lm_dir)
    set_flags({"adapter_pool_max_bytes": 1, "adapter_slots_per_bucket": 3,
               "adapter_rank_buckets": "4,8", "adapter_tenant_quota": 2})
    try:
        eng = GenerationEngine(pred, pred.gpt_config, start=False)
    finally:
        set_flags({"adapter_pool_max_bytes": 0, "adapter_slots_per_bucket": 0,
                   "adapter_rank_buckets": "8,16", "adapter_tenant_quota": 0})
    st = eng.adapter_store
    assert st is not None and st.rank_buckets == (4, 8)
    assert st.slots == (4, 4) and st.tenant_quota == 2
    assert eng.lora_report.n_repointed == 9
    eng.close()
