"""paddle_tpu_torch's int8 KV pages (K2q's plain path,
``quantized_kv_cache_write``, the int8 ``PagedKVCache`` and the fully
quantized ragged engine) against the JAX package, on the CPU.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.generation import GenerationEngine as JaxEngine
from paddle_tpu.generation.kvcache import PagedKVCache as JaxCache
from paddle_tpu.generation.model import CacheGeometry as JaxGeometry
from paddle_tpu.generation.model import GPTConfig as JaxGPTConfig
from paddle_tpu.generation.model import (build_lm_program,
                                         build_ragged_step_program)
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_create_predictor
from paddle_tpu.kernels.quant import blockwise_error_bound as jax_bound
from paddle_tpu.kernels.ragged_paged_attention import \
    quantized_kv_cache_write as jax_qwrite
from paddle_tpu.kernels.ragged_paged_attention import \
    ragged_paged_attention as jax_ragged
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.generation import (CacheGeometry, GenerationEngine,
                                         PagedKVCache, RaggedStepModel)
from paddle_tpu_torch.generation.model import step_feeds
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.kernels.quant import (blockwise_dequantize,
                                            blockwise_error_bound,
                                            blockwise_quantize)

CFG = JaxGPTConfig(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                   ffn_size=64, max_position=64, hidden_dropout=0.0,
                   attention_dropout=0.0)
SEQ = 40


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _write_case(seed=0, H=4, P=12, ps=4, D=16):
    """A mixed write: a prefill chunk from 0, a decode row over 6
    tokens, a mid-prompt chunk, an idle lane (its rows go to the junk
    page)."""
    rng = np.random.RandomState(seed)
    B, S = 4, 5
    tables = np.zeros((B, 4), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :2] = [3, 4]
    tables[2, :3] = [5, 6, 7]
    positions = np.array([0, 6, 4, 0], np.int32)
    nvalid = np.array([5, 1, 3, 0], np.int32)
    k_new = (rng.randn(B, S, H, D) * 2).astype(np.float32)
    v_new = rng.randn(B, S, H, D).astype(np.float32)
    k_new[0, 1, 2] = 0.0            # an all-zero row: scale 1.0
    return (H, P, ps, D), tables, positions, nvalid, k_new, v_new


def test_blockwise_quantize_equals_jax():
    import jax.numpy as jnp

    from paddle_tpu.kernels.quant import blockwise_quantize as jbq

    x = np.random.RandomState(3).randn(9, 16).astype(np.float32) * 3
    x[4] = 0.0
    jq, js = jbq(jnp.asarray(x))
    pq, ps = blockwise_quantize(_t(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert ps[4] == 1.0
    err = np.abs(blockwise_dequantize(pq, ps).numpy() - x).max()
    assert err <= blockwise_error_bound(x, 16) + 1e-7
    assert blockwise_error_bound(x, 16) == jax_bound(x, 16)


def test_quantized_kv_write_equals_jax_bitwise():
    import jax.numpy as jnp

    (H, P, ps, D), tables, positions, nvalid, k_new, v_new = _write_case()
    rng = np.random.RandomState(1)
    kq0 = rng.randint(-127, 128, (H, P, ps, D)).astype(np.int8)
    vq0 = rng.randint(-127, 128, (H, P, ps, D)).astype(np.int8)
    ks0 = rng.rand(H, P, ps).astype(np.float32)
    vs0 = rng.rand(H, P, ps).astype(np.float32)
    want = jax_qwrite(jnp.asarray(kq0), jnp.asarray(vq0), jnp.asarray(ks0),
                      jnp.asarray(vs0), jnp.asarray(k_new),
                      jnp.asarray(v_new), jnp.asarray(tables),
                      jnp.asarray(positions), jnp.asarray(nvalid))
    got = [_t(a.copy()) for a in (kq0, vq0, ks0, vs0)]
    K.quantized_kv_cache_write(*got, _t(k_new), _t(v_new), _t(tables),
                               _t(positions), _t(nvalid))
    for mine, ref in zip(got, want):
        mine, ref = mine.numpy(), np.asarray(ref)
        # every page but the junk page's slot 0 (where invalid rows land
        # in an order neither framework defines)
        np.testing.assert_array_equal(mine[:, 1:], ref[:, 1:])
        np.testing.assert_array_equal(mine[:, 0, 1:], ref[:, 0, 1:])


def test_quantized_kv_write_invalid_rows_touch_only_the_junk_page():
    (H, P, ps, D), tables, positions, _nv, k_new, v_new = _write_case()
    kq = torch.zeros(H, P, ps, D, dtype=torch.int8)
    vq = torch.zeros(H, P, ps, D, dtype=torch.int8)
    ks, vs = torch.ones(H, P, ps), torch.ones(H, P, ps)
    K.quantized_kv_cache_write(kq, vq, ks, vs, _t(k_new), _t(v_new),
                               _t(tables), _t(positions),
                               torch.zeros(4, dtype=torch.int32))
    assert bool((kq[:, 1:] == 0).all()) and bool((vq[:, 1:] == 0).all())
    assert bool((ks[:, 1:] == 1.0).all()) and bool((vs[:, 1:] == 1.0).all())


def test_plain_k2q_matches_jax_quantized_reference():
    """The port's plain K2q against JAX's quantized reference on the
    same int8 pools (float32 summation order: 1e-5), and against the
    float32 attention within ``blockwise_error_bound`` as
    tests/test_ragged.py holds the JAX one."""
    import jax.numpy as jnp

    (H, P, ps, D), tables, positions, nvalid, k_new, v_new = _write_case(
        seed=5)
    rng = np.random.RandomState(6)
    q = rng.randn(4, 5, H, D).astype(np.float32)
    # float pools holding only this write, and their int8 twins
    kf = np.zeros((H, P, ps, D), np.float32)
    vf = np.zeros((H, P, ps, D), np.float32)
    kfp, vfp = _t(kf), _t(vf)
    K.kv_cache_write(kfp, vfp, _t(k_new), _t(v_new), _t(tables),
                     _t(positions), _t(nvalid))
    kq = torch.zeros(H, P, ps, D, dtype=torch.int8)
    vq = torch.zeros(H, P, ps, D, dtype=torch.int8)
    ks, vs = torch.ones(H, P, ps), torch.ones(H, P, ps)
    K.quantized_kv_cache_write(kq, vq, ks, vs, _t(k_new), _t(v_new),
                               _t(tables), _t(positions), _t(nvalid))
    # rows that only attend keys this write produced
    starts = np.zeros(4, np.int32)
    got = K.ragged_paged_attention(_t(q), kq, vq, _t(starts), _t(nvalid),
                                   _t(tables), k_scales=ks, v_scales=vs)
    assert K.ragged_paged_attention_q.launches == 0   # CPU: plain path
    want = np.asarray(jax_ragged(
        jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
        jnp.asarray(starts), jnp.asarray(nvalid), jnp.asarray(tables),
        k_scales=jnp.asarray(ks.numpy()), v_scales=jnp.asarray(vs.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    f32 = K.ragged_paged_attention(_t(q), kfp, vfp, _t(starts), _t(nvalid),
                                   _t(tables)).numpy()
    bound = 8 * max(blockwise_error_bound(k_new, D),
                    blockwise_error_bound(v_new, D))
    assert np.abs(got.numpy() - f32).max() <= bound
    for b, n in enumerate(nvalid):
        assert bool((got[b, n:] == 0).all())


@pytest.mark.parametrize("H,D,ps", [(4, 8, 4), (16, 128, 16), (8, 64, 8)])
def test_page_and_pool_bytes_equal_jax(H, D, ps):
    for dtype in ("float32", "int8"):
        assert PagedKVCache.page_bytes(H, D, ps, dtype) == \
            JaxCache.page_bytes(H, D, ps, dtype)
        mine = PagedKVCache(3, H, D, num_pages=10, page_size=ps, max_seqs=2,
                            max_pages_per_seq=4, device="cpu", dtype=dtype)
        ref = JaxCache(3, H, D, num_pages=10, page_size=ps, max_seqs=2,
                       max_pages_per_seq=4, dtype=dtype)
        assert mine.pool_bytes() == ref.pool_bytes()
    i8 = PagedKVCache(2, H, D, num_pages=6, page_size=ps, max_seqs=2,
                      max_pages_per_seq=3, device="cpu", dtype="int8")
    assert i8.k_pages[0].dtype == torch.int8
    assert tuple(i8.k_scales[1].shape) == (H, 6, ps)
    assert bool((i8.v_scales[0] == 1.0).all())
    f32 = PagedKVCache(2, H, D, num_pages=6, page_size=ps, max_seqs=2,
                       max_pages_per_seq=3, device="cpu")
    assert f32.k_scales is None and not f32.quantized


# -- the step and the engine --------------------------------------------------


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_int8kv_lm"))
    main, startup, _feeds, fetches = build_lm_program(CFG, SEQ)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.TPUPlace())
        exe.run(startup)
        fluid.io.save_inference_model(d, ["tokens"], [fetches["logits"]],
                                      exe, main)
    return d


def test_int8_ragged_step_matches_jax_program(lm_dir):
    """One mixed step over int8 pools through the JAX
    build_ragged_step_program(kv_dtype="int8") and the port's step:
    same tokens, pools and scales equal outside the junk slot."""
    jpred = jax_create_predictor(JaxConfig(lm_dir))
    pred = create_predictor(Config(lm_dir), device="cpu")
    R, C, ps, P, maxp = 4, 6, 4, 24, 16
    rng = np.random.RandomState(3)
    nh, D = CFG.num_heads, CFG.hidden_size // CFG.num_heads
    L = CFG.num_layers
    kps = [rng.randint(-127, 128, (nh, P, ps, D)).astype(np.int8)
           for _ in range(L)]
    vps = [rng.randint(-127, 128, (nh, P, ps, D)).astype(np.int8)
           for _ in range(L)]
    kss = [(rng.rand(nh, P, ps) * 0.02).astype(np.float32) for _ in range(L)]
    vss = [(rng.rand(nh, P, ps) * 0.02).astype(np.float32) for _ in range(L)]
    tables = np.zeros((R, maxp), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :3] = [3, 4, 5]
    tables[2, :2] = [6, 7]
    positions = np.array([0, 9, 4, 0], np.int64)
    num_valid = np.array([6, 1, 3, 0], np.int32)
    tokens = rng.randint(1, CFG.vocab_size, (R, C)).astype(np.int64)
    pos_ids = positions[:, None] + np.arange(C)[None, :]
    prog, fetches = build_ragged_step_program(
        CFG, JaxGeometry(num_pages=P, page_size=ps, max_pages_per_seq=maxp),
        C, kv_dtype="int8")
    feed = {"gen_tokens": tokens, "gen_pos_ids": pos_ids,
            "gen_positions": positions, "gen_num_valid": num_valid,
            "gen_block_tables": tables}
    for i in range(L):
        feed[f"gen_k_pages_{i}"] = kps[i]
        feed[f"gen_v_pages_{i}"] = vps[i]
        feed[f"gen_k_scales_{i}"] = kss[i]
        feed[f"gen_v_scales_{i}"] = vss[i]
    outs = fluid.Executor(fluid.TPUPlace()).run(
        prog, feed=feed, fetch_list=fetches, scope=jpred._scope)
    want_tok = np.asarray(outs[0]).reshape(R, C)
    step = RaggedStepModel(pred.lm, CacheGeometry(P, ps, maxp), C)
    mine = [[_t(a.copy()) for a in arrs] for arrs in (kps, vps, kss, vss)]
    got_tok = step(*step_feeds(tokens, pos_ids, positions, num_valid, tables,
                               torch.device("cpu")), *mine)
    got_tok = got_tok.numpy().reshape(R, C)
    for r in range(R):
        n = int(num_valid[r])
        np.testing.assert_array_equal(got_tok[r, :n], want_tok[r, :n])
    for g, group in enumerate(mine):
        for i in range(L):
            m, ref = group[i].numpy(), np.asarray(outs[1 + g * L + i])
            # pools and scales: the same K/V rows quantize the same way;
            # allow one int8 step (and its scale's last bits) where a
            # float32 summation-order difference upstream lands a value
            # on a .5 rounding boundary
            if m.dtype == np.int8:
                assert np.abs(m[:, 1:].astype(int)
                              - ref[:, 1:].astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(m[:, 1:], ref[:, 1:], rtol=1e-5,
                                           atol=1e-7)


# tests/test_quantize.py's fully quantized scenario (4 prompts over 3
# lanes on a 16-page pool: churn, eviction with resume, chunked prefill),
# and a long prompt prefilled in chunks
SCENARIOS = {
    "churn_eviction": (dict(page_size=4, num_pages=16, max_decode_batch=3,
                            chunk_tokens=6), 7, 4, (8, 14), 14, True),
    "chunked_prefill": (dict(page_size=4, num_pages=64, max_decode_batch=2,
                             chunk_tokens=4), 9, 2, (25, 35), 8, False),
}


def _prompts(seed, n, lo_hi):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, CFG.vocab_size, int(m)).astype(np.int64)
            for m in rng.randint(*lo_hi, n)]


@pytest.mark.parametrize("weights", ["int8", "off"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_int8_kv_engine_tokens_match_jax(lm_dir, scenario, weights):
    kw, seed, n, lo_hi, max_new, must_evict = SCENARIOS[scenario]
    prompts = _prompts(seed, n, lo_hi)
    jc = JaxConfig(lm_dir)
    if weights != "off":
        jc.enable_weight_quantization(weights)
    with JaxEngine(jax_create_predictor(jc), CFG, kv_dtype="int8",
                   quantize_weights=weights, **kw) as eng:
        want = [s.result(timeout=600) for s in
                [eng.submit(p, max_new_tokens=max_new) for p in prompts]]
    pred = create_predictor(Config(lm_dir), device="cpu")
    with GenerationEngine(pred, pred.gpt_config, kv_dtype="int8",
                          quantize_weights=weights, **kw) as eng:
        streams = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        got = [s.result(timeout=600) for s in streams]
        st = eng.stats()
        assert eng.cache.quantized
        assert eng.cache.k_pages[0].dtype == torch.int8
    assert got == want
    assert (st["evicted_total"] >= 1) == must_evict
    assert st["cache"]["pages_in_use"] == 0
    eng.cache.check_integrity()
    if weights != "off":
        assert eng.quantize_report.n_quantized == 9


def test_kv_dtype_flag_and_refusals(lm_dir):
    pred = create_predictor(Config(lm_dir), device="cpu")
    set_flags({"generation_kv_dtype": "int8"})
    try:
        eng = GenerationEngine(pred, pred.gpt_config, start=False)
    finally:
        set_flags({"generation_kv_dtype": "float32"})
    assert eng.kv_dtype == "int8" and eng.cache.quantized
    assert eng.models_fragment()["base"]["kv_dtype"] == "int8"
    eng.close()
    # the parameter wins over the flag
    eng = GenerationEngine(pred, pred.gpt_config, kv_dtype="float32",
                           start=False)
    assert not eng.cache.quantized
    eng.close()
    with pytest.raises(ValueError, match="kv_dtype"):
        GenerationEngine(pred, pred.gpt_config, kv_dtype="int4", start=False)
