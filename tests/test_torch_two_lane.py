"""The port's two_lane engine and its paged decode attention (K13)
against the JAX package, on the CPU.

One tiny GPT (the config of tests/test_torch_generation.py) is built and
saved by the JAX package; the port loads the same directory.

(a) ``paged_attention_plain`` (what the K13 wrapper runs on CPU
    tensors) against ``_reference_paged_attention``: grouped-query heads,
    length-0 rows, partial pages and a full block table, float32 within
    1e-5 and bfloat16 within 2e-2 (one bfloat16 rounding of the output);
(b) one prefill call and one decode step of ``PrefillStepModel`` /
    ``DecodeStepModel`` against ``build_prefill_program`` /
    ``build_decode_program``: the same tokens, pools within 1e-5;
(c) the two_lane engine's tokens equal the JAX two_lane engine's and the
    port's ragged engine's, through bucket boundaries, eviction with
    resume and lane churn, with ``use_flash_attention`` off and on;
    cancel and deadline retire as in ragged mode; the cache is intact
    and holds no page after close;
(d) the constructor's mode checks are the JAX engine's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.generation import GenerationEngine as JaxEngine
from paddle_tpu.generation.model import CacheGeometry as JaxGeometry
from paddle_tpu.generation.model import GPTConfig as JaxGPTConfig
from paddle_tpu.generation.model import (build_decode_program,
                                         build_lm_program,
                                         build_prefill_program)
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_create_predictor
from paddle_tpu.kernels.paged_attention import (
    _reference_paged_attention as jax_reference)

from paddle_tpu_torch import set_flags
from paddle_tpu_torch.generation import (CacheGeometry, DecodeStepModel,
                                         GenerationEngine, PrefillStepModel)
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.kernels import paged_attention, paged_attention_plain
from paddle_tpu_torch.serving import DeadlineExceeded, RequestCancelled

CFG = JaxGPTConfig(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                   ffn_size=64, max_position=64, hidden_dropout=0.0,
                   attention_dropout=0.0)
SEQ = 48


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_two_lane_lm"))
    main, startup, _feeds, fetches = build_lm_program(CFG, SEQ)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.TPUPlace())
        exe.run(startup)
        fluid.io.save_inference_model(d, ["tokens"], [fetches["logits"]],
                                      exe, main)
    return d


@pytest.fixture(scope="module")
def jax_pred(lm_dir):
    return jax_create_predictor(JaxConfig(lm_dir))


@pytest.fixture(scope="module")
def port_pred(lm_dir):
    return create_predictor(Config(lm_dir), device="cpu")


def _prompts(n=0, lo=3, hi=12, seed=0, lengths=None):
    rng = np.random.RandomState(seed)
    if lengths is None:
        lengths = [rng.randint(lo, hi) for _ in range(n)]
    return [rng.randint(1, CFG.vocab_size, int(L)).astype(np.int64)
            for L in lengths]


# -- (a) the paged decode attention -------------------------------------------

# (B, H, KVH, D, ps, P, maxp, lengths)
PA_CASES = {
    "mha_partial_pages": (4, 4, 4, 16, 4, 24, 6, [5, 1, 13, 24]),
    "gqa_2_of_8": (3, 8, 2, 32, 8, 12, 3, [9, 17, 2]),
    "gqa_4_of_16_zero_rows": (4, 16, 4, 8, 4, 20, 4, [0, 7, 0, 16]),
    "full_table": (2, 2, 1, 64, 16, 6, 2, [32, 32]),
    "length_past_table": (2, 2, 2, 8, 4, 8, 2, [9, 3]),
}


def _pa_inputs(case, dtype, seed=0):
    B, H, KVH, D, ps, P, maxp, lengths = PA_CASES[case]
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(KVH, P, ps, D).astype(np.float32)
    vp = rng.randn(KVH, P, ps, D).astype(np.float32)
    # each row its own pages (page 0, the junk page, never in a table)
    perm = rng.permutation(np.arange(1, P))
    tables = np.zeros((B, maxp), np.int32)
    k = 0
    for b in range(B):
        for j in range(maxp):
            tables[b, j] = perm[k % len(perm)]
            k += 1
    if dtype == "bfloat16":
        q, kp, vp = (torch.tensor(a).bfloat16().float().numpy()
                     for a in (q, kp, vp))
    return q, kp, vp, np.asarray(lengths, np.int32), tables


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PA_CASES))
def test_paged_attention_plain_matches_jax_reference(case, dtype):
    import jax.numpy as jnp

    q, kp, vp, lengths, tables = _pa_inputs(case, dtype)
    D = q.shape[-1]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jax_reference(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(lengths), jnp.asarray(tables), 1.0 / np.sqrt(D)
    ).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = paged_attention(torch.tensor(q).to(tdt), torch.tensor(kp).to(tdt),
                          torch.tensor(vp).to(tdt), torch.tensor(lengths),
                          torch.tensor(tables))
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    zero = lengths == 0
    assert np.all(got.float().numpy()[zero] == 0.0)
    assert np.all(np.isfinite(got.float().numpy()))


def test_paged_attention_checks_its_inputs():
    q, kp, vp, lengths, tables = (torch.tensor(a) for a in
                                  _pa_inputs("gqa_2_of_8", "float32"))
    with pytest.raises(TypeError, match="lengths must be int32"):
        paged_attention(q, kp, vp, lengths.long(), tables)
    with pytest.raises(ValueError, match="not a multiple"):
        paged_attention(q[:, :3], kp, vp, lengths, tables)
    with pytest.raises(ValueError, match="lengths must be"):
        paged_attention(q, kp, vp, lengths[:2], tables)
    # a custom scale reaches the plain version
    a = paged_attention(q, kp, vp, lengths, tables, sm_scale=0.5)
    b = paged_attention_plain(q, kp, vp, lengths, tables, 0.5)
    assert torch.equal(a, b)


# -- (b) one prefill call and one decode step -----------------------------------


def _pools(rng, P, ps):
    shape = (CFG.num_heads, P, ps, CFG.hidden_size // CFG.num_heads)
    return ([rng.randn(*shape).astype(np.float32)
             for _ in range(CFG.num_layers)],
            [rng.randn(*shape).astype(np.float32)
             for _ in range(CFG.num_layers)])


def _check_pools(tk, tv, outs, L):
    for i in range(L):
        for mine, ref in ((tk[i], outs[1 + i]), (tv[i], outs[1 + L + i])):
            mine, ref = mine.numpy(), np.asarray(ref)
            # every page but the junk page's slot 0 (where invalid rows
            # land in an order neither framework defines)
            np.testing.assert_allclose(mine[:, 1:], ref[:, 1:], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(mine[:, 0, 1:], ref[:, 0, 1:],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_step_matches_jax_program(flash, jax_pred, port_pred):
    """A [3, 16] window: prompts of 16, 5 and 1 tokens (the JAX program
    takes the lane count, 4; its fourth row is padding)."""
    B, S, ps, P, maxp = 4, 16, 4, 24, 16
    rng = np.random.RandomState(5)
    kps, vps = _pools(rng, P, ps)
    lens = np.array([16, 5, 1, 0], np.int32)
    tokens = np.zeros((B, S), np.int64)
    tables = np.zeros((B, maxp), np.int32)
    for i, L in enumerate(lens):
        tokens[i, :L] = rng.randint(1, CFG.vocab_size, L)
        tables[i, :-(-L // ps)] = 1 + 4 * i + np.arange(-(-L // ps))
    cfg = dataclasses.replace(CFG, use_flash_attention=flash)
    prog, fetches = build_prefill_program(
        cfg, S, JaxGeometry(num_pages=P, page_size=ps, max_pages_per_seq=maxp))
    feed = {"gen_tokens": tokens, "gen_positions": np.zeros(B, np.int64),
            "gen_num_valid": lens, "gen_last_index":
            np.maximum(lens - 1, 0).astype(np.int64),
            "gen_block_tables": tables}
    for i in range(CFG.num_layers):
        feed[f"gen_k_pages_{i}"] = kps[i]
        feed[f"gen_v_pages_{i}"] = vps[i]
    outs = fluid.Executor(fluid.TPUPlace()).run(
        prog, feed=feed, fetch_list=fetches, scope=jax_pred._scope)
    step = PrefillStepModel(port_pred.lm, CacheGeometry(P, ps, maxp),
                            use_flash=flash)
    tk = [torch.from_numpy(a.copy()) for a in kps]
    tv = [torch.from_numpy(a.copy()) for a in vps]
    n = 3     # the admitted rows only
    got = step(torch.from_numpy(tokens[:n]), torch.from_numpy(lens[:n]),
               torch.from_numpy(tables[:n]), tk, tv)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(outs[0]).reshape(-1)[:n])
    _check_pools(tk, tv, outs, CFG.num_layers)


def test_decode_step_matches_jax_program(jax_pred, port_pred):
    """Four lanes: lengths 9 (a page boundary next), 3 and 15, and an
    idle lane (JAX attends one junk slot there, the port a length-0
    row; neither token is read)."""
    B, ps, P, maxp = 4, 4, 24, 16
    rng = np.random.RandomState(6)
    kps, vps = _pools(rng, P, ps)
    lengths = np.array([9, 3, 15, 0], np.int64)
    active = np.array([1, 1, 1, 0], np.int32)
    tables = np.zeros((B, maxp), np.int32)
    for i, L in enumerate(lengths[:3]):
        need = -(-(int(L) + 1) // ps)
        tables[i, :need] = 1 + 5 * i + np.arange(need)
    tokens = rng.randint(1, CFG.vocab_size, (B, 1)).astype(np.int64)
    prog, fetches = build_decode_program(
        CFG, JaxGeometry(num_pages=P, page_size=ps, max_pages_per_seq=maxp))
    feed = {"gen_tokens": tokens, "gen_positions": lengths,
            "gen_num_valid": active,
            "gen_attend_lens": (lengths + 1).astype(np.int32),
            "gen_block_tables": tables}
    for i in range(CFG.num_layers):
        feed[f"gen_k_pages_{i}"] = kps[i]
        feed[f"gen_v_pages_{i}"] = vps[i]
    outs = fluid.Executor(fluid.TPUPlace()).run(
        prog, feed=feed, fetch_list=fetches, scope=jax_pred._scope)
    step = DecodeStepModel(port_pred.lm, CacheGeometry(P, ps, maxp))
    tk = [torch.from_numpy(a.copy()) for a in kps]
    tv = [torch.from_numpy(a.copy()) for a in vps]
    attend = np.where(active > 0, lengths + 1, 0).astype(np.int32)
    got = step(torch.from_numpy(tokens[:, 0]),
               torch.from_numpy(lengths.astype(np.int32)),
               torch.from_numpy(active), torch.from_numpy(attend),
               torch.from_numpy(tables), tk, tv)
    np.testing.assert_array_equal(got.numpy()[:3],
                                  np.asarray(outs[0]).reshape(-1)[:3])
    _check_pools(tk, tv, outs, CFG.num_layers)


# -- (c) the engine -------------------------------------------------------------

# (engine kwargs, prompts, max_new_tokens, must evict)
SCENARIOS = {
    # prompt lengths on both sides of every bucket edge
    "bucket_edges": (dict(page_size=4, num_pages=64, max_decode_batch=4,
                          prefill_buckets=(4, 8, 16)),
                     dict(lengths=[4, 5, 8, 9, 16, 17, 3]), 6, False),
    # 4 prompts over 3 lanes on a 16-page pool: eviction and resume
    "churn_eviction": (dict(page_size=4, num_pages=16, max_decode_batch=3,
                            prefill_buckets=(8, 16)),
                       dict(n=4, lo=8, hi=14, seed=7), 18, True),
    # more prompts than lanes: lanes retire and refill
    "churn": (dict(page_size=4, num_pages=64, max_decode_batch=2,
                   prefill_buckets=(16,)),
              dict(n=6, lo=3, hi=12, seed=13), 7, False),
}


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_two_lane_tokens_match_jax_and_ragged(scenario, flash, jax_pred,
                                              port_pred):
    kw, pspec, max_new, must_evict = SCENARIOS[scenario]
    prompts = _prompts(**pspec)
    cfg = dataclasses.replace(CFG, use_flash_attention=flash)
    with JaxEngine(jax_pred, cfg, mode="two_lane", **kw) as eng:
        want = [s.result(timeout=600) for s in
                [eng.submit(p, max_new_tokens=max_new) for p in prompts]]
    with GenerationEngine(port_pred, cfg, mode="two_lane", **kw) as eng:
        streams = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        got = [s.result(timeout=600) for s in streams]
        st = eng.stats()
    assert got == want
    assert all(s.finish_reason == "length" for s in streams)
    assert (st["evicted_total"] >= 1) == must_evict
    assert st["cache"]["pages_in_use"] == 0
    eng.cache.check_integrity()
    assert st["prefill_batches_total"] >= 1 and st["ragged_steps_total"] == 0
    assert st["prefill_rows_total"] >= len(prompts)
    ragged_kw = {k: v for k, v in kw.items() if k != "prefill_buckets"}
    with GenerationEngine(port_pred, port_pred.gpt_config, chunk_tokens=6,
                          **ragged_kw) as eng:
        ragged = [s.result(timeout=600) for s in
                  [eng.submit(p, max_new_tokens=max_new) for p in prompts]]
    assert got == ragged


def test_two_lane_cancel_and_deadline(port_pred):
    eng = GenerationEngine(port_pred, port_pred.gpt_config, mode="two_lane",
                           page_size=4, num_pages=32, max_decode_batch=2,
                           start=False)
    cancelled = eng.submit([1, 2, 3], max_new_tokens=4)
    expired = eng.submit([4, 5, 6], max_new_tokens=4, deadline_ms=0.0)
    served = eng.submit([7, 8, 9], max_new_tokens=3)
    assert cancelled.cancel()
    eng.start()
    assert len(served.result(timeout=120)) == 3
    with pytest.raises(RequestCancelled):
        cancelled.result(timeout=120)
    with pytest.raises(DeadlineExceeded):
        expired.result(timeout=120)
    # a running sequence cancelled mid-decode retires at the next step,
    # keeping the tokens it streamed
    long_run = eng.submit(list(range(1, 10)), max_new_tokens=40)
    first = next(iter(long_run))
    assert long_run.cancel()
    toks = long_run.result(timeout=120)
    assert long_run.finish_reason == "cancelled"
    assert toks[0] == first and len(toks) < 40
    eng.close()
    assert eng.stats()["cache"]["pages_in_use"] == 0
    eng.cache.check_integrity()


def test_two_lane_warmup_and_bucket_ladder(port_pred):
    with GenerationEngine(port_pred, port_pred.gpt_config, mode="two_lane",
                          page_size=4, num_pages=32, max_decode_batch=2,
                          prefill_buckets=(8, 32, 1000), warmup=True) as eng:
        # max_position (64) is always on the ladder; larger ones clip to it
        assert eng._seq_buckets == (8, 32, 64)
        assert eng._seq_bucket(1) == 8 and eng._seq_bucket(9) == 32
        assert eng._seq_bucket(33) == 64
        st = eng.stats()
        assert st["prefill_batches_total"] == 0       # warmup left no trace
        assert st["cache"]["pages_in_use"] == 0
        toks = eng.generate(list(range(1, 12)), max_new_tokens=5)
        st = eng.stats()
    assert len(toks) == 5
    assert st["prefill_ms"]["count"] == 1 and st["prefill_rows_total"] == 1
    assert st["decode_steps_total"] == 4


# -- (d) the constructor ----------------------------------------------------------


@pytest.mark.parametrize("option,match", [
    (dict(kv_dtype="int8"), "int8 KV pages require the ragged engine"),
    (dict(prefix_cache=True), "prefix caching requires the ragged engine"),
    (dict(spec_tokens=3, draft=object()),
     "speculative decoding requires the ragged engine"),
    (dict(adapter_store=object()),
     "adapter multiplexing requires the ragged engine")])
def test_two_lane_refuses_ragged_only_options(port_pred, option, match):
    with pytest.raises(ValueError, match=match):
        GenerationEngine(port_pred, port_pred.gpt_config, mode="two_lane",
                         start=False, **option)


def test_mode_flag_and_bad_mode(port_pred):
    set_flags({"generation_engine_mode": "two_lane"})
    try:
        eng = GenerationEngine(port_pred, port_pred.gpt_config, start=False)
        assert eng.mode == "two_lane"
    finally:
        set_flags({"generation_engine_mode": "ragged"})
    with pytest.raises(ValueError, match="'ragged' or 'two_lane'"):
        GenerationEngine(port_pred, port_pred.gpt_config, mode="sideways",
                         start=False)


def test_two_lane_serves_quantized_weights(lm_dir):
    """The quantize seam applies to the modules the lanes share: int8
    weights give the same tokens through the two_lane and the ragged
    engine (one set of quantized weights, the predictor's)."""
    pred = create_predictor(Config(lm_dir), device="cpu")
    prompts = _prompts(3, lo=5, hi=20, seed=21)
    out = {}
    for mode in ("two_lane", "ragged"):
        with GenerationEngine(pred, pred.gpt_config, mode=mode, page_size=4,
                              num_pages=64, max_decode_batch=2,
                              quantize_weights="int8",
                              prefill_buckets=(8, 16)) as eng:
            out[mode] = [s.result(timeout=300) for s in
                         [eng.submit(p, max_new_tokens=6) for p in prompts]]
            assert eng.quantize_report is pred.quantize_report
    assert out["two_lane"] == out["ragged"]
    assert pred.quantize_report.n_quantized == 4 * CFG.num_layers + 1
