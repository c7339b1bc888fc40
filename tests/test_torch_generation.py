"""paddle_tpu_torch's serving slice against the JAX package, on the CPU.

One tiny GPT (the config of tests/test_ragged.py) is built and saved by
the JAX package; the port loads the same directory. The port's
predictor, one ragged step and the whole ragged engine are held
against their JAX counterparts on the same inputs.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.generation import GenerationEngine as JaxEngine
from paddle_tpu.generation.model import CacheGeometry as JaxGeometry
from paddle_tpu.generation.model import GPTConfig as JaxGPTConfig
from paddle_tpu.generation.model import (build_lm_program,
                                         build_ragged_step_program)
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_create_predictor
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.generation import (CacheGeometry, GenerationEngine,
                                         RaggedStepModel, load_jax_params)
from paddle_tpu_torch.generation.model import GPTLM, step_feeds
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.serving import (DeadlineExceeded, EngineClosed,
                                      Overloaded, RequestCancelled)

CFG = JaxGPTConfig(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                   ffn_size=64, max_position=64, hidden_dropout=0.0,
                   attention_dropout=0.0)
SEQ = 48


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_port_lm"))
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


def _prompts(n, lo=3, hi=12, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, CFG.vocab_size, rng.randint(lo, hi))
            .astype(np.int64) for _ in range(n)]


# -- weights and config -------------------------------------------------------


def test_load_params_carries_every_name(lm_dir, port_pred):
    params = port_io.read_params_file(lm_dir)
    lm = port_pred.lm
    assert set(params) == set(lm.jax_params())
    for name, t in lm.jax_params().items():
        np.testing.assert_array_equal(t.detach().numpy(), params[name])
    # tensors are taken as well as arrays
    fresh = GPTLM(port_pred.gpt_config, device="cpu")
    load_jax_params(fresh, {k: torch.from_numpy(v) for k, v in params.items()})
    assert torch.equal(fresh.head.w, lm.head.w)


def test_load_jax_params_refuses_missing_and_misshaped(lm_dir, port_pred):
    params = port_io.read_params_file(lm_dir)
    fresh = GPTLM(port_pred.gpt_config, device="cpu")
    missing = dict(params)
    del missing["dec1_ffn2.b"]
    with pytest.raises(KeyError, match="dec1_ffn2.b"):
        load_jax_params(fresh, missing)
    bad = dict(params)
    bad["dec0_qkv.w"] = bad["dec0_qkv.w"].T
    with pytest.raises(ValueError, match="dec0_qkv.w"):
        load_jax_params(fresh, bad)
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_params(fresh, dict(params, dec2_ln1=np.zeros(1)))


def test_config_read_from_the_saved_directory(lm_dir, port_pred):
    cfg = port_io.gpt_config_from_model(port_io.read_params_file(lm_dir),
                                        port_io.load_model_meta(lm_dir))
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "ffn_size", "max_position"):
        assert getattr(cfg, field) == getattr(CFG, field), field
    assert port_pred.gpt_config == cfg


# -- predictor and one step -----------------------------------------------------


def test_predictor_logits_match_jax(jax_pred, port_pred):
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, CFG.vocab_size, (2, SEQ)).astype(np.int64)
    (want,) = jax_pred.run([tokens])
    (got,) = port_pred.run([tokens])
    assert got.shape == (2, SEQ, CFG.vocab_size)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    # a clone shares the weights
    (again,) = port_pred.clone().run([tokens])
    np.testing.assert_array_equal(again, got)


def test_ragged_step_matches_jax_program(jax_pred, port_pred):
    """One mixed step (prefill chunk from 0, decode row over a 9-token
    prefix, mid-prompt chunk, idle lane) through the JAX
    build_ragged_step_program and the port's RaggedStepModel: same
    tokens, same pools."""
    R, C, ps, P, maxp = 4, 6, 4, 24, 16
    rng = np.random.RandomState(3)
    H, nh = CFG.hidden_size, CFG.num_heads
    shape = (nh, P, ps, H // nh)
    kps = [rng.randn(*shape).astype(np.float32) for _ in range(CFG.num_layers)]
    vps = [rng.randn(*shape).astype(np.float32) for _ in range(CFG.num_layers)]
    tables = np.zeros((R, maxp), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :3] = [3, 4, 5]
    tables[2, :2] = [6, 7]
    positions = np.array([0, 9, 4, 0], np.int64)
    num_valid = np.array([6, 1, 3, 0], np.int32)
    tokens = rng.randint(1, CFG.vocab_size, (R, C)).astype(np.int64)
    pos_ids = positions[:, None] + np.arange(C)[None, :]

    prog, fetches = build_ragged_step_program(
        CFG, JaxGeometry(num_pages=P, page_size=ps, max_pages_per_seq=maxp), C)
    feed = {"gen_tokens": tokens, "gen_pos_ids": pos_ids,
            "gen_positions": positions, "gen_num_valid": num_valid,
            "gen_block_tables": tables}
    for i in range(CFG.num_layers):
        feed[f"gen_k_pages_{i}"] = kps[i]
        feed[f"gen_v_pages_{i}"] = vps[i]
    exe = fluid.Executor(fluid.TPUPlace())
    outs = exe.run(prog, feed=feed, fetch_list=fetches, scope=jax_pred._scope)
    L = CFG.num_layers
    want_tok = np.asarray(outs[0]).reshape(R, C)

    step = RaggedStepModel(port_pred.lm, CacheGeometry(P, ps, maxp), C)
    tk = [torch.from_numpy(a.copy()) for a in kps]
    tv = [torch.from_numpy(a.copy()) for a in vps]
    got_tok = step(*step_feeds(tokens, pos_ids, positions, num_valid, tables,
                               torch.device("cpu")), tk, tv)
    got_tok = got_tok.numpy().reshape(R, C)
    for r in range(R):
        n = int(num_valid[r])
        np.testing.assert_array_equal(got_tok[r, :n], want_tok[r, :n])
    for i in range(L):
        for mine, ref in ((tk[i], outs[1 + i]), (tv[i], outs[1 + L + i])):
            mine, ref = mine.numpy(), np.asarray(ref)
            # every page but the junk page's slot 0 (where invalid rows
            # land in an order neither framework defines)
            np.testing.assert_allclose(mine[:, 1:], ref[:, 1:],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(mine[:, 0, 1:], ref[:, 0, 1:],
                                       rtol=1e-5, atol=1e-5)


# -- the engine ---------------------------------------------------------------------

# (engine kwargs, prompts, max_new_tokens, must evict)
SCENARIOS = {
    # tests/test_ragged.py: 4 prompts over 3 lanes on a 16-page pool —
    # churn, eviction and resume, chunked prefill on the way
    "churn_eviction": (dict(page_size=4, num_pages=16, max_decode_batch=3,
                            chunk_tokens=6),
                       dict(n=4, lo=8, hi=14, seed=7), 18, True),
    # a prompt much longer than the chunk prefills across steps
    "chunked_prefill": (dict(page_size=4, num_pages=64, max_decode_batch=4,
                             chunk_tokens=4),
                        dict(n=1, lo=30, hi=40, seed=9), 8, False),
    # more prompts than lanes on a roomy pool: lanes retire and refill
    "churn": (dict(page_size=4, num_pages=64, max_decode_batch=2,
                   chunk_tokens=5),
              dict(n=6, lo=3, hi=12, seed=13), 7, False),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_tokens_match_jax_engine(scenario, jax_pred, port_pred):
    kw, pspec, max_new, must_evict = SCENARIOS[scenario]
    prompts = _prompts(**pspec)
    with JaxEngine(jax_pred, CFG, mode="ragged", **kw) as eng:
        want = [s.result(timeout=600) for s in
                [eng.submit(p, max_new_tokens=max_new) for p in prompts]]
    with GenerationEngine(port_pred, port_pred.gpt_config, **kw) as eng:
        streams = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        got = [s.result(timeout=600) for s in streams]
        st = eng.stats()
        eng.cache.check_integrity()
    assert got == want
    assert all(s.finish_reason == "length" for s in streams)
    assert (st["evicted_total"] >= 1) == must_evict
    assert st["cache"]["pages_in_use"] == 0
    eng.cache.check_integrity()
    if scenario == "chunked_prefill":
        assert st["prefill_chunks_total"] >= -(-int(prompts[0].size) // 4)


def test_engine_matches_its_predictor_greedy(port_pred):
    """The engine's tokens are the predictor's greedy continuation (the
    oracle chip_smoke.py applies on the card), streamed in order."""
    p = _prompts(1, lo=10, hi=11, seed=17)[0]
    with GenerationEngine(port_pred, port_pred.gpt_config, page_size=4,
                          num_pages=32, max_decode_batch=2,
                          chunk_tokens=4, warmup=True) as eng:
        stream = eng.submit(p, max_new_tokens=6)
        streamed = list(stream)
    toks = list(p)
    for want in streamed:
        logits = port_pred.lm(torch.as_tensor(np.asarray(toks)[None]))
        assert int(torch.argmax(logits[0, -1])) == want
        toks.append(want)
    assert stream.result() == streamed


def test_overloaded_when_a_request_can_never_fit_or_queue_is_full(port_pred):
    eng = GenerationEngine(port_pred, port_pred.gpt_config, page_size=4,
                           num_pages=4, max_decode_batch=2, queue_capacity=2,
                           start=False)
    with pytest.raises(Overloaded, match="pages"):
        eng.submit(np.arange(1, 11), max_new_tokens=8)   # 18 tokens > 12
    eng.submit([1, 2], max_new_tokens=2)
    eng.submit([3, 4], max_new_tokens=2)
    with pytest.raises(Overloaded, match="queue full"):
        eng.submit([5, 6], max_new_tokens=2)
    assert eng.stats()["rejected_total"] == 2
    eng.close()
    with pytest.raises(EngineClosed):
        eng.submit([1], max_new_tokens=1)


def test_cancel_and_deadline_retire_requests(port_pred):
    eng = GenerationEngine(port_pred, port_pred.gpt_config, page_size=4,
                           num_pages=32, max_decode_batch=2, start=False)
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
    assert (cancelled.finish_reason, expired.finish_reason) == (
        "cancelled", "deadline")
    eng.close()
    assert eng.stats()["cache"]["pages_in_use"] == 0


# kv_dtype="int8", quantize_weights, adapter_store, mode="two_lane",
# speculative decoding, the prefix cache and the page store are ported
# (see tests/test_torch_{int8_kv,quant,adapters,two_lane,spec,radix,
# disagg}.py): the first four cases construct as the JAX engine does (a
# page store of each package's own for option3); a page store together
# with an adapter store is refused with ValueError, where the JAX engine
# would splice one adapter's K/V into another's row (the store keys a
# page by its tokens alone)
_STORE = "page store"


@pytest.mark.parametrize("option,ported", [
    pytest.param(dict(spec_tokens=3, draft=object()), True, id="option0"),
    pytest.param(dict(prefix_cache=True), True, id="option1"),
    pytest.param(dict(quantize_weights="int8", prefix_cache=True), True,
                 id="option2"),
    pytest.param(dict(page_store=_STORE, prefix_cache=True, phase="decode"),
                 True, id="option3"),
    pytest.param(dict(adapter_store=object(), page_store=object()), False,
                 id="option4")])
def test_options_not_ported_yet_are_refused(lm_dir, port_pred, option,
                                            ported):
    if not ported:
        with pytest.raises(ValueError, match="page_store cannot be combined "
                                             "with an adapter store"):
            GenerationEngine(port_pred, port_pred.gpt_config, start=False,
                             adapter_store=_port_store(port_pred),
                             page_store=object())
        return
    from paddle_tpu.disagg import HostPageStore as JaxStore
    from paddle_tpu_torch.disagg import HostPageStore
    # a predictor of its own: quantize_weights rewrites the shared model
    jax_pred = jax_create_predictor(JaxConfig(lm_dir))
    pred = create_predictor(Config(lm_dir), device="cpu")
    jopt, opt = dict(option), dict(option)
    if option.get("page_store") == _STORE:
        jopt["page_store"] = JaxStore(16)
        opt["page_store"] = HostPageStore(16)
    want = JaxEngine(jax_pred, CFG, start=False, **jopt)
    eng = GenerationEngine(pred, pred.gpt_config, start=False, **opt)
    for attr in ("spec_tokens", "chunk_tokens", "prefix_cache",
                 "quantize_weights", "phase"):
        assert getattr(eng, attr) == getattr(want, attr), attr
    assert eng.cache.prefix_cache == want.cache.prefix_cache
    assert eng.stats()["radix"] == want.stats()["radix"]
    assert eng.stats().get("store") == want.stats().get("store")
    want.close()
    eng.close()


def _port_store(pred):
    from paddle_tpu_torch.adapters import AdapterStore

    return AdapterStore.for_model(pred.lm, rank_buckets=(8,),
                                  slots_per_bucket=1)


# what the JAX engine does with these: two_lane constructs, and int8 KV
# pages with two_lane raise its ValueError
@pytest.mark.parametrize("option,error", [
    (dict(mode="two_lane"), None),
    (dict(kv_dtype="int8", mode="two_lane"), ValueError)])
def test_two_lane_options_behave_as_in_jax(port_pred, jax_pred, option,
                                           error):
    if error is None:
        JaxEngine(jax_pred, CFG, start=False, **option).close()
        eng = GenerationEngine(port_pred, port_pred.gpt_config, start=False,
                               **option)
        assert eng.mode == "two_lane"
        eng.close()
        return
    with pytest.raises(error, match="ragged engine") as jerr:
        JaxEngine(jax_pred, CFG, start=False, **option)
    with pytest.raises(error) as terr:
        GenerationEngine(port_pred, port_pred.gpt_config, start=False,
                         **option)
    assert str(terr.value) == str(jerr.value)


def test_engine_refuses_a_config_that_is_not_the_model(port_pred):
    other = JaxGPTConfig.tiny()
    with pytest.raises(ValueError, match="does not match"):
        GenerationEngine(port_pred, other, start=False)


def test_entry_points_need_cuda_unless_asked_for_cpu(lm_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_predictor(Config(lm_dir))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
