"""paddle_tpu_torch's speculative decoding (``generation/draft.py`` and
the ragged engine's spec path) against the JAX package, on the CPU.

One tiny GPT is built and saved by the JAX package; the port loads the
same directory. ``HostDraft.propose`` is held against JAX's on the same
weights, and the spec engines (full-replica, truncated and garbage
drafts) against JAX's spec engine and the port's spec-off engine:
tokens exactly, and on a serial run the spec counters and each stream's
``usage()``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.generation import GenerationEngine as JaxEngine
from paddle_tpu.generation import HostDraft as JaxHostDraft
from paddle_tpu.generation.model import GPTConfig as JaxGPTConfig
from paddle_tpu.generation.model import build_lm_program
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_create_predictor
from paddle_tpu_torch.generation import (DraftModel, GenerationEngine,
                                         HostDraft)
from paddle_tpu_torch.inference import Config, create_predictor

CFG = JaxGPTConfig(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                   ffn_size=64, max_position=64, hidden_dropout=0.0,
                   attention_dropout=0.0)
SEQ = 48


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_spec_lm"))
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


class _GarbageDraft(DraftModel):
    """Adversarial draft: confidently wrong proposals (as in
    tests/test_ragged.py)."""

    def propose(self, contexts, k):
        return [np.full(k, 1, np.int64) for _ in contexts]


class _BrokenDraft(DraftModel):
    def __init__(self):
        self.calls = 0

    def propose(self, contexts, k):
        self.calls += 1
        raise RuntimeError("draft failed")


def _drafts(kind, jax_pred, port_pred):
    """(JAX draft, port draft) of one kind, over the same weights."""
    if kind == "garbage":
        return _GarbageDraft(), _GarbageDraft()
    n = None if kind == "replica" else 1
    return (JaxHostDraft.from_predictor(jax_pred, CFG, num_layers=n),
            HostDraft.from_predictor(port_pred, port_pred.gpt_config,
                                     num_layers=n))


def _serve(eng, prompts, max_new, serial):
    with eng:
        if serial:
            streams = []
            for p in prompts:
                streams.append(eng.submit(p, max_new_tokens=max_new))
                streams[-1].result(timeout=600)
        else:
            streams = [eng.submit(p, max_new_tokens=max_new)
                       for p in prompts]
        toks = [s.result(timeout=600) for s in streams]
        st = eng.stats()
        eng.cache.check_integrity()
    assert st["cache"]["pages_in_use"] == 0
    return toks, st, streams


# -- the draft -------------------------------------------------------------------

# (contexts' lengths, k, min_rows): padded rows (3 rows in a bucket of 4,
# 2 rows under min_rows 8), length buckets 16 / 32 / 64, and contexts at
# the max_position edge, where fewer than k proposals come back
PROPOSE_CASES = {
    "padded_rows": ((5, 9, 14), 3, 1),
    "min_rows": ((7, 11), 3, 8),
    "buckets": ((4, 20, 40), 4, 1),
    "edge": ((62, 61, 58, 30), 5, 1),
}


@pytest.mark.parametrize("kind", ["replica", "truncated"])
@pytest.mark.parametrize("case", sorted(PROPOSE_CASES))
def test_host_draft_propose_matches_jax(kind, case, jax_pred, port_pred):
    lens, k, min_rows = PROPOSE_CASES[case]
    jd, pd = _drafts(kind, jax_pred, port_pred)
    jd.min_rows = pd.min_rows = min_rows
    rng = np.random.RandomState(len(lens) + k)
    ctxs = [rng.randint(1, CFG.vocab_size, n).astype(np.int64)
            for n in lens]
    want = jd.propose(ctxs, k)
    got = pd.propose(ctxs, k)
    assert [list(g) for g in got] == [list(w) for w in want]
    assert all(g.dtype == np.int64 for g in got)
    if case == "edge":
        # room = max_position - len - 1 caps the proposals
        assert [len(g) for g in got] == [1, 2, 5, 5]


def test_host_draft_shares_the_predictors_weights(port_pred):
    d = HostDraft.from_predictor(port_pred, port_pred.gpt_config,
                                 num_layers=1)
    params = port_pred.lm.jax_params()
    assert d.params["gpt_head.w"] is params["gpt_head.w"]
    assert d.params["dec0_qkv.w"].data_ptr() == \
        params["dec0_qkv.w"].data_ptr()
    assert "dec1_qkv.w" not in d.params
    assert d.device == port_pred.lm.device
    assert d.propose([], 3) == [] and len(d.propose([np.ones(3)], 0)[0]) == 0


def test_host_draft_from_arrays_runs_on_the_card_by_default(port_pred,
                                                           monkeypatch):
    """Built as the JAX draft is, from arrays with no ``device``, the
    draft goes to the card: with none there it raises, never falling
    back to the CPU. With ``device="cpu"`` it proposes what the draft of
    ``from_predictor`` does."""
    arrays = {k: v.detach().numpy()
              for k, v in port_pred.lm.jax_params().items()}
    args = (arrays, CFG.num_layers, CFG.num_heads, CFG.max_position)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HostDraft(*args)
    d = HostDraft(*args, device="cpu")
    assert d.device == torch.device("cpu")
    ref = HostDraft.from_predictor(port_pred, port_pred.gpt_config)
    ctx = _prompts(3)
    for a, b in zip(d.propose(ctx, 4), ref.propose(ctx, 4)):
        np.testing.assert_array_equal(a, b)


class _DraftOnTheCard(DraftModel):
    device = torch.device("cuda", 0)


def test_engine_refuses_a_draft_on_another_device(port_pred):
    """A CPU engine refuses a draft that lies on the card (the GPU tests
    hold the converse): the draft's forward would run off the step's
    device."""
    with pytest.raises(ValueError, match="the draft is on cuda:0"):
        GenerationEngine(port_pred, port_pred.gpt_config,
                         draft=_DraftOnTheCard(), spec_tokens=2, start=False)


def test_from_predictor_refuses_quantized_weights_as_jax(lm_dir):
    jcfg = JaxConfig(lm_dir)
    jcfg.enable_weight_quantization("int8")
    with pytest.raises(ValueError, match="draft weight 'gpt_head.w'"):
        JaxHostDraft.from_predictor(jax_create_predictor(jcfg), CFG)
    pred = create_predictor(
        Config(lm_dir).enable_weight_quantization("int8"), device="cpu")
    with pytest.raises(ValueError, match="draft weight 'gpt_head.w'"):
        HostDraft.from_predictor(pred, pred.gpt_config)
    # a draft deeper than the model is refused the same way
    plain = create_predictor(Config(lm_dir), device="cpu")
    with pytest.raises(ValueError, match="draft weight 'dec2_ln1.scale'"):
        HostDraft.from_predictor(plain, plain.gpt_config, num_layers=3)


# -- the engine ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["replica", "truncated", "garbage"])
def test_spec_engine_tokens_and_counters_match_jax(kind, jax_pred,
                                                   port_pred):
    """Served one request at a time (so steps line up): the port's spec
    engine emits JAX's spec engine's tokens and its spec-off engine's,
    and the spec counters, the step count and each stream's usage equal
    JAX's."""
    prompts = _prompts(3, seed=31)
    kw = dict(page_size=4, num_pages=64, max_decode_batch=4, spec_tokens=3,
              chunk_tokens=8)
    jd, pd = _drafts(kind, jax_pred, port_pred)
    want, jst, jstreams = _serve(
        JaxEngine(jax_pred, CFG, mode="ragged", draft=jd, **kw), prompts, 10,
        serial=True)
    got, st, streams = _serve(
        GenerationEngine(port_pred, port_pred.gpt_config, draft=pd, **kw),
        prompts, 10, serial=True)
    plain, _, _ = _serve(
        GenerationEngine(port_pred, port_pred.gpt_config, page_size=4,
                         num_pages=64, max_decode_batch=4, chunk_tokens=8),
        prompts, 10, serial=True)
    assert got == want == plain
    for key in ("spec_rounds_total", "spec_proposed_total",
                "spec_accepted_total", "ragged_steps_total",
                "decode_tokens_total", "spec_acceptance_rate",
                "spec_accepted_tokens_per_step"):
        assert st[key] == jst[key], key
    assert [s.usage() for s in streams] == [s.usage() for s in jstreams]
    assert st["spec_proposed_total"] > 0
    if kind == "replica":
        assert st["spec_acceptance_rate"] > 0.5
        assert streams[0].accepted_draft_tokens > 0
    if kind == "garbage":
        assert st["spec_accepted_total"] == 0
    assert all(s.verified_tokens == 10 for s in streams)
    # the engine pins the draft's rows to its lanes
    if kind != "garbage":
        assert pd.min_rows == 4


def test_spec_engine_concurrent_matches_jax(jax_pred, port_pred):
    """More prompts than lanes, submitted at once: rows join and leave
    while others verify drafts; the tokens equal JAX's spec engine's."""
    prompts = _prompts(6, seed=5)
    kw = dict(page_size=4, num_pages=64, max_decode_batch=3, spec_tokens=4,
              chunk_tokens=5)
    jd, pd = _drafts("replica", jax_pred, port_pred)
    want, _, _ = _serve(JaxEngine(jax_pred, CFG, mode="ragged", draft=jd,
                                  **kw), prompts, 9, serial=False)
    got, st, _ = _serve(GenerationEngine(port_pred, port_pred.gpt_config,
                                         draft=pd, **kw),
                        prompts, 9, serial=False)
    assert got == want
    assert st["spec_accepted_total"] > 0


def test_spec_through_eviction_matches_jax(jax_pred, port_pred):
    """A small pool under spec: rows are evicted and resumed, speculation
    degrades to plain decode where the pool cannot hold the window, and
    the tokens stay JAX's and the port's spec-off engine's."""
    prompts = _prompts(3, lo=8, hi=12, seed=41)
    kw = dict(page_size=4, num_pages=16, max_decode_batch=3, chunk_tokens=8)
    jd, pd = _drafts("replica", jax_pred, port_pred)
    want, _, _ = _serve(JaxEngine(jax_pred, CFG, mode="ragged", draft=jd,
                                  spec_tokens=3, **kw), prompts, 16,
                        serial=False)
    got, st, _ = _serve(GenerationEngine(port_pred, port_pred.gpt_config,
                                         draft=pd, spec_tokens=3, **kw),
                        prompts, 16, serial=False)
    plain, _, _ = _serve(GenerationEngine(port_pred, port_pred.gpt_config,
                                          **kw), prompts, 16, serial=False)
    assert got == want == plain
    assert st["evicted_total"] >= 1
    assert st["spec_proposed_total"] > 0


def test_a_draft_that_raises_leaves_greedy_tokens(port_pred):
    prompts = _prompts(2, seed=37)
    kw = dict(page_size=4, num_pages=64, max_decode_batch=4, chunk_tokens=8)
    draft = _BrokenDraft()
    got, st, streams = _serve(
        GenerationEngine(port_pred, port_pred.gpt_config, draft=draft,
                         spec_tokens=3, **kw), prompts, 8, serial=True)
    plain, _, _ = _serve(GenerationEngine(port_pred, port_pred.gpt_config,
                                          **kw), prompts, 8, serial=True)
    assert got == plain
    assert st["spec_rounds_total"] == draft.calls > 0
    assert st["spec_proposed_total"] == st["spec_accepted_total"] == 0
    assert [s.usage()["accepted_draft_tokens"] for s in streams] == [0, 0]


def test_spec_options_resolve_as_in_jax(jax_pred, port_pred):
    """No draft, no speculation; the chunk widens to hold a verify row;
    the spec_tokens flag is the default; two_lane refuses spec."""
    from paddle_tpu.flags import set_flags as jax_set_flags
    from paddle_tpu_torch import set_flags

    for draft in (None, _GarbageDraft()):
        j = JaxEngine(jax_pred, CFG, mode="ragged", spec_tokens=9,
                      chunk_tokens=4, draft=draft, start=False)
        p = GenerationEngine(port_pred, port_pred.gpt_config, spec_tokens=9,
                             chunk_tokens=4, draft=draft, start=False)
        assert (p.spec_tokens, p.chunk_tokens) == (j.spec_tokens,
                                                   j.chunk_tokens)
        j.close()
        p.close()
    set_flags({"generation_spec_tokens": 2})
    jax_set_flags({"generation_spec_tokens": 2})
    try:
        p = GenerationEngine(port_pred, port_pred.gpt_config,
                             draft=_GarbageDraft(), start=False)
        j = JaxEngine(jax_pred, CFG, mode="ragged", draft=_GarbageDraft(),
                      start=False)
        assert p.spec_tokens == j.spec_tokens == 2
        p.close()
        j.close()
    finally:
        set_flags({"generation_spec_tokens": 0})
        jax_set_flags({"generation_spec_tokens": 0})
    with pytest.raises(ValueError, match="ragged engine") as jerr:
        JaxEngine(jax_pred, CFG, mode="two_lane", spec_tokens=3,
                  draft=_GarbageDraft(), start=False)
    with pytest.raises(ValueError) as perr:
        GenerationEngine(port_pred, port_pred.gpt_config, mode="two_lane",
                         spec_tokens=3, draft=_GarbageDraft(), start=False)
    assert str(perr.value) == str(jerr.value)


def test_on_token_sees_every_token_in_order(port_pred):
    seen = []
    kw = dict(page_size=4, num_pages=64, max_decode_batch=2, chunk_tokens=8)
    draft = HostDraft.from_predictor(port_pred, port_pred.gpt_config)
    with GenerationEngine(port_pred, port_pred.gpt_config, draft=draft,
                          spec_tokens=3, **kw) as eng:
        s = eng.submit(_prompts(1, seed=3)[0], max_new_tokens=9,
                       on_token=seen.append)
        toks = s.result(timeout=600)
        bad = eng.submit([5, 6, 7], max_new_tokens=3,
                         on_token=lambda t: 1 / 0)   # a bad callback
        assert len(bad.result(timeout=600)) == 3
        assert eng.queue_depth() == 0 and not eng.closed
        assert eng.stats_numeric()["spec_accepted_total"] > 0
    assert eng.closed
    assert seen == toks and len(toks) == 9
