"""paddle_tpu_torch's radix prefix cache (the refcounted trie of
``generation/kvcache.py`` and the ragged engine's ``prefix_cache``)
against the JAX package, on the CPU.

* bookkeeping parity: scripted sequences of cache operations applied to
  JAX's ``PagedKVCache`` and the port's leave equal block tables,
  lengths, refcounts, free lists (order included), ``radix_stats()`` and
  ``stats()`` after every operation, through pool pressure (LRU leaf
  eviction, acquire rollback), ``prefix_min_pages`` > 1, a trie cap and a
  tenant quota;
* the unit scenarios of ``tests/test_radix.py`` on the port's cache;
* the engine: prompts over a common prefix served warm emit exactly the
  tokens of JAX's radix engine, JAX's cold two_lane engine and the
  port's cold engine, with JAX's hit counters; churn with eviction, int8
  KV sharing, ``prefix_probe``, ``submit(tenant=)`` under a quota and a
  cancelled sibling. Every test drains: ``drop_trie``, then
  ``pages_in_use == 0``.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu.generation import GenerationEngine as JaxEngine
from paddle_tpu.generation.kvcache import PagedKVCache as JaxCache
from paddle_tpu.generation.kvcache import \
    PagePoolExhausted as JaxPagePoolExhausted
from paddle_tpu.generation.model import GPTConfig as JaxGPTConfig
from paddle_tpu.generation.model import build_lm_program
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_create_predictor
from paddle_tpu_torch import set_flags
from paddle_tpu_torch.generation import (GenerationEngine, PagedKVCache,
                                         PagePoolExhausted)
from paddle_tpu_torch.inference import Config, create_predictor

CFG = JaxGPTConfig(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                   ffn_size=64, max_position=64, hidden_dropout=0.0,
                   attention_dropout=0.0)
SEQ = 48


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_radix_lm"))
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


def _toks(*vals):
    return np.asarray(vals, dtype=np.int64)


def _cache(**kw):
    kw.setdefault("num_pages", 16)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_seqs", 4)
    kw.setdefault("max_pages_per_seq", 12)
    kw.setdefault("prefix_cache", True)
    return PagedKVCache(2, 4, 8, device="cpu", dtype="float32", **kw)


def _drain(c):
    """Flush the trie, audit, demand an empty pool."""
    c.drop_trie()
    c.check_integrity()
    assert c.stats()["pages_in_use"] == 0


# -- (a) bookkeeping parity with JAX's cache -------------------------------------

# geometry and radix options of each script; every script runs a few
# seeds. "pressure" is a pool small enough for LRU leaf eviction and
# acquire rollback; the others add a match floor, a trie cap and a
# tenant quota on a roomier pool.
PARITY_CONFIGS = {
    "pressure": dict(num_pages=11, page_size=2, max_seqs=3,
                     max_pages_per_seq=10),
    "min_pages": dict(num_pages=20, page_size=2, max_seqs=3,
                      max_pages_per_seq=10, prefix_min_pages=2),
    "trie_cap": dict(num_pages=16, page_size=2, max_seqs=3,
                     max_pages_per_seq=10, trie_max_pages=4),
    "quota": dict(num_pages=16, page_size=2, max_seqs=3,
                  max_pages_per_seq=10, tenant_quota_pages=3),
}
# each operation's weight in a script
OPS = {"acquire": 8, "allocate": 1, "advance": 6, "ensure": 2, "publish": 6,
       "release": 3, "evict": 1, "drop_trie": 0.4}


def _state(c):
    return (c.block_tables.tolist(), c.lengths.tolist(),
            [int(r) for r in c._ref], list(c._free), c.radix_stats(),
            c.stats(), [c.reclaimable_pages(s) for s in range(c.max_seqs)])


def _both(jc, pc, fn):
    """fn applied to both caches: equal results, or the same error."""
    out = []
    for c in (jc, pc):
        try:
            out.append(("ok", fn(c)))
        except (JaxPagePoolExhausted, PagePoolExhausted) as e:
            out.append(("exhausted", str(e)))
        except ValueError as e:
            out.append(("value_error", str(e)))
    assert out[0] == out[1]
    return out[0]


def _run_script(name, seed, n_ops=260):
    cfg = PARITY_CONFIGS[name]
    rng = np.random.RandomState(seed)
    jc = JaxCache(2, 4, 8, prefix_cache=True, **cfg)
    pc = PagedKVCache(2, 4, 8, device="cpu", dtype="float32",
                      prefix_cache=True, **cfg)
    ps, maxp = cfg["page_size"], cfg["max_pages_per_seq"]
    prefixes = [rng.randint(1, 9, size=n).astype(np.int64)
                for n in (6, 8, 12)]
    names = sorted(OPS)
    weights = np.asarray([OPS[n] for n in names], np.float64)
    ctx = {}         # slot -> the tokens its cache positions hold
    prompt_of = {}   # slot -> its prompt's length
    seen = {"rollback": 0, "exhausted": 0, "audit_refusals": 0,
            "max_trie": 0, "ops": {}}
    for _ in range(n_ops):
        op = names[rng.choice(len(names), p=weights / weights.sum())]
        active = [s for s in range(jc.max_seqs) if jc.is_active(s)]
        tenant = (None, "a", "b")[rng.randint(3)]
        if op == "acquire":
            pre = prefixes[rng.randint(len(prefixes))]
            cut = rng.randint(4, len(pre) + 1)
            prompt = np.concatenate([pre[:cut], rng.randint(
                1, 9, size=rng.randint(1, 5)).astype(np.int64)])
            _both(jc, pc, lambda c: (c.match_len(prompt),
                                     c.can_acquire(len(prompt), prompt),
                                     c.free_slots()))
            refs = list(jc._ref)
            res = _both(jc, pc, lambda c: c.acquire(prompt))
            if res[0] == "ok":
                ctx[res[1][0]] = list(prompt)
                prompt_of[res[1][0]] = len(prompt)
            elif "slots" not in res[1]:
                seen["exhausted"] += 1
                seen["rollback"] += int(
                    jc.match_len(prompt) > 0 and list(jc._ref) == refs)
        elif op == "allocate":
            n = int(rng.randint(1, 7))
            res = _both(jc, pc, lambda c: c.allocate_slot(n))
            if res[0] == "ok":
                ctx[res[1]] = []
                prompt_of[res[1]] = 0
        elif op == "advance" and active:
            s = active[rng.randint(len(active))]
            room = len(jc._pages_of[s]) * ps - int(jc.lengths[s])
            if room <= 0:
                continue
            # a prefill to the prompt's end first, as the engine does
            left = prompt_of[s] - int(jc.lengths[s])
            n = min(room, left) if left > 0 else int(rng.randint(1, room + 1))
            _both(jc, pc, lambda c: c.advance(s, n))
            while len(ctx[s]) < int(jc.lengths[s]):
                ctx[s].append(int(rng.randint(1, 9)))
        elif op == "ensure" and active:
            s = active[rng.randint(len(active))]
            new_len = min(int(jc.lengths[s]) + int(rng.randint(1, 6)),
                          maxp * ps + int(rng.randint(2)))
            _both(jc, pc, lambda c: c.ensure_capacity(s, new_len))
        elif op == "publish" and active:
            s = active[rng.randint(len(active))]
            toks = np.asarray(ctx[s], np.int64)
            _both(jc, pc, lambda c: c.publish(s, toks, tenant=tenant))
        elif op in ("release", "evict") and active:
            s = active[rng.randint(len(active))]
            _both(jc, pc, lambda c: getattr(c, op)(s))
            ctx.pop(s, None)
            prompt_of.pop(s, None)
        elif op == "drop_trie":
            _both(jc, pc, lambda c: c.drop_trie())
        else:
            continue
        seen["ops"][op] = seen["ops"].get(op, 0) + 1
        assert _state(jc) == _state(pc), op
        # the same audit verdict (a drop_trie under live sharing leaves
        # chains sharing pages the trie no longer holds: both refuse)
        verdict = []
        for c in (jc, pc):
            try:
                c.check_integrity()
                verdict.append(None)
            except AssertionError as e:
                verdict.append(str(e))
        assert verdict[0] == verdict[1], op
        seen["audit_refusals"] += verdict[0] is not None
        seen["max_trie"] = max(seen["max_trie"], pc.trie_pages())
    for s in range(jc.max_seqs):
        if jc.is_active(s):
            _both(jc, pc, lambda c: c.release(s))
    for c in (jc, pc):
        _drain(c)
    assert _state(jc) == _state(pc)
    return pc, seen


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(PARITY_CONFIGS))
def test_bookkeeping_matches_jax_operation_by_operation(name, seed):
    pc, seen = _run_script(name, seed)
    r = pc.radix_stats()
    assert r["prefix_hits_total"] > 0 and r["published_pages_total"] > 0
    assert set(seen["ops"]) == set(OPS)
    if name == "min_pages":
        assert r["prefix_hit_tokens_total"] >= 2 * r["prefix_hits_total"] * 2
    if name == "pressure":
        assert r["leaf_evictions_total"] > 0
        assert seen["exhausted"] > 0 and seen["rollback"] > 0
    if name == "trie_cap":
        assert seen["max_trie"] == 4 and r["leaf_evictions_total"] > 0
    if name == "quota":
        assert (r["tenant_quota_rejections_total"]
                + sum(r["tenant_leaf_evictions"].values())) > 0


# -- (b) the unit scenarios of tests/test_radix.py ---------------------------------


def test_trie_publish_match_acquire_roundtrip():
    c = _cache()
    p = np.arange(1, 13, dtype=np.int64)            # 12 tokens = 3 pages
    slot, matched = c.acquire(p)
    assert matched == 0
    c.advance(slot, 12)
    assert c.publish(slot, p) == 3
    assert c.trie_pages() == 3
    shared = list(c._pages_of[slot])
    # at least one prompt token must prefill: an exact 3-page prompt
    # matches only 2
    assert c.match_len(p) == 8
    assert c.match_len(np.concatenate([p, p[:4]])) == 12
    c.release(slot)
    assert c.trie_pages() == 3                       # survives retirement
    s2, m2 = c.acquire(np.concatenate([p, _toks(77, 78)]))
    assert m2 == 12
    assert int(c.lengths[s2]) == 12                  # the fork point
    assert list(c._pages_of[s2][:3]) == shared       # by reference
    assert c.prefix_hits_total == 1 and c.cow_forks_total == 1
    c.check_integrity()
    c.release(s2)
    _drain(c)


def test_prefix_min_pages_floor():
    c = _cache(prefix_min_pages=2)
    p8 = np.arange(1, 9, dtype=np.int64)             # 2 full pages
    slot, _ = c.acquire(p8)
    c.advance(slot, 8)
    c.publish(slot, p8)
    c.release(slot)
    assert c.match_len(p8) == 0                      # cap 1 page < floor
    assert c.match_len(np.concatenate([p8, _toks(1, 2, 3, 4)])) == 8
    _drain(c)


def test_cow_fork_isolation_and_refcounts():
    c = _cache()
    p = np.arange(1, 13, dtype=np.int64)
    a, _ = c.acquire(p)
    c.advance(a, 12)
    c.publish(a, p)
    shared = list(c._pages_of[a])
    b, mb = c.acquire(np.concatenate([p, _toks(60, 61, 62)]))
    assert mb == 12
    assert list(c._pages_of[b][:3]) == shared
    assert all(int(c._ref[pg]) == 3 for pg in shared)   # 2 chains + trie
    assert int(c._ref[c._pages_of[b][3]]) == 1
    c.advance(b, 3)
    c.ensure_capacity(b, 17)                         # decode growth
    assert list(c._pages_of[b][:3]) == shared
    assert len(c._pages_of[b]) == 5                  # fresh private pages
    c.release(a)
    assert all(int(c._ref[pg]) == 2 for pg in shared)   # sibling intact
    c.check_integrity()
    c.release(b)
    _drain(c)


def test_pool_pressure_evicts_lru_leaf_first():
    c = _cache(num_pages=8)                          # 7 usable
    pa = np.arange(1, 9, dtype=np.int64)
    pb = np.arange(11, 19, dtype=np.int64)
    for p in (pa, pb):
        s, _ = c.acquire(p)
        c.advance(s, 8)
        c.publish(s, p)
        c.release(s)
    sa, ma = c.acquire(pa)                           # refresh pa's page 1
    assert ma == 4
    c.release(sa)
    # 4 pages with 3 free: one leaf goes, the LRU one (pa's second page)
    sc, mc = c.acquire(np.arange(41, 57, dtype=np.int64))
    assert mc == 0
    assert c.leaf_evictions_total == 1
    tail = _toks(9, 9, 9, 9)
    assert c.match_len(np.concatenate([pa, tail])) == 4
    assert c.match_len(np.concatenate([pb, tail])) == 8
    c.check_integrity()
    c.release(sc)
    _drain(c)


def test_acquire_exhaustion_rolls_back_refs():
    c = _cache(num_pages=4, max_seqs=2)              # 3 usable
    p = np.arange(1, 9, dtype=np.int64)
    a, _ = c.acquire(p)
    c.advance(a, 8)
    c.publish(a, p)
    free_before = len(c._free)
    with pytest.raises(PagePoolExhausted):
        c.acquire(np.arange(21, 37, dtype=np.int64))     # cold, needs 4
    assert len(c._free) == free_before
    q = np.concatenate([p, np.arange(41, 61, dtype=np.int64)])
    with pytest.raises(PagePoolExhausted):
        c.acquire(q)                                     # 2 matched + 5
    assert all(int(c._ref[pg]) == 2 for pg in c._pages_of[a])
    c.check_integrity()
    c.release(a)
    _drain(c)


def test_reclaimable_pages_ranks_victims():
    c = _cache()
    p = np.arange(1, 13, dtype=np.int64)
    a, _ = c.acquire(p)
    c.advance(a, 12)
    assert c.reclaimable_pages(a) == 3
    c.publish(a, p)
    assert c.reclaimable_pages(a) == 3               # trie ref discounted
    b, _ = c.acquire(np.concatenate([p, _toks(7, 8)]))
    assert c.reclaimable_pages(a) == 0               # fully shared now
    assert c.reclaimable_pages(b) == 1               # its private suffix
    c.release(b)
    assert c.reclaimable_pages(a) == 3
    c.check_integrity()
    c.release(a)
    _drain(c)


def test_check_integrity_catches_seeded_refcount_leak():
    c = _cache()
    p = np.arange(1, 13, dtype=np.int64)
    s, _ = c.acquire(p)
    c.advance(s, 12)
    c.publish(s, p)
    c.check_integrity()
    victim = c._pages_of[s][0]
    c._ref[victim] += 1                              # a leak
    with pytest.raises(AssertionError, match="refcount leak"):
        c.check_integrity()
    c._ref[victim] -= 2                              # a premature free
    with pytest.raises(AssertionError, match="refcount leak"):
        c.check_integrity()
    c._ref[victim] += 1
    c.check_integrity()
    c.release(s)
    _drain(c)


# -- (c) the engine ----------------------------------------------------------------

KW = dict(page_size=4, num_pages=64, max_decode_batch=4, chunk_tokens=6)


def _shared_prompts(seed, n, pre_len=12, lo=2, hi=5):
    rng = np.random.RandomState(seed)
    pre = rng.randint(1, CFG.vocab_size, pre_len).astype(np.int64)
    return [np.concatenate([pre, rng.randint(
        1, CFG.vocab_size, rng.randint(lo, hi)).astype(np.int64)])
        for _ in range(n)]


def _serve(eng, prompts, max_new, serial=True, **submit_kw):
    """Serve and drain: tokens, the stats before drop_trie, and the
    engine (closed, its pool empty)."""
    with eng:
        if serial:
            toks = [eng.generate(p, max_new_tokens=max_new, timeout=600)
                    for p in prompts] if not submit_kw else \
                [eng.submit(p, max_new_tokens=max_new, **submit_kw)
                 .result(timeout=600) for p in prompts]
        else:
            streams = [eng.submit(p, max_new_tokens=max_new, **submit_kw)
                       for p in prompts]
            toks = [s.result(timeout=600) for s in streams]
        st = eng.stats()
        eng.cache.check_integrity()
        eng.cache.drop_trie()
        eng.cache.check_integrity()
    assert eng.stats()["cache"]["pages_in_use"] == 0
    return toks, st


def test_warm_tokens_match_jax_radix_and_cold_engines(jax_pred, port_pred):
    """Served one at a time, the first request publishes the prefix and
    the rest attach warm: the port's warm tokens equal JAX's radix
    engine's, JAX's cold two_lane engine's and the port's cold engine's;
    the hit counters equal JAX's."""
    prompts = _shared_prompts(31, 4)
    want, jst = _serve(JaxEngine(jax_pred, CFG, mode="ragged",
                                 prefix_cache=True, **KW), prompts, 8)
    two_lane, _ = _serve(JaxEngine(
        jax_pred, CFG, mode="two_lane", prefill_buckets=(16, 32),
        page_size=4, num_pages=64, max_decode_batch=4), prompts, 8)
    got, st = _serve(GenerationEngine(port_pred, port_pred.gpt_config,
                                      prefix_cache=True, **KW), prompts, 8)
    cold, cst = _serve(GenerationEngine(port_pred, port_pred.gpt_config,
                                        **KW), prompts, 8)
    assert got == want == two_lane == cold
    assert st["radix"]["prefix_hits_total"] >= 3
    for key in ("prefix_lookups_total", "prefix_hits_total",
                "prefix_hit_tokens_total", "prefix_requested_tokens_total",
                "published_pages_total", "cow_forks_total", "trie_pages"):
        assert st["radix"][key] == jst["radix"][key], key
    assert st["ragged_steps_total"] == jst["ragged_steps_total"]
    # warm prefill skips the shared pages: fewer chunks than cold
    assert st["prefill_tokens_total"] < cst["prefill_tokens_total"]
    assert cst["radix"]["enabled"] == 0


def test_churn_eviction_resume_matches_jax(jax_pred, port_pred):
    """A small pool, shared prefixes and budgets that force eviction and
    resume mid-flight: tokens equal JAX's radix engine's and the port's
    cold engine's; the pool drains to zero."""
    prompts = _shared_prompts(41, 4, pre_len=8, lo=2, hi=6)
    kw = dict(KW, num_pages=16, max_decode_batch=3)
    want, _ = _serve(JaxEngine(jax_pred, CFG, mode="ragged",
                               prefix_cache=True, **kw), prompts, 18,
                     serial=False)
    got, st = _serve(GenerationEngine(port_pred, port_pred.gpt_config,
                                      prefix_cache=True, **kw), prompts, 18,
                     serial=False)
    cold, _ = _serve(GenerationEngine(port_pred, port_pred.gpt_config, **kw),
                     prompts, 18, serial=False)
    assert got == want == cold
    assert st["evicted_total"] >= 1


def test_int8_kv_sharing_matches_jax(jax_pred, port_pred):
    """Shared int8 pages (and their scale planes) decode the cold int8
    engine's tokens, and JAX's warm int8 engine's."""
    prompts = _shared_prompts(53, 3, lo=3, hi=4)
    kw = dict(KW, kv_dtype="int8")
    want, _ = _serve(JaxEngine(jax_pred, CFG, mode="ragged",
                               prefix_cache=True, **kw), prompts, 6)
    got, st = _serve(GenerationEngine(port_pred, port_pred.gpt_config,
                                      prefix_cache=True, **kw), prompts, 6)
    cold, _ = _serve(GenerationEngine(port_pred, port_pred.gpt_config, **kw),
                     prompts, 6)
    assert got == want == cold
    assert st["radix"]["prefix_hits_total"] >= 2


def test_prefix_probe_is_a_pure_peek(jax_pred, port_pred):
    rng = np.random.RandomState(71)
    p = rng.randint(1, CFG.vocab_size, 30).astype(np.int64)
    engines = (JaxEngine(jax_pred, CFG, mode="ragged", prefix_cache=True,
                         **KW),
               GenerationEngine(port_pred, port_pred.gpt_config,
                                prefix_cache=True, **KW))
    probes = []
    for eng in engines:
        with eng:
            assert eng.prefix_probe(p) == 0
            eng.generate(p, max_new_tokens=8, timeout=600)   # publishes
            lookups = eng.stats()["radix"]["prefix_lookups_total"]
            probes.append((eng.prefix_probe(p), eng.prefix_probe(p[:9]),
                           eng.prefix_probe(p[::-1])))
            assert eng.stats()["radix"]["prefix_lookups_total"] == lookups
            eng.cache.drop_trie()
            eng.cache.check_integrity()
        assert eng.stats()["cache"]["pages_in_use"] == 0
    assert probes[0] == probes[1] == (28, 8, 0)     # the cap leaves 2
    off = GenerationEngine(port_pred, port_pred.gpt_config, start=False,
                           **KW)
    assert off.prefix_probe(p) == 0
    off.close()


def test_tenant_quota_matches_jax(jax_pred, port_pred):
    """submit(tenant=) under a per-tenant trie quota: each tenant
    recycles its own leaves; tenant_pages and the quota counters equal
    JAX's."""
    prompts = _shared_prompts(83, 4, pre_len=16, lo=4, hi=9)
    tenants = ["a", "b", "a", "b"]
    stats = []
    for pkg in ("jax", "port"):
        set_flags({"generation_trie_tenant_quota": 3})
        jax_set_flags({"generation_trie_tenant_quota": 3})
        try:
            eng = (JaxEngine(jax_pred, CFG, mode="ragged", prefix_cache=True,
                             **KW) if pkg == "jax" else
                   GenerationEngine(port_pred, port_pred.gpt_config,
                                    prefix_cache=True, **KW))
        finally:
            set_flags({"generation_trie_tenant_quota": 0})
            jax_set_flags({"generation_trie_tenant_quota": 0})
        with eng:
            toks = [eng.submit(p, max_new_tokens=6, tenant=t)
                    .result(timeout=600) for p, t in zip(prompts, tenants)]
            r = eng.stats()["radix"]
            eng.cache.check_integrity()
            eng.cache.drop_trie()
        assert eng.stats()["cache"]["pages_in_use"] == 0
        stats.append((toks, r))
    (jax_toks, jax_radix), (toks, radix) = stats
    assert toks == jax_toks
    assert radix["tenant_quota_pages"] == 3
    for key in ("tenant_pages", "tenant_leaf_evictions",
                "tenant_quota_rejections_total", "prefix_hit_tokens_total",
                "trie_pages"):
        assert radix[key] == jax_radix[key], key
    assert set(radix["tenant_pages"]) == {"a", "b"}
    assert max(radix["tenant_pages"].values()) <= 3
    assert (sum(radix["tenant_leaf_evictions"].values())
            + radix["tenant_quota_rejections_total"]) > 0


def test_cancelled_sibling_leaves_shared_pages_intact(port_pred):
    """Two requests over a published prefix; one cancels itself after
    its second token (from its own token callback, on the loop thread).
    The refcounted release keeps the shared pages: the sibling finishes
    with the cold engine's tokens, the audit holds, the pool drains."""
    prompts = _shared_prompts(97, 3, pre_len=16, lo=3, hi=6)
    for kv in ("float32", "int8"):
        cold, _ = _serve(GenerationEngine(port_pred, port_pred.gpt_config,
                                          kv_dtype=kv, **KW), prompts, 12)
        with GenerationEngine(port_pred, port_pred.gpt_config,
                              prefix_cache=True, kv_dtype=kv, **KW) as eng:
            eng.generate(prompts[0], max_new_tokens=12, timeout=600)
            holder = []

            def stop_after_two(_tok):
                if len(holder[0].tokens) == 2:
                    holder[0].cancel()

            victim = eng.submit(prompts[1], max_new_tokens=12,
                                on_token=stop_after_two)
            holder.append(victim)
            sibling = eng.submit(prompts[2], max_new_tokens=12)
            got = sibling.result(timeout=600)
            assert victim.done() and victim.finish_reason == "cancelled"
            assert len(victim.tokens) == 2
            assert victim.tokens == cold[1][:2]
            st = eng.stats()
            eng.cache.check_integrity()
            eng.cache.drop_trie()
            eng.cache.check_integrity()
        assert got == cold[2], kv
        assert st["radix"]["prefix_hits_total"] == 2
        assert st["cancelled_total"] == 1
        assert eng.stats()["cache"]["pages_in_use"] == 0


def test_prefix_cache_with_adapters_is_refused(port_pred):
    """The trie keys a page by its tokens alone, and an adapter's qkv
    delta changes the page's K/V: a row on one adapter would attend over
    pages another adapter (or the base) published. The port refuses the
    combination, whether the store is passed or built from the flags;
    each option alone still constructs."""
    from paddle_tpu_torch.adapters import AdapterStore

    cfg = port_pred.gpt_config
    with pytest.raises(ValueError, match="not keyed by adapter"):
        GenerationEngine(port_pred, cfg, prefix_cache=True, start=False,
                         adapter_store=AdapterStore.for_model(port_pred.lm))
    set_flags({"adapter_pool_max_bytes": 1, "generation_prefix_cache": True})
    try:
        with pytest.raises(ValueError, match="not keyed by adapter"):
            GenerationEngine(port_pred, cfg, start=False)
        GenerationEngine(port_pred, cfg, prefix_cache=False,
                         start=False).close()
    finally:
        set_flags({"adapter_pool_max_bytes": 0,
                   "generation_prefix_cache": False})
    GenerationEngine(port_pred, cfg, prefix_cache=True, start=False).close()
