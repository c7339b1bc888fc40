"""The serving steps as Programs, on the CPU: the port's
``build_ragged_step_program`` (float32 and int8 pools),
``build_decode_program`` and ``build_prefill_program`` against the JAX
package's, and against the port's step modules, on one set of seeded
weights; the Program-form ``rewrite_for_lora`` (idempotent, base rows
unchanged, adapter rows equal to JAX's, over a dense and a quantized
base); fed pools are never written.

Tolerances: logits-derived tokens must be equal (the step's greedy
argmax at these widths has no near-ties); pools within 1e-5 (the K/V
rows come from a projection on both sides), the junk page's slot 0
left out (invalid rows land there in an order neither framework
defines); int8 pools equal to one level, scale planes rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.adapters import AdapterStore as JaxStore
from paddle_tpu.adapters import rewrite_for_lora as jax_rewrite
from paddle_tpu.adapters.rewrite import lora_targets as jax_lora_targets
from paddle_tpu.generation import model as jgen
from paddle_tpu.quantize import rewrite_for_inference as jax_quantize
from paddle_tpu_torch.adapters import AdapterStore, rewrite_for_lora
from paddle_tpu_torch.adapters.rewrite import lora_targets
from paddle_tpu_torch.generation import (CacheGeometry, DecodeStepModel,
                                         GPTLM, PrefillStepModel,
                                         RaggedStepModel,
                                         build_decode_program,
                                         build_prefill_program,
                                         build_ragged_step_program,
                                         load_jax_params)
from paddle_tpu_torch.generation.model import step_feeds
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.quantize import rewrite_for_inference

CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           ffn_size=64, max_position=64, hidden_dropout=0.0,
           attention_dropout=0.0)
JCFG = jgen.GPTConfig(**CFG)
PCFG = GPTConfig(**CFG)
R, C, PS, P, MAXP = 4, 6, 4, 24, 16
L = CFG["num_layers"]


@pytest.fixture(scope="module")
def params():
    """Seeded weights: the JAX LM's startup, as numpy."""
    main, startup, _f, _o = jgen.build_lm_program(JCFG, 8)
    startup.random_seed = 5
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    return {p.name: np.asarray(scope.find_var(p.name))
            for p in main.all_parameters()}


def _jax_scope(params):
    s = jfluid.Scope()
    for n, v in params.items():
        s.set_var(n, v.copy())
    return s


def _port_scope(params):
    s = fluid.Scope()
    for n, v in params.items():
        s.set_var(n, torch.from_numpy(v.copy()))
    return s


def _lm(params):
    lm = GPTLM(PCFG, device="cpu")
    load_jax_params(lm, params)
    return lm


def _ragged_feed(seed=3, kv="float32"):
    rng = np.random.RandomState(seed)
    H, nh = CFG["hidden_size"], CFG["num_heads"]
    shape = (nh, P, PS, H // nh)
    feed = {}
    for i in range(L):
        for side in "kv":
            if kv == "int8":
                feed[f"gen_{side}_pages_{i}"] = rng.randint(
                    -127, 128, shape).astype(np.int8)
                feed[f"gen_{side}_scales_{i}"] = (
                    rng.rand(nh, P, PS) * 0.02).astype(np.float32)
            else:
                feed[f"gen_{side}_pages_{i}"] = rng.randn(*shape).astype(
                    np.float32)
    tables = np.zeros((R, MAXP), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :3] = [3, 4, 5]
    tables[2, :2] = [6, 7]
    positions = np.array([0, 9, 4, 0], np.int64)
    num_valid = np.array([6, 1, 3, 0], np.int32)
    tokens = rng.randint(1, CFG["vocab_size"], (R, C)).astype(np.int64)
    feed.update({"gen_tokens": tokens,
                 "gen_pos_ids": positions[:, None] + np.arange(C)[None, :],
                 "gen_positions": positions, "gen_num_valid": num_valid,
                 "gen_block_tables": tables})
    return feed


def _jax_run(prog, fetches, feed, scope):
    exe = jfluid.Executor(jfluid.CPUPlace())
    return [np.asarray(o) for o in exe.run(prog, feed=feed,
                                           fetch_list=fetches, scope=scope)]


def _port_run(prog, fetches, feed, scope):
    exe = fluid.Executor(fluid.CPUPlace())
    return [np.asarray(o) for o in exe.run(prog, feed=feed,
                                           fetch_list=fetches, scope=scope)]


def _tokens_equal(got, want, num_valid):
    got, want = got.reshape(R, -1), want.reshape(R, -1)
    for r in range(R):
        n = int(num_valid[r])
        np.testing.assert_array_equal(got[r, :n], want[r, :n])


def _pools_close(got, want, int8=False):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        for sl in ((slice(None), slice(1, None)),
                   (slice(None), 0, slice(1, None))):
            if int8:
                assert np.abs(g[sl].astype(np.int32)
                              - w[sl].astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(g[sl], w[sl], rtol=1e-5,
                                           atol=1e-5)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_ragged_step_program_matches_jax_and_module(params, kv):
    feed = _ragged_feed(kv=kv)
    jprog, jf = jgen.build_ragged_step_program(
        JCFG, jgen.CacheGeometry(P, PS, MAXP), C, kv)
    want = _jax_run(jprog, jf, feed, _jax_scope(params))
    prog, fetches = build_ragged_step_program(
        PCFG, CacheGeometry(P, PS, MAXP), C, kv)
    assert [f.name for f in fetches] == [f.name for f in jf]
    got = _port_run(prog, fetches, feed, _port_scope(params))
    nv = feed["gen_num_valid"]
    _tokens_equal(got[0], want[0], nv)
    int8 = kv == "int8"
    _pools_close(got[1:1 + 2 * L], want[1:1 + 2 * L], int8)
    if int8:
        for g, w in zip(got[1 + 2 * L:], want[1 + 2 * L:]):
            np.testing.assert_allclose(g[:, 1:], w[:, 1:], rtol=1e-5,
                                       atol=1e-7)
    # the module step on the same weights and copies of the pools
    step = RaggedStepModel(_lm(params), CacheGeometry(P, PS, MAXP), C)
    pools = {k: torch.from_numpy(v.copy()) for k, v in feed.items()
             if k.startswith(("gen_k_", "gen_v_"))}
    kp = [pools[f"gen_k_pages_{i}"] for i in range(L)]
    vp = [pools[f"gen_v_pages_{i}"] for i in range(L)]
    scales = {}
    if int8:
        scales = dict(k_scales=[pools[f"gen_k_scales_{i}"] for i in range(L)],
                      v_scales=[pools[f"gen_v_scales_{i}"] for i in range(L)])
    tok = step(*step_feeds(feed["gen_tokens"], feed["gen_pos_ids"],
                           feed["gen_positions"], nv,
                           feed["gen_block_tables"], torch.device("cpu")),
               kp, vp, **scales)
    _tokens_equal(tok.numpy(), got[0], nv)
    _pools_close([t.numpy() for t in kp + vp], got[1:1 + 2 * L], int8)


def test_decode_program_matches_jax_and_module(params):
    rng = np.random.RandomState(4)
    H, nh = CFG["hidden_size"], CFG["num_heads"]
    feed = {f"gen_{s}_pages_{i}": rng.randn(nh, P, PS, H // nh).astype(
        np.float32) for i in range(L) for s in "kv"}
    tables = np.zeros((R, MAXP), np.int32)
    tables[:3, :3] = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]
    positions = np.array([5, 0, 10, 0], np.int64)
    num_valid = np.array([1, 1, 1, 0], np.int32)
    feed.update({"gen_tokens": rng.randint(1, 97, (R, 1)).astype(np.int64),
                 "gen_positions": positions, "gen_num_valid": num_valid,
                 "gen_attend_lens": np.array([6, 1, 11, 0], np.int32),
                 "gen_block_tables": tables})
    geom = CacheGeometry(P, PS, MAXP)
    jprog, jf = jgen.build_decode_program(JCFG, jgen.CacheGeometry(P, PS,
                                                                   MAXP))
    want = _jax_run(jprog, jf, feed, _jax_scope(params))
    prog, fetches = build_decode_program(PCFG, geom)
    got = _port_run(prog, fetches, feed, _port_scope(params))
    np.testing.assert_array_equal(got[0][:3], want[0][:3])
    _pools_close(got[1:], want[1:])
    kp = [torch.from_numpy(feed[f"gen_k_pages_{i}"].copy()) for i in range(L)]
    vp = [torch.from_numpy(feed[f"gen_v_pages_{i}"].copy()) for i in range(L)]
    step = DecodeStepModel(_lm(params), geom)
    tok = step(torch.from_numpy(feed["gen_tokens"][:, 0]),
               torch.from_numpy(positions).int(),
               torch.from_numpy(num_valid),
               torch.from_numpy(feed["gen_attend_lens"]),
               torch.from_numpy(tables), kp, vp)
    np.testing.assert_array_equal(tok.numpy()[:3], got[0][:3])
    _pools_close([t.numpy() for t in kp + vp], got[1:])


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_program_matches_jax_and_module(params, flash):
    S = 8
    rng = np.random.RandomState(6)
    H, nh = CFG["hidden_size"], CFG["num_heads"]
    feed = {f"gen_{s}_pages_{i}": np.zeros((nh, P, PS, H // nh), np.float32)
            for i in range(L) for s in "kv"}
    tables = np.zeros((2, MAXP), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :2] = [3, 4]
    lens = np.array([8, 5], np.int32)
    tokens = rng.randint(1, 97, (2, S)).astype(np.int64)
    feed.update({"gen_tokens": tokens,
                 "gen_positions": np.zeros(2, np.int64),
                 "gen_num_valid": lens, "gen_last_index": lens - 1,
                 "gen_block_tables": tables})
    jcfg = jgen.GPTConfig(**CFG, use_flash_attention=flash)
    pcfg = GPTConfig(**CFG, use_flash_attention=flash)
    geom = CacheGeometry(P, PS, MAXP)
    jprog, jf = jgen.build_prefill_program(jcfg, S, jgen.CacheGeometry(
        P, PS, MAXP))
    want = _jax_run(jprog, jf, feed, _jax_scope(params))
    prog, fetches = build_prefill_program(pcfg, S, geom)
    ops = [op.type for op in prog.global_block().ops]
    assert ("flash_attention" in ops) == flash
    got = _port_run(prog, fetches, feed, _port_scope(params))
    np.testing.assert_array_equal(got[0], want[0])
    _pools_close(got[1:], want[1:])
    kp = [torch.zeros(nh, P, PS, H // nh) for _ in range(L)]
    vp = [torch.zeros(nh, P, PS, H // nh) for _ in range(L)]
    lm = _lm(params)
    lm.cfg = pcfg
    tok = PrefillStepModel(lm, geom, use_flash=flash)(
        torch.from_numpy(tokens), torch.from_numpy(lens),
        torch.from_numpy(tables), kp, vp)
    np.testing.assert_array_equal(tok.numpy(), got[0])
    _pools_close([t.numpy() for t in kp + vp], got[1:])


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_fed_pools_are_never_written(params, kv):
    """JAX's write ops return new pools; the port's Program step must
    not write the tensors it is fed: the same feed twice gives the same
    fetches, and the fed tensors keep their bits."""
    feed = {k: torch.from_numpy(v.copy()) for k, v in
            _ragged_feed(kv=kv).items()}
    before = {k: v.clone() for k, v in feed.items()}
    prog, fetches = build_ragged_step_program(
        PCFG, CacheGeometry(P, PS, MAXP), C, kv)
    scope = _port_scope(params)
    first = _port_run(prog, fetches, feed, scope)
    second = _port_run(prog, fetches, feed, scope)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    for k in feed:
        assert torch.equal(feed[k], before[k]), k
    # the pools did change in the fetched copies
    assert not np.array_equal(first[1], before["gen_k_pages_0"].numpy())


# -- the Program-form LoRA rewrite ---------------------------------------------


def _factors(targets, seed):
    rng = np.random.RandomState(seed)
    out = []
    for aid, rank in (("a8", 8), ("a16", 16)):
        out.append((aid, {t: ((rng.randn(k, rank) * 0.05).astype(np.float32),
                              (rng.randn(rank, n) * 0.05).astype(np.float32))
                          for t, (k, n) in sorted(targets.items())},
                    2.0 * rank))
    return out


def _lora_pair(params, quant):
    """(JAX program, fetches, scope, store), (port ...) rewritten over
    the same adapters; ``quant`` int8 quantizes first."""
    out = []
    for pkg, gen, Store, rewrite, quantize, mk in (
            (jfluid, jgen, JaxStore, jax_rewrite, jax_quantize,
             lambda: _jax_scope(params)),
            (fluid, None, AdapterStore, rewrite_for_lora,
             rewrite_for_inference, lambda: _port_scope(params))):
        if gen is not None:
            prog, fetches = gen.build_ragged_step_program(
                JCFG, gen.CacheGeometry(P, PS, MAXP), C)
        else:
            prog, fetches = build_ragged_step_program(
                PCFG, CacheGeometry(P, PS, MAXP), C)
        scope = mk()
        if quant:
            quantize(prog, scope, quant)
        store = Store.for_program(prog, slots_per_bucket=2)
        rep = rewrite(prog, store)
        store.attach(scope)
        for aid, fac, alpha in _factors(store.targets, seed=8):
            store.upload(aid, fac, alpha=alpha)
        out.append((prog, fetches, scope, store, rep))
    return out


@pytest.mark.parametrize("quant", [None, "int8"])
def test_program_lora_rewrite_matches_jax(params, quant):
    (jp, jf, js, jst, jrep), (pp, pf, ps_, pst, prep) = _lora_pair(params,
                                                                   quant)
    assert lora_targets(pp) == jax_lora_targets(jp)
    assert prep.to_dict() == jrep.to_dict()
    assert pst.pool_var_names() == jst.pool_var_names()
    for a, b in pst.pool_var_names():
        assert pp.global_block().has_var(a) and pp.global_block().has_var(b)
    assert prep.n_repointed == 4 * L + 1
    want_kind = quant or "dense"
    assert {r["base_kind"] for r in prep.rows} == {want_kind}
    feed = _ragged_feed(seed=9)
    # rows: base, adapter a8, adapter a16, idle
    feed["gen_adapter_slots"] = np.stack(
        [pst.slots_row(a) for a in (None, "a8", "a16", None)]).astype(
            np.int32)
    np.testing.assert_array_equal(
        feed["gen_adapter_slots"],
        np.stack([jst.slots_row(a) for a in (None, "a8", "a16", None)]))
    want = _jax_run(jp, jf, feed, js)
    got = _port_run(pp, pf, feed, ps_)
    nv = feed["gen_num_valid"]
    _tokens_equal(got[0], want[0], nv)
    _pools_close(got[1:], want[1:])
    # base rows equal the unrewritten Program's
    plain, pfetch = build_ragged_step_program(PCFG, CacheGeometry(P, PS,
                                                                  MAXP), C)
    base_scope = _port_scope(params)
    if quant:
        rewrite_for_inference(plain, base_scope, quant)
    base = _port_run(plain, pfetch, _ragged_feed(seed=9), base_scope)
    got0, base0 = got[0].reshape(R, C), base[0].reshape(R, C)
    np.testing.assert_array_equal(got0[0, :6], base0[0, :6])
    # the adapters moved the adapter rows' logits: their pools differ
    assert not np.allclose(got[1][:, 3:6], base[1][:, 3:6])


def test_program_lora_rewrite_is_idempotent_and_explains_skips(params):
    (_jp, _jf, _js, _jst, _), (pp, pf, ps_, pst, rep) = _lora_pair(params,
                                                                   None)
    ops_before = [(op.type, dict(op.inputs)) for op in
                  pp.global_block().ops]
    again = rewrite_for_lora(pp, pst)
    assert again.n_repointed == 0
    assert {r["reason"] for r in again.rows} == {"already a batched-LoRA op"}
    assert [(op.type, dict(op.inputs)) for op in
            pp.global_block().ops] == ops_before
    # a store over one target: the rest are explained, as JAX's
    other = AdapterStore({"dec0_qkv.w": (32, 96)})
    jother = JaxStore({"dec0_qkv.w": (32, 96)})
    prog, _ = build_ragged_step_program(PCFG, CacheGeometry(P, PS, MAXP), C)
    jprog, _ = jgen.build_ragged_step_program(
        JCFG, jgen.CacheGeometry(P, PS, MAXP), C)
    rep2 = rewrite_for_lora(prog, other)
    assert rep2.to_dict() == jax_rewrite(jprog, jother).to_dict()
    assert rep2.targets() == ["dec0_qkv.w"]
    row = [r for r in rep2.rows if r["target"] == "gpt_head.w"][0]
    assert "not in the store's target table" in row["reason"]
    ops = {op.type for op in prog.global_block().ops}
    assert {"batched_lora_fc", "mul"} <= ops


# -- the matmul form and the kernel ops' names ------------------------------------


def _matmul_prog(pkg, quant):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 4
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [8])
        xt = pkg.layers.data("xt", [8, 4], append_batch_size=False)
        w = pkg.layers.create_parameter([8, 6], "float32", name="mm.w")
        a = pkg.layers.matmul(x, w, alpha=0.5)
        b = pkg.layers.matmul(xt, w, transpose_x=True)
    scope = pkg.Scope()
    pkg.Executor(pkg.CPUPlace()).run(startup, scope=scope)
    return main, scope, [a, b]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_batched_lora_matmul_matches_jax(quant):
    """``matmul`` ops (alpha, transpose_X) repointed onto
    ``batched_lora_matmul``, dense and over an int8 base: the port's
    outputs equal JAX's within 1e-5."""
    rng = np.random.RandomState(2)
    feed = {"x": rng.randn(4, 8).astype(np.float32),
            "xt": rng.randn(8, 4).astype(np.float32)}
    fac = {"mm.w": ((rng.randn(8, 8) * 0.1).astype(np.float32),
                    (rng.randn(8, 6) * 0.1).astype(np.float32))}
    outs = []
    jmain, jscope, jf = _matmul_prog(jfluid, quant)
    w0 = np.asarray(jscope.find_var("mm.w"))
    for pkg, main, scope, fetch, Store, rewrite, quantize in (
            (jfluid, jmain, jscope, jf, JaxStore, jax_rewrite, jax_quantize),
            (fluid, *_matmul_prog(fluid, quant), AdapterStore,
             rewrite_for_lora, rewrite_for_inference)):
        if pkg is fluid:
            scope.set_var("mm.w", torch.from_numpy(w0.copy()))
        if quant:
            quantize(main, scope, quant)
        store = Store.for_program(main, slots_per_bucket=1)
        rep = rewrite(main, store)
        assert rep.n_repointed == 2
        store.attach(scope)
        store.upload("ad", fac, alpha=16.0)
        slots = np.stack([store.slots_row(a) for a in
                          ("ad", None, "ad", None)]).astype(np.int32)
        types = {op.type for op in main.global_block().ops}
        assert "batched_lora_matmul" in types and "matmul" not in types
        outs.append([np.asarray(o) for o in pkg.Executor(
            pkg.CPUPlace()).run(main, feed=dict(
                feed, gen_adapter_slots=slots), fetch_list=fetch,
                scope=scope)])
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_serving_programs_name_the_kernel_ops():
    geom = CacheGeometry(P, PS, MAXP)
    want = {
        "ragged_f32": {"kv_cache_write", "ragged_paged_attention"},
        "ragged_int8": {"kv_cache_write_q", "ragged_paged_attention_q"},
        "decode": {"kv_cache_write", "paged_attention"},
        "prefill": {"kv_cache_write"},
    }
    progs = {
        "ragged_f32": build_ragged_step_program(PCFG, geom, C)[0],
        "ragged_int8": build_ragged_step_program(PCFG, geom, C, "int8")[0],
        "decode": build_decode_program(PCFG, geom)[0],
        "prefill": build_prefill_program(PCFG, 8, geom)[0],
    }
    for name, prog in progs.items():
        types = [op.type for op in prog.global_block().ops]
        for t in want[name]:
            assert types.count(t) == L, (name, t)
    store = AdapterStore.for_program(progs["ragged_f32"], slots_per_bucket=1)
    rewrite_for_lora(progs["ragged_f32"], store)
    types = [op.type for op in progs["ragged_f32"].global_block().ops]
    assert types.count("batched_lora_fc") == 4 * L + 1
