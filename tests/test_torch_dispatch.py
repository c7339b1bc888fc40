"""The port's bound fast path (``runtime/dispatch.py``, ``Executor.bind``)
and the generation engine's bound steps (``runtime/graphs.py``), on the
CPU.

Port twins of ``tests/test_dispatch_cache.py``, under the reference's
counter names:

* ``test_bound_step_hit_miss_counters`` (:33), with ``graph_captures``
  in place of ``jit_compiles``: a Program step is never captured;
* ``test_return_numpy_false_returns_device_arrays`` (:96): torch tensors;
* ``test_stale_scope_invalidation_on_set_var`` (:113);
* ``test_scope_updates_seen_across_programs_sharing_scope`` (:136);
* ``test_program_mutation_invalidates_bound_step`` (:192).

The reference's other cases have no counterpart in the port yet: :58
and :78 share compiled executables between executors and clones, which
an eager port does not build; :161 is the persistent compilation cache;
:212, :239, :263 and :279 are strategies, sharding and pipelines
(ROADMAP A10). :305, the Program predictor's bucketing of a static
dim 1, is ``test_predictor_pad_feed_skips_static_dim1``.

The engine's cases: each step kind has one bound object for the
engine's life, run once an engine step; a step with fewer live rows
after one with more leaves no stale row in the static buffers: tokens
equal an engine whose steps take fresh tensors every call (ragged
float32, ragged int8 KV pages with adapters, two_lane).
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid


def _mlp():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8])
        y = fluid.layers.data("y", [1], dtype="int64")
        h = fluid.layers.fc(x, 8, act="relu")
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(
                fluid.layers.fc(h, 4), y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def _feed(batch=4):
    rng = np.random.RandomState(0)
    return {"x": rng.rand(batch, 8).astype("float32"),
            "y": np.zeros((batch, 1), "int64")}


def test_bound_step_hit_miss_counters():
    main, startup, loss = _mlp()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        feed = _feed()
        exe.run(main, feed=feed, fetch_list=[loss])
        st = exe.cache_stats()
        assert st["bound_misses"] == 2  # startup + main first-run
        assert st["graph_captures"] == 0
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[loss])
        st = exe.cache_stats()
        assert st["bound_hits"] == 3
        assert st["bound_misses"] == 2  # no new misses
        assert st["graph_captures"] == 0 and st["graph_replays"] == 0
        # a NEW feed shape is a new signature: one more miss
        exe.run(main, feed=_feed(batch=6), fetch_list=[loss])
        st = exe.cache_stats()
        assert st["bound_misses"] == 3
        assert st["bound_steps"] == 3
        assert st["graph_captures"] == 0


def test_bind_returns_the_step_run_uses():
    main, startup, loss = _mlp()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    bound = exe.bind(main, _feed(), [loss], scope=scope, tag="train")
    assert exe.bind(main, _feed(), [loss], scope=scope) is bound
    assert bound.tag == "train"
    (a,) = bound.run(_feed(), return_numpy=True)
    (b,) = exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert exe.cache_stats()["bound_misses"] == 2     # startup + main
    assert np.isfinite(a) and b < a                   # the SGD step moved


def test_return_numpy_false_returns_device_arrays():
    main, startup, loss = _mlp()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        # both the bind step and the cached-BoundStep step
        for _ in range(2):
            (out,) = exe.run(main, feed=_feed(), fetch_list=[loss],
                             return_numpy=False)
            assert isinstance(out, torch.Tensor), type(out)
        (out,) = exe.run(main, feed=_feed(), fetch_list=[loss])
        assert isinstance(out, np.ndarray)


def test_stale_scope_invalidation_on_set_var():
    """External scope.set_var between steps must be visible to the next
    step (the BoundStep re-resolves its cached state refs on the scope
    generation bump)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [3])
        pred = fluid.layers.fc(x, 1, bias_attr=False)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        w_name = main.all_parameters()[0].name
        xv = np.ones((2, 3), "float32")
        exe.run(main, feed={"x": xv}, fetch_list=[pred])  # bind + warm
        scope.set_var(w_name, np.zeros((3, 1), "float32"))
        (out,) = exe.run(main, feed={"x": xv}, fetch_list=[pred])
        np.testing.assert_allclose(out, np.zeros((2, 1)), atol=0)
        scope.set_var(w_name, torch.ones((3, 1)))
        (out,) = exe.run(main, feed={"x": xv}, fetch_list=[pred])
        np.testing.assert_allclose(out, np.full((2, 1), 3.0), rtol=1e-6)


def test_scope_updates_seen_across_programs_sharing_scope():
    """Train/eval alternation over one scope: the eval program's bound
    step must see the params the train step just wrote."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [2])
        pred = fluid.layers.fc(x, 1, bias_attr=False)
        loss = fluid.layers.mean(pred)
        fluid.optimizer.SGD(0.5).minimize(loss)
    test_prog = main.clone(for_test=True)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        xv = np.ones((4, 2), "float32")
        evals = []
        for _ in range(3):
            (e,) = exe.run(test_prog, feed={"x": xv}, fetch_list=[pred])
            evals.append(float(e.mean()))
            exe.run(main, feed={"x": xv}, fetch_list=[loss])
        # SGD on mean(pred) strictly decreases pred each step; a stale
        # eval BoundStep would repeat the same value
        assert evals[0] > evals[1] > evals[2], evals


def test_training_loop_does_not_resolve_its_state_again(monkeypatch):
    """The step's own writes update its cached refs in place: a loop of
    one bound step resolves once, an external set_var once more."""
    from paddle_tpu_torch.runtime.dispatch import BoundStep

    main, startup, loss = _mlp()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    bound = exe.bind(main, _feed(), [loss], scope=scope)
    resolves = []
    real = BoundStep._resolve_state

    def counting(self):
        resolves.append(self)
        real(self)

    monkeypatch.setattr(BoundStep, "_resolve_state", counting)
    losses = [float(bound.run(_feed())[0]) for _ in range(4)]
    assert resolves == [bound] and losses[-1] < losses[0]
    w = main.all_parameters()[0].name
    scope.set_var(w, scope.find_var(w).clone())
    bound.run(_feed())
    assert resolves == [bound, bound]


def test_program_mutation_invalidates_bound_step():
    """Appending an op bumps program.version: the bound path must not
    serve the stale step."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [2])
        out = fluid.layers.scale(x, scale=2.0)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        xv = np.ones((1, 2), "float32")
        (o1,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
        np.testing.assert_allclose(o1, 2 * xv)
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            out2 = fluid.layers.scale(out, scale=5.0)
        (o2,) = exe.run(main, feed={"x": xv}, fetch_list=[out2])
        np.testing.assert_allclose(o2, 10 * xv)


# -- the engine's bound steps ---------------------------------------------------

from paddle_tpu_torch.adapters import AdapterStore  # noqa: E402
from paddle_tpu_torch.generation import GenerationEngine  # noqa: E402
from paddle_tpu_torch.generation.model import GPTLM  # noqa: E402
from paddle_tpu_torch.inference import Config, Predictor  # noqa: E402
from paddle_tpu_torch.models.gpt import GPTConfig  # noqa: E402

CFG = GPTConfig(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                ffn_size=64, max_position=64, hidden_dropout=0.0,
                attention_dropout=0.0)
# (prompt length, new tokens): six requests over four lanes, leaving at
# different steps, so later steps hold fewer live rows than earlier ones
# and queued requests join as lanes free up
REQUESTS = ((5, 3), (11, 9), (3, 2), (8, 6), (14, 4), (4, 7))


def _predictor(quantize=None):
    rng = np.random.RandomState(0)
    params = {}
    for n, p in GPTLM(CFG, device="meta").jax_params().items():
        a = rng.randn(*p.shape) * 0.3
        params[n] = (1.0 + 0.1 * a if n.endswith(".scale") else a).astype(
            np.float32)
    cfg = Config().set_params(CFG, params)
    if quantize:
        cfg.enable_weight_quantization(quantize)
    return Predictor(cfg, device="cpu")


def _engine(kind):
    common = dict(page_size=4, num_pages=64, max_decode_batch=4,
                  start=False)
    if kind == "two_lane":
        return GenerationEngine(_predictor(), CFG, mode="two_lane",
                                prefill_buckets=(8, 16), **common)
    if kind == "ragged":
        return GenerationEngine(_predictor(), CFG, chunk_tokens=6, **common)
    pred = _predictor("int8")
    store = AdapterStore.for_model(pred.lm, rank_buckets=(8, 16),
                                   slots_per_bucket=4)
    eng = GenerationEngine(pred, CFG, chunk_tokens=6, kv_dtype="int8",
                           adapter_store=store, **common)
    rng = np.random.RandomState(3)
    for aid, r in (("ad0", 8), ("ad1", 16)):
        store.upload(aid, {t: ((rng.randn(k, r) * 0.1).astype(np.float32),
                               (rng.randn(r, n) * 0.1).astype(np.float32))
                           for t, (k, n) in store.targets.items()},
                     alpha=2.0 * r)
    return eng


def _serve(eng, kind):
    """Every request submitted before the loop starts (the same admission
    order in every engine); returns the tokens and each step's count of
    live rows."""
    bound = eng._bound_step
    live = []
    run = bound.run

    def counting(**host):
        live.append(int((host["num_valid"] > 0).sum()))
        return run(**host)

    bound.run = counting
    rng = np.random.RandomState(1)
    adapters = ([None, "ad0", "ad1", None, "ad1", "ad0"]
                if kind == "ragged_int8_adapters" else [None] * 6)
    streams = [eng.submit(rng.randint(1, CFG.vocab_size, n),
                          max_new_tokens=m, adapter=a)
               for (n, m), a in zip(REQUESTS, adapters)]
    eng.start()
    tokens = [s.result(timeout=120) for s in streams]
    eng.close()
    return tokens, live


KINDS = ("ragged", "ragged_int8_adapters", "two_lane")


@pytest.mark.parametrize("kind", KINDS)
def test_engine_binds_one_step_a_kind_for_its_life(kind):
    eng = _engine(kind)
    bound = eng._bound_step
    assert bound is (eng._decode_bound if kind == "two_lane"
                     else eng._ragged_bound)
    assert (eng._ragged_bound is None) == (kind == "two_lane")
    _serve(eng, kind)
    st = eng.stats()
    assert eng._bound_step is bound
    assert st["decode_steps_total"] > len(REQUESTS)
    assert st["bound_step_runs"] == st["decode_steps_total"]
    if kind != "two_lane":
        assert st["bound_step_runs"] == st["ragged_steps_total"]
    # the CPU runs the step eagerly on the static buffers
    assert st["graph_captures"] == 0 and st["graph_replays"] == 0
    assert st["graph_launches"] == {}
    assert bound.graph is None


@pytest.mark.parametrize("kind", KINDS)
def test_fewer_rows_after_more_leave_no_stale_row(kind):
    """Tokens equal an engine whose steps take fresh tensors every call,
    over steps where queued requests take the lanes of finished ones and
    the live rows then fall."""
    bound_tokens, live = _serve(_engine(kind), kind)
    assert any(b < a for a, b in zip(live, live[1:])), live
    ref = _engine(kind)
    fresh = ref._bound_step
    fresh.run = lambda **host: fresh.eager(**host).numpy()
    ref_tokens, ref_live = _serve(ref, kind)
    assert ref_live == live
    assert bound_tokens == ref_tokens
    assert [len(t) for t in bound_tokens] == [m for _, m in REQUESTS]


# -- a capture's launch counts ---------------------------------------------------

from paddle_tpu_torch import kernels as K  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.runtime.graphs import (demangle,  # noqa: E402
                                             graph_launches)

# kernel symbols as nvcc emits them (anonymous namespace, templates), the
# names a graph's kernel nodes carry
SYMBOLS = {
    "_ZN39_GLOBAL__N__435e22c3_7_lora_cu_1a409c8518lora_expand_kernelEPfPKiPKf":
        "batched_lora_add_",
    "_ZN39_GLOBAL__N__435e22c3_7_lora_cu_1a409c8518lora_shrink_kernelILi128EEEvPKfPKi":
        None,
    "_ZN12_GLOBAL__N_119ragged_split_kernelIffLi128EEEvPKT_PKT0_PKf":
        "ragged_paged_attention",
    "_ZN12_GLOBAL__N_119ragged_split_kernelI13__nv_bfloat16S1_Li64EEEvPKT_PKT0_PKf":
        "ragged_paged_attention",
    "_ZN12_GLOBAL__N_119ragged_split_kernelIfaLi128EEEvPKT_PKT0_PKf":
        "ragged_paged_attention_q",
    "_ZN12_GLOBAL__N_119ragged_split_kernelI13__nv_bfloat16aLi64EEEvPKT_PKT0_PKf":
        "ragged_paged_attention_q",
    "_ZN12_GLOBAL__N_119ragged_merge_kernelIfaEEvPKfPT_": None,
    "_ZN12_GLOBAL__N_122paged_attention_kernelIfEEvPKT_i": "paged_attention",
    "_ZN12_GLOBAL__N_128paged_attention_merge_kernelIfEEvPKfPT_": None,
    "_ZN12_GLOBAL__N_121layer_norm_fwd_kernelIfLi4ELb1EEEvPKT_f":
        "layer_norm",
    "_ZN12_GLOBAL__N_128layer_norm_fwd_looped_kernelIfLb0EEEvPKT_f":
        "layer_norm",
    "_ZN12_GLOBAL__N_123quant_matmul_mma_kernelILi1EEEvPKfPKh":
        "quantized_matmul",
    "_ZN12_GLOBAL__N_126quant_matmul_reduce_kernelEPKfi": None,
    "_ZN12_GLOBAL__N_123quant_matmul_fma_kernelEPKfPKa":
        "quantized_matmul_fma",
    # a library kernel in the same graph
    "_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEE"
    "St5arrayIPcLm1EEEEviT0_T1_": None,
}


def test_capture_counts_into_its_own_tally():
    """While this thread records, a wrapper's count goes to the capture's
    tally and not to its counter; another thread counts as before."""
    import threading

    K.reset_launch_counts()
    with _build.recording() as tally:
        _build.count(K.ragged_paged_attention)
        _build.count(K.ragged_paged_attention)
        _build.count(K.layer_norm)
        other = threading.Thread(target=_build.count,
                                 args=(K.paged_attention,))
        other.start()
        other.join()
    _build.count(K.layer_norm)
    assert tally == {"ragged_paged_attention": 2, "layer_norm": 1}
    counts = K.launch_counts()
    assert counts["ragged_paged_attention"] == 0
    assert counts["paged_attention"] == 1 and counts["layer_norm"] == 1
    K.reset_launch_counts()
    # every counted wrapper tallies under its KERNELS name
    assert all(fn.__name__ == name for name, fn in K.KERNELS.items())
    assert set(K.GRAPH_NODES) <= set(K.KERNELS)


def test_graph_node_names_count_one_launch_a_call():
    """Each wrapper of the engine's steps is named by exactly the one
    kernel it launches once a call (K2 apart from K2q by the pages'
    type); the other kernels of a call and library kernels by none."""
    names = {demangle(sym): want for sym, want in SYMBOLS.items()}
    assert all("(anonymous namespace)::" in n or n.startswith("void at::")
               for n in names)
    for name, want in names.items():
        counted = graph_launches([name], {want: 1} if want else {}, "one")
        assert counted == ({want: 1} if want else {}), name


def test_graph_launches_must_equal_the_wrappers_tally():
    names = [demangle(s) for s in SYMBOLS] * 3
    tally = {"batched_lora_add_": 3, "ragged_paged_attention": 6,
             "ragged_paged_attention_q": 6, "paged_attention": 3,
             "layer_norm": 6, "quantized_matmul": 3,
             "quantized_matmul_fma": 3}
    assert graph_launches(names, tally, "mixed") == tally
    # a launch the wrappers counted that the graph does not hold, and a
    # kernel node that no wrapper counted
    with pytest.raises(RuntimeError, match="graph holds the kernel nodes"):
        graph_launches(names[1:], tally, "mixed")
    with pytest.raises(RuntimeError, match="graph holds the kernel nodes"):
        graph_launches(names, dict(tally, layer_norm=5), "mixed")
    # a training kernel has no node pattern: counted in a capture, it
    # makes the capture raise
    with pytest.raises(RuntimeError, match="fused_adam_update"):
        graph_launches(names, dict(tally, fused_adam_update=1), "mixed")


def test_predictor_pad_feed_skips_static_dim1(tmp_path):
    """Bucketing never zero-pads dim 1 of a feed whose declared second
    dim is static ([B, F] features): only declared-dynamic (sequence)
    feeds bucket on dim 1. Outputs equal the JAX predictor's."""
    import paddle_tpu as jfluid
    from paddle_tpu.inference import Config as JaxConfig
    from paddle_tpu.inference import create_predictor as jax_create

    from paddle_tpu_torch.inference import create_predictor

    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), jfluid.unique_name.guard():
        feats = jfluid.layers.data("feats", [6])  # static dim 1
        out = jfluid.layers.fc(feats, 3, act="softmax")
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(str(tmp_path), ["feats"], [out], exe,
                                       main)
    cfg = Config(str(tmp_path))
    cfg.enable_shape_bucketing(seq_buckets=(16, 32), batch_buckets=(4, 8))
    pred = create_predictor(cfg, device="cpu")
    jpred = jax_create(JaxConfig(str(tmp_path)))
    rng = np.random.RandomState(3)
    for b in (1, 3, 5):
        f = rng.rand(b, 6).astype("float32")
        (got,) = pred.run([f])
        (want,) = jpred.run([f])
        assert got.shape == np.asarray(want).shape == (b, 3)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    assert pred._seq_feed_names == set()
    st = pred.bucket_stats()
    assert st["compiled_shapes"] == 2  # batch buckets 4 and 8 only
    assert set(st["bucket_hits"]) == {"4,6", "8,6"}
