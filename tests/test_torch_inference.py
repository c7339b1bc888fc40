"""The port's Program Predictor against the JAX predictor, on the CPU:
twins of tests/test_inference.py, GPT LM directories written by either
package (plain and flash attention, float and each quantized mode), a
two-bottleneck ResNet under ``is_test`` batch norm, the LM module's
weight sharing with the scope, and the meta-tensor shape route.

Every directory is saved once and loaded by both predictors, so their
outputs are compared on the same weights and the same inputs.
"""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.generation.model import GPTConfig as JaxGPTConfig
from paddle_tpu.generation.model import build_lm_program as jax_build_lm
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_create_predictor
from paddle_tpu.models import resnet as jresnet

import paddle_tpu_torch as fluid
from paddle_tpu_torch.generation import build_lm_program
from paddle_tpu_torch.generation.model import QuantizedDense
from paddle_tpu_torch.inference import (AnalysisConfig, Config,
                                        PaddlePredictor,
                                        create_paddle_predictor,
                                        create_predictor)
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels.layer_norm import layer_norm
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.runtime.dispatch import eval_shapes, feed_signature

RTOL, ATOL = 1e-5, 1e-6
MODES = ("int8", "int8_block", "fp8")


def _pred(d, **kw):
    cfg = Config(d)
    if kw.get("buckets"):
        cfg.enable_shape_bucketing(**kw["buckets"])
    if kw.get("quant"):
        cfg.enable_weight_quantization(kw["quant"])
    return create_predictor(cfg, device="cpu")


def _jpred(d, **kw):
    cfg = JaxConfig(d)
    if kw.get("buckets"):
        cfg.enable_shape_bucketing(**kw["buckets"])
    if kw.get("quant"):
        cfg.enable_weight_quantization(kw["quant"])
    return jax_create_predictor(cfg)


def _export_model(path):
    """tests/test_inference.py's fc-relu-fc-softmax model, initialized
    and saved by the JAX package; returns (x, the training forward)."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), jfluid.unique_name.guard():
        x = jfluid.layers.data("x", [6])
        h = jfluid.layers.fc(x, 12, act="relu")
        out = jfluid.layers.fc(h, 3, act="softmax")
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        xv = np.random.RandomState(0).randn(4, 6).astype("float32")
        (ref,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
        jfluid.io.save_inference_model(str(path), ["x"], [out], exe, main)
    return xv, np.asarray(ref)


def _export_masked_model(path):
    """Mask-aware pooled classifier with 16 classes, the smallest seq
    bucket ON PURPOSE: a shape-coincidence heuristic would cut the class
    dim to the request length."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), jfluid.unique_name.guard():
        ids = jfluid.layers.data("ids", [-1], dtype="int64")
        mask = jfluid.layers.data("mask", [-1], dtype="float32")
        emb = jfluid.layers.embedding(ids, size=[50, 8])
        m = jfluid.layers.unsqueeze(mask, [2])
        pooled = jfluid.layers.elementwise_div(
            jfluid.layers.reduce_sum(
                jfluid.layers.elementwise_mul(emb, m), dim=[1]),
            jfluid.layers.reduce_sum(m, dim=[1]))
        out = jfluid.layers.fc(pooled, 16, act="softmax")
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(str(path), ["ids", "mask"], [out],
                                       exe, main)


# -- twins of tests/test_inference.py ------------------------------------------


def test_predictor_matches_training_forward(tmp_path):
    xv, ref = _export_model(tmp_path)
    pred = create_predictor(Config(str(tmp_path)), device="cpu")
    (got,) = pred.run([xv])
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    (want,) = _jpred(str(tmp_path)).run([xv])
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_predictor_handles_and_clone(tmp_path):
    xv, ref = _export_model(tmp_path)
    pred = create_predictor(Config(str(tmp_path)), device="cpu")
    assert pred.get_input_names() == ["x"]
    assert pred.get_input_handle("x").shape() == [-1, 6]
    pred.get_input_handle("x").copy_from_cpu(xv)
    pred.zero_copy_run()
    out_name = pred.get_output_names()[0]
    np.testing.assert_allclose(pred.get_output_handle(out_name).copy_to_cpu(),
                               ref, rtol=RTOL, atol=ATOL)
    p2 = pred.clone()
    (got2,) = p2.run([xv])
    np.testing.assert_allclose(got2, ref, rtol=RTOL, atol=ATOL)
    assert p2._scope is pred._scope and p2._bindings is pred._bindings
    assert p2.get_input_handle("x") is not pred.get_input_handle("x")
    # the reference's aliases
    assert AnalysisConfig is Config and PaddlePredictor is type(pred)
    cfg = Config()
    cfg.set_model(f"{tmp_path}/__model__", f"{tmp_path}/__params__.npz")
    cfg.switch_ir_optim(False)
    cfg.enable_memory_optim()
    (got3,) = create_paddle_predictor(cfg, device="cpu").run([xv])
    np.testing.assert_array_equal(got3, got2)


def test_predictor_clone_per_thread_concurrent(tmp_path):
    """One clone a thread, 8 threads x 3 concurrent runs over the shared
    bound step: every run equals that thread's single-threaded oracle."""
    _export_model(tmp_path)
    base = create_predictor(Config(str(tmp_path)), device="cpu")
    in_name, out_name = base.get_input_names()[0], base.get_output_names()[0]
    rng = np.random.RandomState(0)
    inputs = [rng.randn(5, 6).astype("float32") for _ in range(8)]
    oracles = []
    for a in inputs:
        base.get_input_handle(in_name).copy_from_cpu(a)
        base.run()
        oracles.append(np.array(base.get_output_handle(out_name)
                                .copy_to_cpu()))
    jax_want = [np.asarray(w) for w in
                (_jpred(str(tmp_path)).run([a])[0] for a in inputs)]
    for o, w in zip(oracles, jax_want):
        np.testing.assert_allclose(o, w, rtol=RTOL, atol=ATOL)
    errors = []

    def worker(i):
        try:
            p = base.clone()
            for _ in range(3):
                p.get_input_handle(in_name).copy_from_cpu(inputs[i])
                p.run()
                got = np.array(p.get_output_handle(out_name).copy_to_cpu())
                np.testing.assert_allclose(got, oracles[i], rtol=RTOL,
                                           atol=ATOL)
        except Exception as e:  # noqa: BLE001
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not [t.name for t in threads if t.is_alive()], "deadlocked"
    assert not errors, errors
    assert base._exe.cache_stats()["bound_steps"] == 1


def test_predictor_shape_bucketing_mixed_lengths(tmp_path):
    _export_masked_model(tmp_path)
    buckets = {"seq_buckets": (16, 32, 64), "pad_batch": False}
    pred = _pred(str(tmp_path), buckets=buckets)
    jpred = _jpred(str(tmp_path), buckets=buckets)
    ref = create_predictor(Config(str(tmp_path)), device="cpu")
    rng = np.random.RandomState(0)
    for L in [7, 11, 13, 30, 31, 9, 50]:
        ids = rng.randint(1, 50, (3, L)).astype("int64")
        mask = np.ones((3, L), np.float32)
        (got,) = pred.run([ids, mask])
        (exact,) = ref.run([ids, mask])
        (want,) = jpred.run([ids, mask])
        assert got.shape == exact.shape == (3, 16)
        np.testing.assert_allclose(got, exact, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    st = pred.bucket_stats()
    assert st["request_shapes"] == 7
    assert st["compiled_shapes"] == 3, st
    assert 0.0 < st["padding_waste"] < 0.8
    jst = jpred.bucket_stats()
    for k in ("runs", "real_elements", "padded_elements", "padding_waste",
              "bucket_hits", "request_shapes", "compiled_shapes"):
        assert st[k] == jst[k], k
    # one bound step per bucket, not one per request shape
    assert len(pred._bindings) == 3
    assert pred._exe.cache_stats()["bound_steps"] == 3


def test_predictor_bucketing_pads_batch_dim(tmp_path):
    _export_masked_model(tmp_path)
    buckets = {"seq_buckets": (32,), "batch_buckets": (4, 8)}
    pred = _pred(str(tmp_path), buckets=buckets)
    jpred = _jpred(str(tmp_path), buckets=buckets)
    rng = np.random.RandomState(1)
    for b in (1, 3, 4, 6):
        ids = rng.randint(1, 50, (b, 20)).astype("int64")
        mask = np.ones((b, 20), np.float32)
        (got,) = pred.run([ids, mask])
        (want,) = jpred.run([ids, mask])
        assert got.shape[0] == b
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    assert pred.bucket_stats()["compiled_shapes"] == 2


# -- GPT LM directories -----------------------------------------------------------

LM_KW = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
             ffn_size=64, max_position=64, hidden_dropout=0.0,
             attention_dropout=0.0)
SEQ = 24


def _save_lm(pkg, path, flash):
    """A tiny LM initialized and saved by ``pkg``."""
    if pkg is jfluid:
        main, startup, _f, fetches = jax_build_lm(
            JaxGPTConfig(**LM_KW, use_flash_attention=flash), SEQ)
    else:
        main, startup, _f, fetches = build_lm_program(
            GPTConfig(**LM_KW, use_flash_attention=flash), SEQ)
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        pkg.io.save_inference_model(str(path), ["tokens"],
                                    [fetches["logits"]], exe, main)
    return str(path)


def _tokens(seed=11, rows=2):
    return np.random.RandomState(seed).randint(
        0, LM_KW["vocab_size"], (rows, SEQ)).astype(np.int64)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_lm_directory_logits_match_jax(tmp_path, writer, flash):
    d = _save_lm(jfluid if writer == "jax" else fluid, tmp_path, flash)
    pred = create_predictor(Config(d), device="cpu")
    tokens = _tokens()
    (got,) = pred.run([tokens])
    (want,) = _jpred(d).run([tokens])
    assert got.shape == (2, SEQ, LM_KW["vocab_size"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
    # the module over the scope's tensors computes the same logits
    assert pred.gpt_config.use_flash_attention == flash
    lm = pred.lm(torch.as_tensor(tokens)).numpy()
    np.testing.assert_allclose(lm, got, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_quantized_lm_directory_matches_jax(tmp_path, writer, mode):
    """Quantization at load rewrites the Program as JAX's does: the
    report row for row, the op types, and logits at
    tests/test_torch_quant.py's tolerance."""
    d = _save_lm(jfluid if writer == "jax" else fluid, tmp_path, False)
    pred = _pred(d, quant=mode)
    jpred = _jpred(d, quant=mode)
    assert pred.quantize_report.to_dict()["vars"] == \
        jpred.quantize_report.to_dict()["vars"]
    assert pred.quantize_report.summary() == jpred.quantize_report.summary()
    ops = [op.type for op in pred._program.global_block().ops]
    jops = [op.type for op in jpred._program.global_block().ops]
    assert ops == jops and ops.count("quantized_fc") == 9
    # the float originals left the scope
    assert pred._scope.find_var("dec0_qkv.w") is None
    tokens = _tokens()
    (got,) = pred.run([tokens])
    want = np.asarray(jpred.run([tokens])[0])
    atol = 2.0 ** -8 * np.abs(want).max() if mode == "fp8" else 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)


def test_lm_module_shares_the_scope_tensors(tmp_path):
    """``pred.lm`` is built over the scope's tensors, not copies: float
    parameters and, after quantization at load, the ``.q`` / ``.qscale``
    buffers. A write through one is seen by the other."""
    d = _save_lm(jfluid, tmp_path, False)
    pred = create_predictor(Config(d), device="cpu")
    scope = pred._scope
    for name, p in pred.lm.jax_params().items():
        assert p.data_ptr() == scope.find_var(name).data_ptr(), name
    assert pred.clone().lm is pred.lm
    saved = scope.find_var("gpt_head.b").clone()
    with torch.no_grad():
        scope.find_var("gpt_head.b").add_(1.0)
        assert torch.equal(pred.lm.head.b, saved + 1.0)
        scope.find_var("gpt_head.b").copy_(saved)
    qpred = _pred(d, quant="int8")
    qs = qpred._scope
    for lyr in qpred.lm.layers:
        for fc in ("qkv", "proj", "ffn1", "ffn2"):
            dense = getattr(lyr, fc)
            assert isinstance(dense, QuantizedDense)
            assert dense.qweight.data_ptr() == \
                qs.find_var(dense.name + ".q").data_ptr()
            assert dense.scale.data_ptr() == \
                qs.find_var(dense.name + ".qscale").data_ptr()
            assert dense.b.data_ptr() == \
                qs.find_var(dense.name[:-2] + ".b").data_ptr()
    assert isinstance(qpred.lm.head, QuantizedDense)
    # the engine's quantize seam quantizes a float Program predictor's
    # Program and module together
    from paddle_tpu_torch.generation import GenerationEngine

    eng = GenerationEngine(pred, pred.gpt_config, page_size=4, num_pages=16,
                           max_decode_batch=2, chunk_tokens=4,
                           quantize_weights="int8", start=False)
    try:
        assert pred.quantize_report is eng.quantize_report
        assert pred.quantize_report.n_quantized == 9
        assert scope.find_var("dec0_qkv.w") is None
        qkv = pred.lm.layers[0].qkv
        assert isinstance(qkv, QuantizedDense)
        assert qkv.qweight.data_ptr() == \
            scope.find_var("dec0_qkv.w.q").data_ptr()
        (got,) = pred.run([_tokens()])
        (want,) = qpred.run([_tokens()])
        np.testing.assert_array_equal(got, want)
    finally:
        eng.close()


# -- a convolutional net ---------------------------------------------------------


def _small_resnet(pkg, resnet):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        img = pkg.layers.data("image", [3, 16, 16])
        x = resnet._conv_bn(img, 8, 3, stride=2, name="stem")
        x = pkg.layers.pool2d(x, 3, "max", pool_stride=2, pool_padding=1)
        x = resnet._bottleneck(x, 4, 1, "a")
        x = resnet._bottleneck(x, 4, 2, "b")
        pool = pkg.layers.pool2d(x, 2, "avg", global_pooling=True)
        logits = pkg.layers.fc(pool, 5, param_attr=pkg.ParamAttr(
            name="head.w"))
        prob = pkg.layers.softmax(logits)
    return main.clone(for_test=True), startup, prob


def test_two_bottleneck_resnet_inference_matches_jax(tmp_path):
    """A two-bottleneck net cloned for test (batch norm over its moving
    statistics, which are made non-trivial first), saved by JAX, run by
    both predictors with batch bucketing."""
    main, startup, prob = _small_resnet(jfluid, jresnet)
    scope = jfluid.Scope()
    rng = np.random.RandomState(3)
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        for v in main.global_block().vars.values():
            if v.name.endswith(".bn.mean"):
                scope.set_var(v.name, rng.randn(*v.shape).astype("float32"))
            elif v.name.endswith(".bn.var"):
                scope.set_var(v.name, rng.uniform(0.5, 2.0, v.shape)
                              .astype("float32"))
        jfluid.io.save_inference_model(str(tmp_path), ["image"], [prob], exe,
                                       main)
    assert all(op["attrs"].get("is_test") for op in
               fluid.io.load_model_meta(str(tmp_path))["program"]["blocks"][0]
               ["ops"] if op["type"] == "batch_norm")
    # the port builds the same inference program
    tmain, _ts, tprob = _small_resnet(fluid, tresnet)
    assert fluid.io._prune_program(tmain, ["image"], [tprob]).to_dict() == \
        fluid.io.load_model_meta(str(tmp_path))["program"]
    buckets = {"batch_buckets": (2, 4)}
    pred = _pred(str(tmp_path), buckets=buckets)
    jpred = _jpred(str(tmp_path), buckets=buckets)
    for n in (1, 3):
        x = rng.randn(n, 3, 16, 16).astype("float32")
        (got,) = pred.run([x])
        (want,) = jpred.run([x])
        assert got.shape == (n, 5)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    # a static dim 1 (channels) is never sequence-padded
    assert pred._seq_feed_names == set()


# -- the meta shape route and the refusals ------------------------------------------


def test_true_shapes_come_from_meta_tensors(tmp_path):
    _export_masked_model(tmp_path)
    pred = _pred(str(tmp_path), buckets={"seq_buckets": (16,)})
    feed = {"ids": np.ones((3, 7), np.int64),
            "mask": np.ones((3, 7), np.float32)}
    assert eval_shapes(pred._program, feed, pred.get_output_names(),
                       pred._scope) == [(3, 16)]
    assert pred._true_fetch_shapes(feed) == [(3, 16)]
    assert feed_signature(feed) in pred._trueshape_cache
    # a float64 feed (JSON's numbers) shares the entry of its declared
    # float32: the bound step casts it before any op runs
    n = len(pred._trueshape_cache)
    assert pred._true_fetch_shapes(dict(
        feed, mask=feed["mask"].astype(np.float64))) == [(3, 16)]
    assert len(pred._trueshape_cache) == n
    # numpy and tensors give one signature
    assert feed_signature({k: torch.from_numpy(v) for k, v in feed.items()}) \
        == feed_signature(feed)


class _FakeCuda:
    """Stands for a CUDA tensor where this CPU box has none: all the
    routing reads is its device."""
    device = torch.device("cuda", 0)


def test_meta_route_is_only_for_shape_evaluation_never_cuda():
    m = torch.device("meta")
    x, g = torch.empty(4, 8, device=m), torch.empty(8, device=m)
    before = layer_norm.launches
    with pytest.raises(ValueError, match="unsupported device"):
        layer_norm(x, g, g)
    with _build.evaluating_shapes():
        assert layer_norm(x, g, g).device.type == "meta"
        assert _build.takes_plain(x)
        # a CUDA tensor never takes the plain (or meta) route
        assert not _build.takes_plain(_FakeCuda())
    assert not _build.takes_plain(x)
    assert not _build.takes_plain(_FakeCuda())
    assert layer_norm.launches == before


def test_refusals_name_their_roadmap_items(tmp_path):
    with pytest.raises(NotImplementedError, match="A10"):
        Config(str(tmp_path)).enable_partitioning(mesh_axes={"tp": 2})
    cfg = GPTConfig(**LM_KW)
    params = {}
    from paddle_tpu_torch.generation.model import GPTLM

    lm = GPTLM(cfg, "cpu")
    for n, p in lm.jax_params().items():
        params[n] = np.zeros(tuple(p.shape), np.float32)
    pred = create_predictor(Config().set_params(cfg, params), device="cpu")
    assert pred.get_input_names() == ["tokens"]
    with pytest.raises(ValueError, match="pred.lm"):
        pred.run([np.zeros((1, 4), np.int64)])
