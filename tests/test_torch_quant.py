"""paddle_tpu_torch's weight quantization (K11's plain path, the module
rewrite, the predictor seam) against the JAX package, on the CPU.

The same numpy-seeded weights go through ``paddle_tpu.kernels.
quant_matmul`` / ``paddle_tpu.quantize`` and their port counterparts:
quantized bytes and scales must be equal bit for bit (both round half
to even), the plain matmul equal to JAX's reference up to float32
summation order, and the rewrite report equal row for row.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import quantize as jax_quantize
from paddle_tpu.generation.model import GPTConfig as JaxGPTConfig
from paddle_tpu.generation.model import build_lm_program
from paddle_tpu.inference import Config as JaxConfig
from paddle_tpu.inference import create_predictor as jax_create_predictor
from paddle_tpu.kernels import quant_matmul as jqm
from paddle_tpu_torch import quantize, set_flags
from paddle_tpu_torch.generation import GenerationEngine
from paddle_tpu_torch.generation.model import QuantizedDense
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.kernels import quant_matmul as pqm

MODES = ("int8", "int8_block", "fp8")
CFG = JaxGPTConfig(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                   ffn_size=64, max_position=64, hidden_dropout=0.0,
                   attention_dropout=0.0)
SEQ = 40


def _bytes(a):
    """The raw bytes of a quantized weight (int8 or e4m3), as uint8."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _edge_weight(K=70, N=9, seed=0):
    """Random columns, an all-zero column, a column whose max is
    negative (it quantizes to -127 / -448), a tiny column."""
    w = np.random.RandomState(seed).randn(K, N).astype(np.float32)
    w[:, 2] = 0.0
    w[:, 3] = -np.abs(w[:, 3])
    w[5, 3] = -9.5
    w[:, 4] *= 1e-6
    return w


# -- quantize_weight and the plain matmul --------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("K,block", [(70, 32), (64, 64), (130, 256)])
def test_quantize_weight_equals_jax_bitwise(mode, K, block):
    w = _edge_weight(K)
    jq, js = jqm.quantize_weight(w, mode, block=block)
    pq, ps = pqm.quantize_weight(torch.from_numpy(w), mode, block=block)
    assert pq.dtype == pqm.weight_dtype(mode)
    np.testing.assert_array_equal(_bytes(pq), _bytes(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert tuple(ps.shape) == pqm.scale_shape(w.shape, mode, block)
    # the all-zero column (block) gets scale 1.0
    if mode == "int8_block":
        assert np.all(ps.numpy()[:, 2] == 1.0)
    else:
        assert ps[2] == 1.0
        # every column's max magnitude lands on the format's max
        qmax = 448.0 if mode == "fp8" else 127.0
        col = pq.float().numpy()[:, 3]
        assert col.min() == -qmax
    wd = pqm.dequantize_weight(pq, ps, mode, block)
    np.testing.assert_array_equal(
        wd.float().numpy(),
        np.asarray(jqm.dequantize_weight(jq, js, mode, block), np.float32))
    assert pqm.quantized_weight_bytes(w.shape, mode, block) == \
        jqm.quantized_weight_bytes(w.shape, mode, block)


def test_quantize_weight_validates():
    with pytest.raises(ValueError, match="mode"):
        pqm.quantize_weight(np.zeros((4, 4), np.float32), "int4")
    with pytest.raises(ValueError, match="2-D"):
        pqm.quantize_weight(np.zeros((4,), np.float32))
    with pytest.raises(ValueError, match="mode"):
        pqm.quantized_matmul(torch.zeros(2, 4), torch.zeros(4, 3,
                                                            dtype=torch.int8),
                             torch.ones(3), mode="nope")
    q, s = pqm.quantize_weight(torch.zeros(4, 3), "int8")
    with pytest.raises(ValueError, match="scales"):
        pqm.quantized_matmul(torch.zeros(2, 4), q, torch.ones(4),
                             mode="int8")
    with pytest.raises(TypeError, match="weight"):
        pqm.quantized_matmul(torch.zeros(2, 4), q, s, mode="fp8")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(5, 70, 33), (16, 256, 128),
                                   (3, 130, 200)])
def test_plain_quantized_matmul_matches_jax(mode, shape):
    """Against JAX's reference (the same dequantized weight; float32
    sums in another order: 1e-5 of the output's scale) and against the
    Pallas body in interpret mode (scale on the accumulator: JAX's own
    bound, 2e-2 of max(|ref|, 1))."""
    import jax.numpy as jnp

    M, K, N = shape
    rng = np.random.RandomState(1)
    w = (rng.randn(K, N) * 0.3).astype(np.float32)
    x = rng.randn(M, K).astype(np.float32)
    blk = 64
    jq, js = jqm.quantize_weight(w, mode, block=blk)
    pq, ps = pqm.quantize_weight(torch.from_numpy(w), mode, block=blk)
    got = pqm.quantized_matmul(torch.from_numpy(x), pq, ps, mode=mode,
                               block=blk).numpy()
    assert got.shape == (M, N) and got.dtype == np.float32
    ref = np.asarray(jqm._reference_quant_matmul(jnp.asarray(x), jq, js, mode,
                                                 blk), np.float32)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() <= 1e-5 * scale
    pal = np.asarray(jqm._quant_matmul_pallas(jnp.asarray(x), jq, js, mode,
                                              blk, interpret=True),
                     np.float32)
    assert np.abs(got - pal).max() <= 2e-2 * scale
    # leading dims flatten and restore
    got3 = pqm.quantized_matmul(torch.from_numpy(x).reshape(M, 1, K), pq, ps,
                                mode=mode, block=blk)
    assert tuple(got3.shape) == (M, 1, N)
    np.testing.assert_array_equal(got3.reshape(M, N).numpy(), got)


# -- the rewrite, the predictor, the engine ------------------------------------


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_quant_lm"))
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
    if mode is not None:
        c.enable_weight_quantization(mode)
    return create_predictor(c, device="cpu")


@pytest.mark.parametrize("mode,block", [("int8", 256), ("int8_block", 16),
                                        ("fp8", 256)])
def test_rewrite_report_equals_jax(lm_dir, mode, block):
    main, startup, _f, _fetches = build_lm_program(CFG, SEQ)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.TPUPlace()).run(startup)
        want = jax_quantize.rewrite_for_inference(main, scope, mode,
                                                  block=block)
    pred = _port_pred(lm_dir)
    got = quantize.rewrite_for_inference(pred.lm, mode, block=block)
    assert got.rows == want.rows
    assert got.summary() == want.summary()
    assert got.skip_reasons() == want.skip_reasons()
    assert got.n_quantized == 9
    # the float originals are gone: the modules hold qweight + scale
    for _p, _a, dense in pred.lm.dense_layers():
        assert isinstance(dense, QuantizedDense) and not hasattr(dense, "w")
    assert "dec0_qkv.w" not in pred.lm.jax_params()


def test_rewrite_is_idempotent_and_refuses_another_mode(lm_dir):
    pred = _port_pred(lm_dir, "int8")
    assert pred.quantize_report.n_quantized == 9
    before = [d for _p, _a, d in pred.lm.dense_layers()]
    again = quantize.rewrite_for_inference(pred.lm, "int8")
    assert again.n_quantized == 0
    assert [d for _p, _a, d in pred.lm.dense_layers()] == before
    with pytest.raises(ValueError, match="same mode and block"):
        quantize.rewrite_for_inference(pred.lm, "fp8")
    with pytest.raises(ValueError, match="same mode and block"):
        quantize.rewrite_for_inference(pred.lm, "int8", block=128)
    with pytest.raises(ValueError, match="same mode and block"):
        GenerationEngine(pred, pred.gpt_config, quantize_weights="int8_block",
                         start=False)
    with pytest.raises(ValueError, match="wdtype"):
        quantize.rewrite_for_inference(pred.lm, "int4")


def test_predictor_and_engine_share_one_set_of_weights(lm_dir):
    """An engine asked to quantize an unquantized predictor rewrites the
    shared model once: the caller's predictor reports it and keeps
    running on the quantized weights; a second engine reuses them."""
    pred = _port_pred(lm_dir)
    assert pred.quantize_report is None
    eng = GenerationEngine(pred, pred.gpt_config, page_size=4, num_pages=32,
                           max_decode_batch=2, quantize_weights="int8")
    try:
        assert len(eng.generate([3, 5, 7], max_new_tokens=4,
                                timeout=120)) == 4
    finally:
        eng.close()
    assert pred.quantize_report is eng.quantize_report
    assert pred.quantize_report.n_quantized == 9
    qkv = pred.lm.layers[0].qkv
    assert isinstance(qkv, QuantizedDense)
    assert eng._step_model.lm.layers[0].qkv is qkv
    logits = pred.lm(torch.zeros((1, 8), dtype=torch.long))
    assert bool(torch.isfinite(logits).all())
    eng2 = GenerationEngine(pred, pred.gpt_config, quantize_weights="int8",
                            start=False)
    assert eng2.quantize_report is pred.quantize_report
    assert pred.lm.layers[0].qkv is qkv
    eng2.close()


@pytest.mark.parametrize("mode", MODES)
def test_quantized_predictor_logits_match_jax(lm_dir, mode):
    c = JaxConfig(lm_dir)
    c.enable_weight_quantization(mode)
    jpred = jax_create_predictor(c)
    pred = _port_pred(lm_dir, mode)
    tokens = np.random.RandomState(11).randint(0, CFG.vocab_size,
                                               (2, SEQ)).astype(np.int64)
    (want,) = jpred.run([tokens])
    (got,) = pred.run([tokens])
    want = np.asarray(want)
    # float32 summation order (1e-4, the fp32 predictor's bound); fp8
    # rounds every activation to bfloat16 before its matmul, so a last-
    # bit difference upstream can flip that rounding: one bfloat16 step
    # (2^-8) of the largest logit
    atol = 2.0 ** -8 * np.abs(want).max() if mode == "fp8" else 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)
    assert pred.quantize_report.summary() == \
        jpred.quantize_report.summary()


def test_flag_consumed_at_predictor_construction(lm_dir):
    set_flags({"quantize_weights": "int8_block", "quantize_block": 16})
    try:
        pred = create_predictor(Config(lm_dir), device="cpu")
    finally:
        set_flags({"quantize_weights": "off", "quantize_block": 256})
    rep = pred.quantize_report
    assert rep is not None and rep.n_quantized == 9
    assert (rep.mode, rep.block) == ("int8_block", 16)
    assert tuple(pred.lm.layers[1].ffn2.scale.shape) == (4, 32)
    # the Config override wins over the flag; "off" keeps float weights
    set_flags({"quantize_weights": "int8"})
    try:
        c = Config(lm_dir)
        c.enable_weight_quantization("off")
        assert create_predictor(c, device="cpu").quantize_report is None
    finally:
        set_flags({"quantize_weights": "off"})
