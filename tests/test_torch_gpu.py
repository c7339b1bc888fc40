"""paddle_tpu_torch's CUDA kernels and engine on the card.

Every test here needs an NVIDIA GPU and skips without one (the check
runs inside a fixture, never at import). The file imports no JAX, so it
runs on a machine without it; there the repository's conftest (which
imports JAX) is left out:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Kernels are held against their plain PyTorch versions on the same CUDA
inputs (float32 atol/rtol 2e-5, bfloat16 2e-2: summation order and the
online softmax); the engine on CUDA against the same engine on the CPU.
"""

import contextlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.generation import GenerationEngine
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.kernels.paged_attention import split_geometry
from paddle_tpu_torch.kernels.quant_matmul import MMA_DEPTH
from paddle_tpu_torch.models.gpt import GPTConfig

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C", [(128, 2048), (300, 2048), (37, 96),
                                 (5, 8192), (1, 1), (8, 2048), (4096, 1024),
                                 (3, 33), (16, 2050), (2, 32768)])
def test_layer_norm_kernel_matches_plain(cuda, R, C, dtype):
    g = torch.Generator(device=cuda).manual_seed(R * 7 + C)
    x = (2 * torch.randn(R, C, device=cuda, generator=g) + 0.5).to(dtype)
    gamma = (1 + 0.1 * torch.randn(C, device=cuda, generator=g)).to(dtype)
    beta = (0.1 * torch.randn(C, device=cuda, generator=g)).to(dtype)
    before = K.layer_norm.launches
    y = K.layer_norm(x, gamma, beta)
    torch.cuda.synchronize()
    assert K.layer_norm.launches == before + 1
    torch.testing.assert_close(y, K.layer_norm_plain(x, gamma, beta),
                               **TOL[dtype])


# (B, C, H, KVH, D, P, ps, maxp, starts, num_valid)
RAGGED = {
    "mixed": (4, 5, 4, 4, 8, 24, 4, 5, [0, 6, 9, 0], [5, 1, 3, 0]),
    "gqa": (4, 5, 8, 4, 64, 24, 4, 5, [0, 6, 9, 0], [5, 1, 3, 0]),
    "slice": (8, 16, 16, 16, 128, 512, 16, 64,
              [0, 100, 767, 400, 16, 250, 700, 0],
              [16, 1, 1, 16, 16, 1, 1, 0]),
    "wide": (2, 64, 4, 1, 256, 48, 4, 20, [3, 0], [64, 17]),
    # a prefill chunk across the split chunk's edge at 64 keys (its first
    # queries see none of the second chunk), and one across 128
    "straddle": (3, 16, 4, 2, 64, 40, 16, 12, [60, 0, 120], [16, 16, 9]),
    # pages of 3 and 7 keys: odd chunks of 63 (every shared-memory region
    # moves), D 40 (int8 rows of no whole 16 bytes)
    "pages_of_3": (4, 8, 4, 4, 40, 90, 3, 30, [0, 61, 58, 80],
                   [8, 4, 8, 1]),
    "pages_of_7": (4, 16, 8, 4, 128, 40, 7, 20, [55, 130, 0, 3],
                   [16, 1, 0, 16]),
    # pages longer than a chunk (100 keys: a chunk is part of a page)
    "long_pages": (3, 16, 4, 4, 64, 12, 100, 3, [0, 150, 290],
                   [16, 1, 10]),
}


def _ragged_inputs(cuda, case, dtype, seed):
    """q and pools of random data (stale rows everywhere, the junk page
    included), distinct pages per row, tables zero past each chain;
    dtype int8 gives int8 pools with scale planes and float32 q."""
    B, C, H, KVH, D, P, ps, maxp, starts, nvalid = RAGGED[case]
    g = torch.Generator(device=cuda).manual_seed(seed)
    rng = np.random.RandomState(seed)
    if dtype == torch.int8:
        kp, vp = (torch.randint(-127, 128, (KVH, P, ps, D), device=cuda,
                                generator=g, dtype=torch.int8)
                  for _ in range(2))
        scales = [0.02 * torch.rand(KVH, P, ps, device=cuda, generator=g)
                  for _ in range(2)]
        q = torch.randn(B, C, H, D, device=cuda, generator=g)
    else:
        kp, vp = (torch.randn(KVH, P, ps, D, device=cuda,
                              generator=g).to(dtype) for _ in range(2))
        scales = [None, None]
        q = torch.randn(B, C, H, D, device=cuda, generator=g).to(dtype)
    tables = np.zeros((B, maxp), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        n = -(-(starts[b] + nvalid[b]) // ps) if nvalid[b] else 0
        tables[b, :n] = [free.pop() for _ in range(n)]
    ints = [torch.as_tensor(np.asarray(a, np.int32), device=cuda)
            for a in (starts, nvalid, tables)]
    return q, kp, vp, scales, ints


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(RAGGED))
def test_ragged_kernel_matches_plain(cuda, case, dtype):
    """Exactly one K2 launch is counted a call (its split pass and its
    merge), rows past num_valid are exact zeros, and two calls give the
    same bits."""
    nvalid = RAGGED[case][-1]
    q, kp, vp, _, ints = _ragged_inputs(cuda, case, dtype, len(case))
    before = K.ragged_paged_attention.launches
    out = K.ragged_paged_attention(q, kp, vp, *ints)
    torch.cuda.synchronize()
    assert K.ragged_paged_attention.launches == before + 1
    assert torch.isfinite(out).all()
    torch.testing.assert_close(
        out, K.ragged_paged_attention_plain(q, kp, vp, *ints), **TOL[dtype])
    for b, n in enumerate(nvalid):
        assert (out[b, n:] == 0).all()
    assert torch.equal(out, K.ragged_paged_attention(q, kp, vp, *ints))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("case", sorted(RAGGED))
def test_ragged_rows_do_not_depend_on_the_batch(cuda, case, dtype):
    """Row b run alone (B = 1, its own table row) equals row b of the
    batch bit for bit, in K2 and K2q."""
    q, kp, vp, (ks, vs), ints = _ragged_inputs(cuda, case, dtype, 7)
    got = K.ragged_paged_attention(q, kp, vp, *ints, k_scales=ks,
                                   v_scales=vs)
    for b in range(q.shape[0]):
        alone = K.ragged_paged_attention(
            q[b:b + 1].contiguous(), kp, vp,
            *[t[b:b + 1].contiguous() for t in ints], k_scales=ks,
            v_scales=vs)
        assert torch.equal(alone[0], got[b]), f"row {b}"


def test_ragged_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 65, 2, 8, device=cuda)          # C > 64
    pages = torch.zeros(2, 4, 4, 8, device=cuda)
    ints = [torch.zeros(1, dtype=torch.int32, device=cuda)] * 2
    tb = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="C <= 64"):
        K.ragged_paged_attention(q, pages, pages, *ints, tb)
    wide = torch.zeros(1, 4, 2, 264, device=cuda)      # D > 256
    wide_pages = torch.zeros(2, 4, 4, 264, device=cuda)
    with pytest.raises(ValueError, match="D <= 256"):
        K.ragged_paged_attention(wide, wide_pages, wide_pages, *ints, tb)
    with pytest.raises(TypeError):
        K.ragged_paged_attention(q[:, :4].half(), pages.half(), pages.half(),
                                 *ints, tb)


def _tiny_params(cfg, seed=0):
    rng = np.random.RandomState(seed)
    from paddle_tpu_torch.generation.model import GPTLM

    params = {}
    for name, p in GPTLM(cfg, device="meta").jax_params().items():
        params[name] = (0.2 * rng.randn(*p.shape)).astype(np.float32)
    return params


def test_engine_on_cuda_matches_cpu(cuda):
    cfg = GPTConfig(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
                    ffn_size=128, max_position=64, hidden_dropout=0.0,
                    attention_dropout=0.0)
    params = _tiny_params(cfg)
    preds = {dev: create_predictor(Config().set_params(cfg, params), dev)
             for dev in ("cpu", "cuda")}
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, cfg.vocab_size, (2, 40))
    logits = {dev: p.lm(torch.as_tensor(tokens)).cpu().numpy()
              for dev, p in preds.items()}
    np.testing.assert_allclose(logits["cuda"], logits["cpu"],
                               rtol=1e-4, atol=1e-4)
    prompts = [rng.randint(1, cfg.vocab_size, n) for n in (9, 23, 4, 14)]
    out = {}
    for dev, pred in preds.items():
        with GenerationEngine(pred, cfg, page_size=4, num_pages=24,
                              max_decode_batch=3, chunk_tokens=6) as eng:
            K.reset_launch_counts()
            streams = [eng.submit(p, max_new_tokens=10) for p in prompts]
            out[dev] = [s.result(timeout=300) for s in streams]
            st = eng.stats()
        counts = K.launch_counts()
        steps = st["ragged_steps_total"]
        want = (0, 0) if dev == "cpu" else (
            (2 * cfg.num_layers + 1) * steps, cfg.num_layers * steps)
        assert (counts["layer_norm"],
                counts["ragged_paged_attention"]) == want
    assert out["cuda"] == out["cpu"]


# -- the training slice's kernels (K3, K4, K5, K10) and Executor ------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C", [(2048, 2048), (300, 2048), (37, 96),
                                 (5, 8192), (1, 1), (4096, 1024), (7, 33),
                                 (16, 2050), (3, 32768)])
def test_layer_norm_bwd_kernel_matches_plain(cuda, R, C, dtype):
    g = torch.Generator(device=cuda).manual_seed(R * 5 + C)
    x = (2 * torch.randn(R, C, device=cuda, generator=g) + 0.5).to(dtype)
    gamma = (1 + 0.1 * torch.randn(C, device=cuda, generator=g)).to(dtype)
    beta = (0.1 * torch.randn(C, device=cuda, generator=g)).to(dtype)
    dy = torch.randn(R, C, device=cuda, generator=g).to(dtype)
    y, mean, rstd = K.layer_norm_fwd(x, gamma, beta)
    py, pmean, prstd = K.layer_norm_fwd_plain(x, gamma, beta)
    torch.testing.assert_close(y, py, **TOL[dtype])
    torch.testing.assert_close(mean, pmean, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(rstd, prstd, atol=2e-5, rtol=2e-5)
    before = K.layer_norm_bwd.launches
    got = K.layer_norm_bwd(x, gamma, dy, pmean, prstd)
    torch.cuda.synchronize()
    assert K.layer_norm_bwd.launches == before + 1
    want = K.layer_norm_bwd_plain(x, gamma, dy, pmean, prstd)
    torch.testing.assert_close(got[0], want[0], **TOL[dtype])
    # dgamma/dbeta sum R rows in another order than torch: a float32
    # sum's error grows with its length, so they get 2e-5 * sqrt(R)
    tol = dict(TOL[dtype], atol=max(TOL[dtype]["atol"], 2e-5 * R ** 0.5))
    for a, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, w, **tol)


def _ln_case(cuda, R, C, dtype, seed, offset=0):
    """x, gamma, beta, dy; x and dy ``offset`` elements into their
    buffers (off the kernels' 16-byte vectors when offset * itemsize is
    not a multiple of 16)."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rows(scale, shift):
        t = scale * torch.randn(R, C, device=cuda, generator=g) + shift
        buf = torch.empty(R * C + offset, dtype=dtype, device=cuda)
        out = buf[offset:].view(R, C)
        out.copy_(t)
        return out
    x = rows(2.0, 0.5)
    gamma = (1 + 0.1 * torch.randn(C, device=cuda, generator=g)).to(dtype)
    beta = (0.1 * torch.randn(C, device=cuda, generator=g)).to(dtype)
    return x, gamma, beta, rows(1.0, 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C", [(128, 2048), (300, 2048), (37, 96),
                                 (4096, 1024), (2, 32768)])
def test_layer_norm_kernels_off_alignment_equal_the_aligned_copy(cuda, R, C,
                                                                 dtype):
    """x and dy 4 bytes past 16-byte alignment take the scalar loads: the
    same columns a thread and the same order as the vector path, so the
    same bits as an aligned copy, and within tolerance of plain."""
    x, gamma, beta, dy = _ln_case(cuda, R, C, dtype, R + C,
                                  offset=32 // torch.finfo(dtype).bits)
    assert x.data_ptr() % 16 and dy.data_ptr() % 16
    fwd = K.layer_norm_fwd(x, gamma, beta)
    for a, w in zip(fwd, K.layer_norm_fwd(x.clone(), gamma, beta)):
        assert torch.equal(a, w)
    torch.testing.assert_close(fwd[0], K.layer_norm_plain(x, gamma, beta),
                               **TOL[dtype])
    _, mean, rstd = K.layer_norm_fwd_plain(x, gamma, beta)
    bwd = K.layer_norm_bwd(x, gamma, dy, mean, rstd)
    for a, w in zip(bwd, K.layer_norm_bwd(x.clone(), gamma, dy.clone(),
                                          mean, rstd)):
        assert torch.equal(a, w)
    want = K.layer_norm_bwd_plain(x, gamma, dy, mean, rstd)
    torch.testing.assert_close(bwd[0], want[0], **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C", [(128, 2048), (2048, 2048), (37, 96),
                                 (16, 2050), (3, 32768)])
def test_layer_norm_bits_repeat_and_rows_do_not_depend_on_the_batch(
        cuda, R, C, dtype):
    """Two calls give the same bits (K3's dgamma and dbeta too); a row
    run alone gives its row's y, mean and rstd (K1) and dx (K3) of the
    batch bit for bit."""
    x, gamma, beta, dy = _ln_case(cuda, R, C, dtype, R * 3 + C)
    fwd = K.layer_norm_fwd(x, gamma, beta)
    for a, w in zip(fwd, K.layer_norm_fwd(x, gamma, beta)):
        assert torch.equal(a, w)
    _, mean, rstd = fwd
    bwd = K.layer_norm_bwd(x, gamma, dy, mean, rstd)
    for a, w in zip(bwd, K.layer_norm_bwd(x, gamma, dy, mean, rstd)):
        assert torch.equal(a, w)
    for r in sorted({0, 1 % R, R // 2, R - 1}):
        one = slice(r, r + 1)
        alone = K.layer_norm_fwd(x[one].contiguous(), gamma, beta)
        for a, w in zip(alone, fwd):
            assert torch.equal(a[0], w[r]), f"K1 row {r}"
        dx = K.layer_norm_bwd(x[one].contiguous(), gamma,
                              dy[one].contiguous(), mean[one].contiguous(),
                              rstd[one].contiguous())[0]
        assert torch.equal(dx[0], bwd[0][r]), f"K3 row {r}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C,scale", [(2048, 32000, 1.0), (37, 333, 3.0),
                                       (64, 4001, 1e4), (3, 1, 1.0)])
def test_softmax_xent_kernels_match_plain(cuda, R, C, scale, dtype):
    g = torch.Generator(device=cuda).manual_seed(R + C)
    logits = (scale * torch.randn(R, C, device=cuda, generator=g)).to(dtype)
    labels = torch.randint(0, C, (R,), device=cuda, generator=g)
    labels[0], labels[-1] = 0, C - 1
    labels[1::7] = -100
    dloss = torch.rand(R, device=cuda, generator=g) + 0.5
    loss, lse = K.softmax_xent_fwd(logits, labels)
    ploss, plse = K.softmax_xent_fwd_plain(logits, labels)
    torch.testing.assert_close(loss, ploss, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, plse, atol=2e-5, rtol=2e-5)
    assert (loss[1::7] == 0).all()
    ds = K.softmax_xent_bwd(logits, labels, lse, dloss)
    torch.testing.assert_close(
        ds, K.softmax_xent_bwd_plain(logits, labels, lse, dloss), **TOL[dtype])
    assert (ds[1::7] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,clip,coeff,off", [(32000 * 2048, None, 0.0, 0),
                                              (2048, None, 0.0, 0),
                                              (4097, 0.37, 0.01, 0),
                                              (8191, 2.5, 0.01, 1)])
def test_fused_adam_kernel_matches_plain(cuda, n, clip, coeff, off, dtype):
    """float32 bit for bit (the kernel keeps the reference's order of
    roundings), bfloat16 within 2e-2; off=1 starts the tensors 4 bytes
    past 16-byte alignment (the kernel's scalar path)."""
    g = torch.Generator(device=cuda).manual_seed(n % 1000 + off)

    def make(std, square=False):
        t = std * torch.randn(n + off, device=cuda, generator=g)
        return (t.square() if square else t).to(dtype)[off:]

    state = [make(1.0), make(0.1), make(0.01), make(1e-2, square=True)]
    plain = [t.clone() for t in state]
    f32 = lambda v: torch.tensor([v], device=cuda)  # noqa: E731
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=coeff,
              clip_scale=None if clip is None else f32(clip))
    before = K.fused_adam_update.launches
    K.fused_adam_update(*state, f32(3e-4), f32(0.9 ** 3), f32(0.999 ** 3), **kw)
    K.fused_adam_update_plain(*plain, f32(3e-4), f32(0.9 ** 3),
                              f32(0.999 ** 3), **kw)
    torch.cuda.synchronize()
    assert K.fused_adam_update.launches == before + 1
    for i in (0, 2, 3):
        if dtype == torch.float32:
            assert torch.equal(state[i], plain[i])
        else:
            torch.testing.assert_close(state[i], plain[i], **TOL[dtype])


def test_tiny_gpt_training_on_cuda_matches_cpu(cuda):
    """The tiny GPT trained by the Executor on the card (kernels) and on
    the CPU (plain versions) from the same parameters: losses within
    rtol 1e-4, parameters within 2 * lr per step; exact launches."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import load_scope_arrays
    from paddle_tpu_torch.models.gpt import build_gpt_lm, synthetic_lm_batch

    cfg = GPTConfig.tiny()
    lr, steps = 1e-3, 3
    fluid.set_flags({"optimizer_fuse": "on"})
    try:
        with fluid.unique_name.guard():
            main, startup, _, fetches = build_gpt_lm(
                cfg, 16, fluid.optimizer.AdamOptimizer(lr))
    finally:
        fluid.set_flags({"optimizer_fuse": "auto"})
    cpu_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu_scope)
    arrays = {n: cpu_scope.get_numpy(n) for n in cpu_scope.local_var_names()}
    gpu_scope = fluid.Scope()
    load_scope_arrays(gpu_scope, arrays, main, cuda)
    batch = synthetic_lm_batch(np.random.RandomState(0), 4, 16, cfg.vocab_size)
    losses = {}
    for name, place, scope in (("cuda", fluid.CUDAPlace(0), gpu_scope),
                               ("cpu", fluid.CPUPlace(), cpu_scope)):
        exe = fluid.Executor(place)
        K.reset_launch_counts()
        losses[name] = [float(exe.run(main, feed=batch,
                                      fetch_list=[fetches["loss"]],
                                      scope=scope)[0]) for _ in range(steps)]
        counts = K.launch_counts()
        L = cfg.num_layers
        want = (0, 0, 0, 0, 0) if name == "cpu" else (
            (2 * L + 1) * steps, (2 * L + 1) * steps, steps, steps,
            (12 * L + 6) * steps)
        assert (counts["layer_norm"], counts["layer_norm_bwd"],
                counts["softmax_xent_fwd"], counts["softmax_xent_bwd"],
                counts["fused_adam_update"]) == want
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    for p in main.all_parameters():
        np.testing.assert_allclose(gpu_scope.get_numpy(p.name),
                                   cpu_scope.get_numpy(p.name), rtol=0,
                                   atol=2 * lr * steps, err_msg=p.name)


# flash attention: (B, H, S, D, causal, mask, bias shape or None)
FLASH = {
    "gpt_causal_d128": (1, 2, 300, 128, True, False, None),
    "bert_masked_d64": (2, 2, 200, 64, False, True, None),
    "d16_ragged": (1, 2, 130, 16, False, False, None),
    "d200_causal": (1, 1, 70, 200, True, True, None),
    "d256": (1, 1, 65, 256, False, False, None),
    "bias_full": (2, 3, 96, 64, False, True, (2, 3)),
    "bias_heads": (2, 3, 96, 64, False, False, (1, 3)),
    "bias_batch": (2, 3, 96, 64, True, False, (2, 1)),
    "bias_shared": (2, 3, 96, 64, False, True, (1, 1)),
}
# forward as the reference's flash tests hold it (2e-5); gradients
# are sums over S keys, summed in another order than the plain matmuls
FLASH_TOL = {torch.float32: (dict(atol=2e-5, rtol=2e-5),
                             dict(atol=1e-4, rtol=1e-4)),
             torch.bfloat16: (dict(atol=2e-2, rtol=2e-2),
                              dict(atol=2e-2, rtol=2e-2))}


def _flash_inputs(cuda, case, dtype, seed):
    B, H, S, D, causal, masked, bshape = FLASH[case]
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, S, D, device=cuda, generator=g)
                   .to(dtype) for _ in range(4))
    mask = bias = None
    if masked:
        keep = torch.rand(B, S, device=cuda, generator=g) > 0.3
        keep[:, 0] = True       # no fully masked causal row
        mask = torch.where(keep, 0.0, -1e30).float()
    if bshape is not None:
        bias = torch.randn(*bshape, S, S, device=cuda, generator=g)
    return q, k, v, do, mask, bias, causal, D ** -0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_attention_kernels_match_plain(cuda, case, dtype):
    q, k, v, do, mask, bias, causal, scale = _flash_inputs(cuda, case, dtype,
                                                           len(case))
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    before = K.flash_attention_fwd.launches
    o, lse = K.flash_attention_fwd(q, k, v, mask, bias, scale, causal)
    torch.cuda.synchronize()
    assert K.flash_attention_fwd.launches == before + 1
    po, plse = K.flash_attention_fwd_plain(q, k, v, mask, bias, scale, causal)
    torch.testing.assert_close(o, po, **fwd_tol)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    ref = K.flash_attention_plain(q, k, v, causal, scale, mask, bias)
    torch.testing.assert_close(o, ref, **fwd_tol)
    o2, none = K.flash_attention_fwd(q, k, v, mask, bias, scale, causal,
                                     with_lse=False)
    assert none is None and torch.equal(o2, o)
    before = dict(K.flash_attention_bwd.kernel_launches)
    got = K.flash_attention_bwd(q, k, v, mask, bias, o, lse, do, scale,
                                causal)
    torch.cuda.synchronize()
    assert all(K.flash_attention_bwd.kernel_launches[n] == before[n] + 1
               for n in before)
    want = K.flash_attention_bwd_plain(q, k, v, mask, bias, o, lse, do,
                                       scale, causal)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        tol = dict(bwd_tol)
        if name == "dbias":   # a sum over the broadcast (b, h) too
            tol = dict(atol=1e-4 * q.shape[0] * q.shape[1], rtol=1e-4)
        torch.testing.assert_close(a, b, msg=name, **tol)
    # no float atomics: a second backward gives the same bits
    again = K.flash_attention_bwd(q, k, v, mask, bias, o, lse, do, scale,
                                  causal)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


# the tensor-core backward over head dims, lengths and masks: (kind,
# bias shape or None); "dead_row" masks every key of batch row 1
FLASH_BWD_KINDS = {"causal": None, "batch_mask": None, "dead_row": None,
                   "bias_full": (2, 2), "bias_heads": (1, 2),
                   "bias_batch": (2, 1), "bias_shared": (1, 1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S", [1000, 1024])
@pytest.mark.parametrize("kind", sorted(FLASH_BWD_KINDS))
def test_flash_backward_over_head_dims_and_lengths(cuda, dtype, D, S, kind):
    B, H = 2, 2
    g = torch.Generator(device=cuda).manual_seed(D + S + len(kind))
    q, k, v, do = (torch.randn(B, H, S, D, device=cuda, generator=g)
                   .to(dtype) for _ in range(4))
    mask = bias = None
    if kind in ("batch_mask", "dead_row") or kind.startswith("bias"):
        keep = torch.rand(B, S, device=cuda, generator=g) > 0.3
        keep[:, 0] = True
        if kind == "dead_row":
            keep[1] = False
        mask = torch.where(keep, 0.0, -1e30).float()
    bshape = FLASH_BWD_KINDS[kind]
    if bshape is not None:
        bias = torch.randn(*bshape, S, S, device=cuda, generator=g)
    causal, scale = kind == "causal", D ** -0.5
    o, lse = K.flash_attention_fwd(q, k, v, mask, bias, scale, causal)
    got = K.flash_attention_bwd(q, k, v, mask, bias, o, lse, do, scale,
                                causal)
    want = K.flash_attention_bwd_plain(q, k, v, mask, bias, o, lse, do,
                                       scale, causal)
    bwd_tol = FLASH_TOL[dtype][1]
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        tol = dict(bwd_tol)
        if name == "dbias":   # a sum over the broadcast (b, h) too
            tol = dict(atol=1e-4 * B * H, rtol=1e-4)
        if kind == "dead_row":
            # batch row 1 has no key: exp(NEG_INF - lse) is 1 for every
            # key (float32 absorbs log S into -1e30), so its gradients
            # are sums of S terms of size sqrt(D), about 150 here, and
            # their error follows that scale, not each element's: the
            # atol is taken relative to the largest entry of the row
            # (bf16: about one bf16 step there, P and dS being bf16)
            torch.testing.assert_close(a[0], b[0], msg=name, **tol)
            scale_1 = max(1.0, float(b[1].float().abs().max()))
            torch.testing.assert_close(
                a[1], b[1], msg=f"{name} (fully masked batch row)",
                atol=tol["atol"] * scale_1, rtol=tol["rtol"])
            continue
        torch.testing.assert_close(a, b, msg=name, **tol)
    again = K.flash_attention_bwd(q, k, v, mask, bias, o, lse, do, scale,
                                  causal)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S", [1000, 1024])
@pytest.mark.parametrize("kind", sorted(FLASH_BWD_KINDS))
def test_flash_forward_over_head_dims_and_lengths(cuda, dtype, D, S, kind):
    """The tensor-core forward at every shape bucket against its plain
    version: o at the forward tolerance, lse at 1e-4, a fully masked
    row equal to the mean of V, two forwards equal bit for bit."""
    B, H = 2, 2
    g = torch.Generator(device=cuda).manual_seed(7 * D + S + len(kind))
    q, k, v = (torch.randn(B, H, S, D, device=cuda, generator=g).to(dtype)
               for _ in range(3))
    mask = bias = None
    if kind in ("batch_mask", "dead_row") or kind.startswith("bias"):
        keep = torch.rand(B, S, device=cuda, generator=g) > 0.3
        keep[:, 0] = True
        if kind == "dead_row":
            keep[1] = False
        mask = torch.where(keep, 0.0, -1e30).float()
    bshape = FLASH_BWD_KINDS[kind]
    if bshape is not None:
        bias = torch.randn(*bshape, S, S, device=cuda, generator=g)
    causal, scale = kind == "causal", D ** -0.5
    o, lse = K.flash_attention_fwd(q, k, v, mask, bias, scale, causal)
    po, plse = K.flash_attention_fwd_plain(q, k, v, mask, bias, scale, causal)
    torch.testing.assert_close(o, po, **FLASH_TOL[dtype][0])
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    if kind == "dead_row":
        mean_v = v[1].float().mean(dim=1, keepdim=True).expand(H, S, D)
        torch.testing.assert_close(o[1].float(), mean_v,
                                   **FLASH_TOL[dtype][0])
    o2, lse2 = K.flash_attention_fwd(q, k, v, mask, bias, scale, causal)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_forward_causal_dead_rows_of_the_last_tile(cuda, dtype, D):
    """Causal with every key masked but the last, at S = 1000 (no whole
    key tile): a row before the last sees only NEG_INF scores and
    averages V over every key it visits. The rows of the last query
    tile visit every key tile, so they equal the plain version's mean
    over all S keys; the padding keys past S must not count."""
    B, H, S = 1, 2, 1000
    g = torch.Generator(device=cuda).manual_seed(D)
    q, k, v = (torch.randn(B, H, S, D, device=cuda, generator=g).to(dtype)
               for _ in range(3))
    mask = torch.full((B, S), -1e30, device=cuda)
    mask[:, -1] = 0.0
    scale = D ** -0.5
    o, lse = K.flash_attention_fwd(q, k, v, mask, None, scale, True)
    po, plse = K.flash_attention_fwd_plain(q, k, v, mask, None, scale, True)
    tail = slice(S - 8, S)   # inside the last query tile at every shape
    torch.testing.assert_close(o[:, :, tail], po[:, :, tail],
                               **FLASH_TOL[dtype][0])
    torch.testing.assert_close(lse[:, :, tail], plse[:, :, tail],
                               atol=1e-4, rtol=1e-5)


def test_flash_attention_autograd_and_fully_masked_row(cuda):
    """The public function on CUDA: kernels forward and backward, a
    fully masked row averaging V (non-causal), and D > 256 refused."""
    g = torch.Generator(device=cuda).manual_seed(3)
    B, H, S, D = 2, 2, 256, 64
    q, k, v = (torch.randn(B, H, S, D, device=cuda, generator=g)
               .requires_grad_() for _ in range(3))
    keep = torch.rand(B, S, device=cuda, generator=g) > 0.5
    keep[1] = False                       # batch row 1: every key masked
    o = K.flash_attention(q, k, v, mask=keep)
    mean_v = v[1].mean(dim=1, keepdim=True).expand(H, S, D)
    torch.testing.assert_close(o[1], mean_v, atol=2e-5, rtol=2e-5)
    before = K.flash_attention_bwd.launches
    (o[0].square().sum()).backward()
    torch.cuda.synchronize()
    assert K.flash_attention_bwd.launches == before + 1
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    oc = K.flash_attention(qc, kc, vc, mask=keep.cpu())
    (oc[0].square().sum()).backward()
    for a, b in ((q, qc), (k, kc), (v, vc)):
        torch.testing.assert_close(a.grad.cpu(), b.grad, atol=1e-4,
                                   rtol=1e-4)
    big = torch.zeros(1, 1, 8, 264, device=cuda)
    with pytest.raises(ValueError, match="D <= 256"):
        K.flash_attention(big, big, big)


def test_tiny_bert_amp_on_cuda_matches_cpu(cuda):
    """The tiny BERT with flash attention under bfloat16 AMP, trained on
    the card (kernels) and on the CPU (plain versions) from the same
    parameters: losses within rtol 2e-3 (bfloat16 products rounded after
    float32 sums in another order: one bfloat16 step, 2^-8, apart at
    most), parameters within 2 * lr per step; 2 flash forward and 2
    flash backward launches a step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from paddle_tpu_torch.io import load_scope_arrays
    from paddle_tpu_torch.models.bert import (BertConfig, build_bert_pretrain,
                                              synthetic_batch)

    cfg = BertConfig.tiny()
    cfg.use_flash_attention = True
    cfg.hidden_dropout = cfg.attention_dropout = 0.0
    lr, steps = 1e-3, 3
    fluid.set_flags({"optimizer_fuse": "on"})
    try:
        with fluid.unique_name.guard():
            main, startup, _, fetches = build_bert_pretrain(
                cfg, 64, decorate(fluid.optimizer.AdamOptimizer(lr),
                                  init_loss_scaling=1.0,
                                  use_dynamic_loss_scaling=False,
                                  dest_dtype="bfloat16"))
    finally:
        fluid.set_flags({"optimizer_fuse": "auto"})
    cpu_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu_scope)
    arrays = {n: cpu_scope.get_numpy(n) for n in cpu_scope.local_var_names()}
    gpu_scope = fluid.Scope()
    load_scope_arrays(gpu_scope, arrays, main, cuda)
    batch = synthetic_batch(np.random.RandomState(0), 4, 64, cfg.vocab_size,
                            min_len=16)
    losses = {}
    for name, place, scope in (("cuda", fluid.CUDAPlace(0), gpu_scope),
                               ("cpu", fluid.CPUPlace(), cpu_scope)):
        exe = fluid.Executor(place)
        K.reset_launch_counts()
        losses[name] = [float(np.asarray(exe.run(
            main, feed=batch, fetch_list=[fetches["loss"]],
            scope=scope)[0]).reshape(-1)[0]) for _ in range(steps)]
        n = 0 if name == "cpu" else cfg.num_layers * steps
        counts = K.launch_counts()
        assert (counts["flash_attention_fwd"],
                counts["flash_attention_bwd"]) == (n, n)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=2e-3)
    for p in main.all_parameters():
        np.testing.assert_allclose(gpu_scope.get_numpy(p.name),
                                   cpu_scope.get_numpy(p.name), rtol=0,
                                   atol=2 * lr * steps, err_msg=p.name)


# -- the quantized, multi-adapter serving slice's kernels (K11, K2q, K12) ----------


def _k_tol(K_, ref):
    """2e-6 * sqrt(K) of the output's scale: float32 sums over K in
    another order than the plain version's. K11's fp8 and K12 take the
    plain version's products; K11's int8 modes take exact products of q
    and three bf16 terms of x and scale the finished (block) sum, one
    rounding more a product than the plain version's scaled weights."""
    return 2e-6 * K_ ** 0.5 * max(1.0, float(ref.abs().max()))


# (M, K, N, block): the serving qkv and ffn2, M = 1, N not a multiple of
# the 64-column tile, an int8_block K tail (700 = 2 x 256 + 188), a block
# that does not divide the 32-row K step
QMM = {"qkv": (128, 2048, 6144, 256), "ffn2": (128, 8192, 2048, 256),
       "m1": (1, 2048, 6144, 256), "n_tail": (37, 96, 97, 256),
       "k_tail": (37, 700, 200, 256), "block_48": (5, 130, 33, 48)}


@pytest.mark.parametrize("mode", ["int8", "int8_block", "fp8"])
@pytest.mark.parametrize("case", sorted(QMM))
def test_quant_matmul_kernel_matches_plain(cuda, case, mode):
    M, K_, N, block = QMM[case]
    g = torch.Generator(device=cuda).manual_seed(M + K_ + N)
    w = 0.02 * torch.randn(K_, N, device=cuda, generator=g)
    w[:, 1] = 0.0                                       # all-zero column
    x = torch.randn(M, K_, device=cuda, generator=g)
    qw, qs = K.quantize_weight(w, mode, block)
    before = K.quantized_matmul.launches
    out = K.quantized_matmul(x, qw, qs, mode=mode, block=block)
    torch.cuda.synchronize()
    assert K.quantized_matmul.launches == before + 1
    ref = K.quantized_matmul_plain(x, qw, qs, mode, block)
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= _k_tol(K_, ref)
    assert bool((out[:, 1] == 0).all())


# K11's tensor-core kernel and, for int8_block at block 100, its FMA
# kernel: M from one row to more than one row tile, N a multiple of 16 or
# not (scalar weight loads), K a multiple of the 32-row step or not
QMM_GRID = [(mode, block, M, N, K_)
            for mode, block in (("int8", 256), ("fp8", 256),
                                ("int8_block", 256), ("int8_block", 100))
            for M in (1, 37, 128, 300) for N in (2048, 2050)
            for K_ in (2000, 2048, 8192)]


@pytest.mark.parametrize("mode,block,M,N,K_", QMM_GRID)
def test_quant_matmul_kernels_over_the_shape_grid(cuda, mode, block, M, N,
                                                  K_):
    g = torch.Generator(device=cuda).manual_seed(M * 3 + N + K_)
    w = 0.02 * torch.randn(K_, N, device=cuda, generator=g)
    x = torch.randn(M, K_, device=cuda, generator=g)
    qw, qs = K.quantize_weight(w, mode, block)
    fma = block % MMA_DEPTH != 0
    counter = K.quantized_matmul_fma if fma else K.quantized_matmul
    other = K.quantized_matmul if fma else K.quantized_matmul_fma
    before = (counter.launches, other.launches)
    out = K.quantized_matmul(x, qw, qs, mode=mode, block=block)
    torch.cuda.synchronize()
    assert (counter.launches, other.launches) == (before[0] + 1, before[1])
    ref = K.quantized_matmul_plain(x, qw, qs, mode, block)
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= _k_tol(K_, ref)


@pytest.mark.parametrize("mode,block", [("int8", 256), ("fp8", 256),
                                        ("int8_block", 256),
                                        ("int8_block", 100)])
@pytest.mark.parametrize("K_,N", [(2048, 6144), (8192, 2048), (2000, 2050)])
def test_quant_matmul_rows_do_not_depend_on_the_batch(cuda, mode, block,
                                                      K_, N):
    """The rows of a 128-row call equal, bit for bit, the same rows
    computed at M = 1 and M = 37 (tile, split and summation order
    depend on K, N, mode and block only)."""
    g = torch.Generator(device=cuda).manual_seed(K_ + N)
    w = 0.02 * torch.randn(K_, N, device=cuda, generator=g)
    x = torch.randn(128, K_, device=cuda, generator=g)
    qw, qs = K.quantize_weight(w, mode, block)
    out = K.quantized_matmul(x, qw, qs, mode=mode, block=block)
    for m in (1, 37):
        assert torch.equal(
            K.quantized_matmul(x[:m], qw, qs, mode=mode, block=block),
            out[:m])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(RAGGED))
def test_ragged_q_kernel_matches_plain(cuda, case, dtype):
    """K2q over int8 pages with float32 or bf16 q: one K2q launch counted
    a call and none of K2, rows past num_valid exact zeros, two calls
    the same bits."""
    nvalid = RAGGED[case][-1]
    q, kp, vp, (ks, vs), ints = _ragged_inputs(cuda, case, torch.int8,
                                               len(case) + 1)
    q = q.to(dtype)
    before = (K.ragged_paged_attention.launches,
              K.ragged_paged_attention_q.launches)
    out = K.ragged_paged_attention(q, kp, vp, *ints, k_scales=ks,
                                   v_scales=vs)
    torch.cuda.synchronize()
    assert (K.ragged_paged_attention.launches,
            K.ragged_paged_attention_q.launches) == (before[0],
                                                     before[1] + 1)
    torch.testing.assert_close(
        out, K.ragged_paged_attention_plain(q, kp, vp, *ints, None, ks, vs),
        **TOL[dtype])
    for b, n in enumerate(nvalid):
        assert (out[b, n:] == 0).all()
    assert torch.equal(out, K.ragged_paged_attention_q(q, kp, vp, ks, vs,
                                                       *ints))


def test_quantized_kv_write_on_cuda_matches_cpu(cuda):
    """The in-place int8 write is torch ops on both devices: the same
    pools and scales, up to one int8 step where a float32 division
    rounds differently on a .5 boundary."""
    rng = np.random.RandomState(4)
    H, P, ps, D = 4, 12, 4, 64
    k_new = rng.randn(3, 5, H, D).astype(np.float32)
    v_new = rng.randn(3, 5, H, D).astype(np.float32)
    tables = np.array([[1, 2, 0], [3, 4, 5], [0, 0, 0]], np.int32)
    pos = np.array([0, 6, 0], np.int32)
    nv = np.array([5, 2, 0], np.int32)
    res = {}
    for dev in ("cpu", "cuda"):
        pools = [torch.zeros(H, P, ps, D, dtype=torch.int8, device=dev)
                 for _ in range(2)]
        scales = [torch.ones(H, P, ps, device=dev) for _ in range(2)]
        t = [torch.as_tensor(a, device=dev)
             for a in (k_new, v_new, tables, pos, nv)]
        K.quantized_kv_cache_write(*pools, *scales, *t)
        res[dev] = [a.cpu() for a in pools + scales]
    for a, b in zip(res["cuda"], res["cpu"]):
        # slot 0 of the junk page takes the invalid rows, in an order
        # neither device defines: left out
        a[:, 0, 0] = b[:, 0, 0]
        if a.dtype == torch.int8:
            assert int((a.int() - b.int()).abs().max()) <= 1
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


# (R, rep, K, N, ranks per bucket, slots [R, n_buckets])
LORA = {
    "mixed": (4, 16, 2048, 8192, (8, 16),
              [[0, 0], [1, 0], [0, 2], [1, 0]]),
    "head": (3, 16, 2048, 32000, (8, 16), [[2, 0], [0, 0], [0, 1]]),
    "rank1": (6, 1, 96, 97, (1,), [[1], [0], [2], [2], [0], [1]]),
    "rank24": (2, 5, 300, 130, (24,), [[1], [2]]),
    "all_zero": (4, 16, 2048, 6144, (8, 16), [[0, 0]] * 4),
    # the serving step's ffn2 (K = 8192: the widest slices) and qkv
    "ffn2": (4, 16, 8192, 2048, (8, 16), [[0, 0], [1, 0], [0, 2], [2, 0]]),
    "qkv": (4, 16, 2048, 6144, (8, 16), [[0, 1], [2, 0], [0, 0], [1, 0]]),
    # a lane live in both buckets: its x staged once for both (one stage
    # a slice, K = 2048) or again for the second (two stages, K = 8192)
    "both_k2048": (3, 16, 2048, 2048, (8, 16), [[1, 2], [0, 1], [2, 0]]),
    "both_k8192": (3, 16, 8192, 2048, (16, 8), [[2, 1], [1, 0], [0, 0]]),
}


def _lora_case(cuda, case):
    R, rep, K_, N, ranks, slots = LORA[case]
    M = R * rep
    g = torch.Generator(device=cuda).manual_seed(M + K_)
    x = torch.randn(M, K_, device=cuda, generator=g)
    base = torch.randn(M, N, device=cuda, generator=g)
    a_pools, b_pools, scales = [], [], []
    for r in ranks:
        a = 0.05 * torch.randn(3, K_, r, device=cuda, generator=g)
        b = 0.05 * torch.randn(3, r, N, device=cuda, generator=g)
        a[0] = 0.0
        b[0] = 0.0
        sc = torch.tensor([0.0, 2.0, 0.5], device=cuda)
        a_pools.append(a)
        b_pools.append(b)
        scales.append(sc)
    sl = torch.tensor(slots, dtype=torch.int32, device=cuda)
    return rep, x, base, a_pools, b_pools, scales, sl


@pytest.mark.parametrize("case", sorted(LORA))
def test_lora_kernel_matches_plain(cuda, case):
    rep, x, base, a_pools, b_pools, scales, sl = _lora_case(cuda, case)
    K_ = x.shape[1]
    before = K.batched_lora_add_.launches
    got = K.batched_lora_add_(base.clone(), x, a_pools, b_pools, scales, sl)
    torch.cuda.synchronize()
    assert K.batched_lora_add_.launches == before + 1
    want = K.batched_lora_add_plain_(base.clone(), x, a_pools, b_pools,
                                     scales, sl)
    assert float((got - want).abs().max()) <= _k_tol(K_, want)
    # rows on slot 0 in every bucket are the base product, bit for bit
    row_zero = (sl == 0).all(dim=1).repeat_interleave(rep)
    assert torch.equal(got[row_zero], base[row_zero])
    # one bucket's delta alone (the public batched_lora_delta)
    d = K.batched_lora_delta(x, a_pools[0], b_pools[0], scales[0],
                             sl[:, 0].repeat_interleave(rep))
    dp = K.batched_lora_delta_plain(x, a_pools[0], b_pools[0], scales[0],
                                    sl[:, 0].repeat_interleave(rep))
    assert float((d - dp).abs().max()) <= _k_tol(K_, dp)


@pytest.mark.parametrize("case", ["mixed", "ffn2", "rank1", "rank24",
                                  "both_k8192"])
def test_lora_rows_do_not_depend_on_the_batch(cuda, case):
    """Two calls give the same bits; each adapter lane run alone (R = 1)
    equals its lane in the batch; the same factors at another slot index
    of a pool with another slot count give the same bits."""
    rep, x, base, a_pools, b_pools, scales, sl = _lora_case(cuda, case)
    got = K.batched_lora_add_(base.clone(), x, a_pools, b_pools, scales, sl)
    again = K.batched_lora_add_(base.clone(), x, a_pools, b_pools, scales,
                                sl)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    # the factors moved to the last slot of pools of 5 slots
    moved = [[], [], []]
    for a, b, sc in zip(a_pools, b_pools, scales):
        perm = torch.tensor([0, 3, 4], device=cuda)
        for lst, t in zip(moved, (a, b, sc)):
            big = torch.zeros((5,) + tuple(t.shape[1:]), device=cuda)
            big[perm] = t
            lst.append(big)
    remap = torch.tensor([0, 3, 4], dtype=torch.int32, device=cuda)
    for lane in range(sl.shape[0]):
        if not bool((sl[lane] != 0).any()):
            continue
        rows = slice(lane * rep, (lane + 1) * rep)
        alone = K.batched_lora_add_(base[rows].clone(), x[rows].contiguous(),
                                    a_pools, b_pools, scales, sl[lane:lane + 1])
        there = K.batched_lora_add_(base[rows].clone(), x[rows].contiguous(),
                                    *moved, remap[sl[lane:lane + 1].long()])
        torch.cuda.synchronize()
        assert torch.equal(alone, got[rows]), lane
        assert torch.equal(there, got[rows]), lane


def test_quantized_adapter_engine_on_cuda_matches_cpu(cuda):
    """int8 weights, int8 KV pages and two adapters (one a bucket): the
    card's greedy tokens equal the CPU's plain path, and every step
    launches K11, K2q and K12 as the design says."""
    from paddle_tpu_torch.adapters import AdapterStore

    cfg = GPTConfig(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
                    ffn_size=128, max_position=64, hidden_dropout=0.0,
                    attention_dropout=0.0)
    params = _tiny_params(cfg)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, cfg.vocab_size, n) for n in (9, 23, 4, 14)]
    out = {}
    for dev in ("cpu", "cuda"):
        c = Config().set_params(cfg, params)
        c.enable_weight_quantization("int8")
        pred = create_predictor(c, dev)
        store = AdapterStore.for_model(pred.lm, slots_per_bucket=2)
        frng = np.random.RandomState(5)
        for aid, r in (("a8", 8), ("a16", 16)):
            store.upload(aid, {t: ((0.1 * frng.randn(k, r)).astype(np.float32),
                                   (0.1 * frng.randn(r, n)).astype(np.float32))
                               for t, (k, n) in sorted(store.targets.items())})
        with GenerationEngine(pred, cfg, page_size=4, num_pages=32,
                              max_decode_batch=4, chunk_tokens=6,
                              kv_dtype="int8", adapter_store=store) as eng:
            K.reset_launch_counts()
            streams = [eng.submit(p, max_new_tokens=10,
                                  adapter=(None, "a8", "a16", "a8")[i])
                       for i, p in enumerate(prompts)]
            out[dev] = [s.result(timeout=300) for s in streams]
            steps = eng.stats()["ragged_steps_total"]
        counts = K.launch_counts()
        L = cfg.num_layers
        want = ((0, 0, 0, 0) if dev == "cpu" else
                ((4 * L + 1) * steps, L * steps, (4 * L + 1) * steps, 0))
        assert (counts["quantized_matmul"], counts["ragged_paged_attention_q"],
                counts["batched_lora_add_"],
                counts["ragged_paged_attention"]) == want
    assert out["cuda"] == out["cpu"]


# -- K10m (fused momentum), K13 (paged decode attention), two_lane, ResNet ---------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,clip,nesterov,off", [(512 * 512 * 9, None, False, 0),
                                                 (2048 * 1000, 0.37, True, 0),
                                                 (4097, 2.5, False, 0),
                                                 (8191, 0.5, True, 1)])
def test_fused_momentum_kernel_matches_plain(cuda, n, clip, nesterov, off,
                                             dtype):
    """Bit for bit in both dtypes: the kernel and the plain version
    update in float32 in the same order and round once; off=1 starts
    the tensors 4 bytes past 16-byte alignment (the scalar path)."""
    g = torch.Generator(device=cuda).manual_seed(n % 1000 + off)

    def make(std):
        t = std * torch.randn(n + off, device=cuda, generator=g)
        return t.to(dtype)[off:]

    state = [make(1.0), make(0.1), make(0.05)]
    plain = [t.clone() for t in state]
    f32 = lambda v: torch.tensor([v], device=cuda)  # noqa: E731
    kw = dict(mu=0.9, use_nesterov=nesterov,
              clip_scale=None if clip is None else f32(clip))
    before = K.fused_momentum_update.launches
    K.fused_momentum_update(*state, f32(0.025), **kw)
    K.fused_momentum_update_plain(*plain, f32(0.025), **kw)
    torch.cuda.synchronize()
    assert K.fused_momentum_update.launches == before + 1
    assert torch.equal(state[0], plain[0]) and torch.equal(state[2], plain[2])


# (B, H, KVH, D, ps, P, maxp, lengths)
PAGED = {
    "decode_8_lanes": (8, 16, 16, 128, 16, 512, 64,
                       [49, 0, 800, 17, 1, 768, 33, 256]),
    "gqa_4_of_16": (4, 16, 4, 128, 16, 64, 8, [1, 16, 127, 128]),
    "odd_dims": (3, 6, 3, 40, 8, 30, 5, [0, 13, 40]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PAGED))
def test_paged_attention_kernel_matches_plain(cuda, case, dtype):
    B, H, KVH, D, ps, P, maxp, lengths = PAGED[case]
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(B, H, D, device=cuda, generator=g).to(dtype)
    kp = torch.randn(KVH, P, ps, D, device=cuda, generator=g).to(dtype)
    vp = torch.randn(KVH, P, ps, D, device=cuda, generator=g).to(dtype)
    perm = torch.randperm(P - 1, device=cuda, generator=g) + 1
    tables = perm.repeat(B * maxp // (P - 1) + 1)[:B * maxp].reshape(
        B, maxp).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, device=cuda, dtype=torch.int32)
    before = K.paged_attention.launches
    got = K.paged_attention(q, kp, vp, lens, tables)
    want = K.paged_attention_plain(q, kp, vp, lens, tables)
    torch.cuda.synchronize()
    assert K.paged_attention.launches == before + 1
    torch.testing.assert_close(got, want, **TOL[dtype])
    assert bool((got[lens == 0] == 0).all())


def _paged_inputs(cuda, dtype, B, H, KVH, D, ps, P, maxp, seed=5):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, H, D, device=cuda, generator=g).to(dtype)
    kp = torch.randn(KVH, P, ps, D, device=cuda, generator=g).to(dtype)
    vp = torch.randn(KVH, P, ps, D, device=cuda, generator=g).to(dtype)
    perm = torch.randperm(P - 1, device=cuda, generator=g) + 1
    tables = perm.repeat(B * maxp // (P - 1) + 1)[:B * maxp].reshape(
        B, maxp).to(torch.int32).contiguous()
    return q, kp, vp, tables


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps,maxp", [(16, 8), (8, 16), (4, 5), (100, 2),
                                     (3, 7), (7, 9)])
@pytest.mark.parametrize("D", [64, 37])
def test_paged_attention_split_edges(cuda, dtype, ps, maxp, D):
    """Lengths at the edges of the split key walk: 0, 1, a multiple of
    the chunk, one past it, maxp * ps and past it (clamped); a length-0
    row is exactly 0, and two calls give the same bits. Page sizes 3
    and 7 give odd chunks (63 keys) and D = 37 rows of no whole 16
    bytes, which move every shared-memory region of the block."""
    chunk, _ = split_geometry(maxp, ps)
    full = maxp * ps
    lengths = sorted({0, 1, min(chunk, full), min(chunk + 1, full),
                      full - 1, full, full + 7})
    B, H, KVH = len(lengths), 8, 2
    q, kp, vp, tables = _paged_inputs(cuda, dtype, B, H, KVH, D, ps, 40,
                                      maxp)
    lens = torch.tensor(lengths, device=cuda, dtype=torch.int32)
    got = K.paged_attention(q, kp, vp, lens, tables)
    want = K.paged_attention_plain(q, kp, vp, lens, tables)
    torch.testing.assert_close(got, want, **TOL[dtype])
    assert bool((got[lens == 0] == 0).all())
    assert torch.equal(got, K.paged_attention(q, kp, vp, lens, tables))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PAGED))
def test_paged_attention_rows_do_not_depend_on_the_batch(cuda, case, dtype):
    """Each row of a batch equals the same row run alone, bit for bit,
    and two calls on the batch give the same bits."""
    B, H, KVH, D, ps, P, maxp, lengths = PAGED[case]
    q, kp, vp, tables = _paged_inputs(cuda, dtype, B, H, KVH, D, ps, P, maxp)
    lens = torch.tensor(lengths, device=cuda, dtype=torch.int32)
    got = K.paged_attention(q, kp, vp, lens, tables)
    assert torch.equal(got, K.paged_attention(q, kp, vp, lens, tables))
    for b in range(B):
        alone = K.paged_attention(q[b:b + 1].contiguous(), kp, vp,
                                  lens[b:b + 1].contiguous(),
                                  tables[b:b + 1].contiguous())
        assert torch.equal(alone[0], got[b]), f"row {b}"


def test_two_lane_engine_on_cuda_matches_cpu(cuda):
    cfg = GPTConfig(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
                    ffn_size=128, max_position=64, hidden_dropout=0.0,
                    attention_dropout=0.0)
    params = _tiny_params(cfg, seed=1)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, cfg.vocab_size, n) for n in (9, 23, 4, 14)]
    out = {}
    for dev in ("cpu", "cuda"):
        pred = create_predictor(Config().set_params(cfg, params), dev)
        with GenerationEngine(pred, cfg, mode="two_lane", page_size=4,
                              num_pages=24, max_decode_batch=3,
                              prefill_buckets=(8, 16, 32)) as eng:
            K.reset_launch_counts()
            streams = [eng.submit(p, max_new_tokens=10) for p in prompts]
            out[dev] = [s.result(timeout=300) for s in streams]
            st = eng.stats()
        counts = K.launch_counts()
        steps = st["decode_steps_total"]
        if dev == "cuda":
            assert counts["paged_attention"] == cfg.num_layers * steps
            assert counts["ragged_paged_attention"] == 0
        eng.cache.check_integrity()
    assert out["cuda"] == out["cpu"]


def test_tiny_resnet_momentum_on_cuda_matches_cpu(cuda):
    """A full-depth ResNet-50 at 32 x 32, batch 8, three fused Momentum +
    L2Decay steps on the card (K10m, K4, K5; cuDNN with TF32 off) and on
    the CPU from the same parameters: the first loss within rtol 1e-4 and
    161 K10m launches a step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import load_scope_arrays
    from paddle_tpu_torch.models.resnet import (build_resnet50,
                                                synthetic_image_batch)

    fluid.set_flags({"optimizer_fuse": "on"})
    try:
        with fluid.unique_name.guard():
            main, startup, _, fetches = build_resnet50(
                10, 32, fluid.optimizer.MomentumOptimizer(
                    0.01, 0.9, regularization=fluid.regularizer.L2Decay(1e-4)))
        cpu_scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu_scope)
        arrays = {n: cpu_scope.get_numpy(n) for n in cpu_scope.local_var_names()}
        batch = synthetic_image_batch(np.random.RandomState(0), 8, 32, 10)
        losses = {}
        for place, dev in ((fluid.CUDAPlace(0), "cuda"),
                           (fluid.CPUPlace(), "cpu")):
            scope = fluid.Scope()
            load_scope_arrays(scope, arrays, main, dev)
            exe = fluid.Executor(place)
            K.reset_launch_counts()
            losses[dev] = [float(exe.run(main, feed=batch,
                                         fetch_list=[fetches["loss"]],
                                         scope=scope)[0]) for _ in range(3)]
            if dev == "cuda":
                assert K.fused_momentum_update.launches == 161 * 3
                assert K.softmax_xent_fwd.launches == 3
        assert np.all(np.isfinite(losses["cuda"]))
        np.testing.assert_allclose(losses["cuda"][0], losses["cpu"][0],
                                   rtol=1e-4)
    finally:
        fluid.set_flags({"optimizer_fuse": "auto"})


# -- the engine's bound steps, replayed as CUDA graphs (runtime/graphs.py) --------

GRAPH_CFG = GPTConfig(vocab_size=97, hidden_size=64, num_layers=2,
                      num_heads=4, ffn_size=128, max_position=64,
                      hidden_dropout=0.0, attention_dropout=0.0)
# (prompt length, new tokens): eight requests over four lanes, ending at
# different steps, so rows join and leave
GRAPH_REQUESTS = ((9, 3), (23, 10), (4, 6), (14, 2), (30, 8), (6, 12),
                  (17, 5), (3, 9))


def _graph_engine(kind):
    from paddle_tpu_torch.adapters import AdapterStore

    c = Config().set_params(GRAPH_CFG, _tiny_params(GRAPH_CFG))
    common = dict(page_size=4, num_pages=96, max_decode_batch=4)
    if kind == "two_lane":
        pred = create_predictor(c, "cuda")
        return GenerationEngine(pred, GRAPH_CFG, mode="two_lane",
                                prefill_buckets=(8, 16, 32), **common), None
    if kind == "float32":
        pred = create_predictor(c, "cuda")
        return GenerationEngine(pred, GRAPH_CFG, chunk_tokens=6,
                                **common), None
    c.enable_weight_quantization("int8")
    pred = create_predictor(c, "cuda")
    store = AdapterStore.for_model(pred.lm, rank_buckets=(8, 16),
                                   slots_per_bucket=4)
    frng = np.random.RandomState(5)
    for aid, r in (("a0", 8), ("a1", 16), ("a2", 8), ("a3", 16)):
        store.upload(aid, {t: ((0.1 * frng.randn(k, r)).astype(np.float32),
                               (0.1 * frng.randn(r, n)).astype(np.float32))
                           for t, (k, n) in sorted(store.targets.items())},
                     alpha=2.0 * r)
    eng = GenerationEngine(pred, GRAPH_CFG, chunk_tokens=6, kv_dtype="int8",
                           adapter_store=store, **common)
    return eng, [None, "a0", "a1", "a2", "a3", None, "a1", "a0"]


def _same_except_junk(a, b):
    # page 0 slot 0 takes every idle row's write, in no defined order
    return (torch.equal(a[:, 1:], b[:, 1:])
            and torch.equal(a[:, 0, 1:], b[:, 0, 1:]))


@pytest.mark.parametrize("kind", ["float32", "int8_adapters", "two_lane"])
def test_graphed_step_replays_equal_eager_steps(cuda, kind):
    """Over a recorded sequence of real steps (rows joining and leaving),
    each replayed step equals the eager step on cloned pools bit for
    bit: tokens, pools (page 0 slot 0 left out) and scale planes; every
    step is one replay, and the kernels' counters hold the launches the
    replays made."""
    eng, adapters = _graph_engine(kind)
    bound = eng._bound_step
    assert bound.graph is not None and bound.captures == 1
    rng = np.random.RandomState(4)
    K.reset_launch_counts()
    with _recorded(bound) as recorded:
        streams = [eng.submit(rng.randint(1, GRAPH_CFG.vocab_size, n),
                              max_new_tokens=m,
                              adapter=None if adapters is None
                              else adapters[i])
                   for i, (n, m) in enumerate(GRAPH_REQUESTS)]
        assert [len(s.result(timeout=300)) for s in streams] == \
            [m for _, m in GRAPH_REQUESTS]
        counts = K.launch_counts()
        st = eng.stats()
        eng.close()
    steps = st["decode_steps_total"]
    assert st["graph_replays"] == st["bound_step_runs"] == steps \
        == len(recorded)
    L = GRAPH_CFG.num_layers
    # the graph's kernel nodes, counted by name at capture, a replay
    if kind == "two_lane":
        per_step = {"paged_attention": L, "layer_norm": 2 * L + 1}
    elif kind == "float32":
        per_step = {"ragged_paged_attention": L, "layer_norm": 2 * L + 1}
    else:
        per_step = {"quantized_matmul": 4 * L + 1, "layer_norm": 2 * L + 1,
                    "ragged_paged_attention_q": L,
                    "batched_lora_add_": 4 * L + 1}
    assert st["graph_launches"] == per_step
    want = {k: n * steps for k, n in per_step.items()}
    if kind == "two_lane":     # the eager prefill calls' layer norms
        want["layer_norm"] += (2 * L + 1) * st["prefill_batches_total"]
    assert {k: n for k, n in counts.items() if n} == want
    _replays_equal_eager_steps(bound, recorded)


@contextlib.contextmanager
def _recorded(bound):
    """The host feeds of every step the bound step runs meanwhile."""
    recorded = []
    run = bound.run

    def recording(**host):
        recorded.append({n: np.array(a, copy=True) for n, a in host.items()})
        return run(**host)

    bound.run = recording
    try:
        yield recorded
    finally:
        bound.run = run


def _replays_equal_eager_steps(bound, recorded):
    """Rows joined and left; then every recorded step, run again as the
    graph's replay on the engine's pools and as the eager step on cloned
    pools, gives the same tokens, pools (page 0 slot 0 left out) and
    scale planes bit for bit."""
    live = [int((h["num_valid"] > 0).sum()) for h in recorded]
    assert any(b < a for a, b in zip(live, live[1:])), live
    for i, host in enumerate(recorded):
        clone = {k: None if v is None else [t.clone() for t in v]
                 for k, v in bound.state.items()}
        got = bound.run(**host)
        want = bound.eager(state=clone, **host).cpu().numpy()
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got, want, err_msg=f"step {i}")
        for k, tensors in bound.state.items():
            for layer, (a, b) in enumerate(zip(tensors or (), clone[k] or ())):
                assert _same_except_junk(a, b), (i, k, layer)


def test_graphed_spec_steps_replay_equal_eager_steps(cuda):
    """Speculative decoding with a full-replica draft over pages of 4:
    verify rows [pending] + 3 drafts start mid-page and cross into the
    next page, rows join and leave, and each replayed step equals its
    eager step bit for bit; the draft runs on the card, outside the
    graph, and its drafts are accepted."""
    from paddle_tpu_torch.generation import HostDraft

    pred = create_predictor(
        Config().set_params(GRAPH_CFG, _tiny_params(GRAPH_CFG)), "cuda")
    draft = HostDraft.from_predictor(pred, GRAPH_CFG)
    assert draft.device.type == "cuda"
    eng = GenerationEngine(pred, GRAPH_CFG, page_size=4, num_pages=96,
                           max_decode_batch=4, chunk_tokens=8, draft=draft,
                           spec_tokens=3)
    bound = eng._bound_step
    rng = np.random.RandomState(6)
    with _recorded(bound) as recorded:
        streams = [eng.submit(rng.randint(1, GRAPH_CFG.vocab_size, n),
                              max_new_tokens=m)
                   for n, m in GRAPH_REQUESTS]
        assert [len(s.result(timeout=300)) for s in streams] == \
            [m for _, m in GRAPH_REQUESTS]
        st = eng.stats()
        eng.close()
    assert st["graph_replays"] == st["bound_step_runs"] == len(recorded)
    assert st["spec_accepted_total"] > 0
    assert st["spec_acceptance_rate"] > 0.5
    eng.cache.check_integrity()
    # prefill chunks of 8 start on page boundaries: a wider row that
    # starts mid-page is a verify row
    crossing = sum(1 for h in recorded
                   for nv, start in zip(h["num_valid"], h["positions"])
                   if nv > 1 and start % 4 and start % 4 + nv > 4)
    assert crossing, "no verify row started mid-page across a page boundary"
    _replays_equal_eager_steps(bound, recorded)


def test_engine_refuses_a_draft_off_its_device(cuda):
    """A draft built from arrays with no device lands on the card; one
    built on the CPU is refused by an engine on the card, whose step it
    would otherwise feed from the host."""
    from paddle_tpu_torch.generation import HostDraft

    pred = create_predictor(
        Config().set_params(GRAPH_CFG, _tiny_params(GRAPH_CFG)), "cuda")
    arrays = {k: v.detach().cpu().numpy()
              for k, v in pred.lm.jax_params().items()}
    args = (arrays, GRAPH_CFG.num_layers, GRAPH_CFG.num_heads,
            GRAPH_CFG.max_position)
    assert HostDraft(*args).device == pred.lm.device
    with pytest.raises(ValueError, match="the draft is on cpu"):
        GenerationEngine(pred, GRAPH_CFG, draft=HostDraft(*args, device="cpu"),
                         spec_tokens=3, start=False)


def test_graphed_radix_steps_replay_equal_eager_steps(cuda):
    """The radix cache on the card: requests over a shared 16-token
    prefix attach its pages (rows attend over pages other rows and the
    trie hold), each replayed step equals its eager step bit for bit,
    and after the drain the audit holds and the pool empties."""
    pred = create_predictor(
        Config().set_params(GRAPH_CFG, _tiny_params(GRAPH_CFG)), "cuda")
    eng = GenerationEngine(pred, GRAPH_CFG, page_size=4, num_pages=96,
                           max_decode_batch=4, chunk_tokens=6,
                           prefix_cache=True)
    bound = eng._bound_step
    rng = np.random.RandomState(8)
    pre = rng.randint(1, GRAPH_CFG.vocab_size, 16)
    prompts = [np.concatenate([pre, rng.randint(1, GRAPH_CFG.vocab_size, n)])
               for n, _ in GRAPH_REQUESTS]
    with _recorded(bound) as recorded:
        first = eng.generate(prompts[0], max_new_tokens=GRAPH_REQUESTS[0][1])
        streams = [eng.submit(p, max_new_tokens=m)
                   for p, (_, m) in zip(prompts[1:], GRAPH_REQUESTS[1:])]
        got = [first] + [s.result(timeout=300) for s in streams]
        st = eng.stats()
        eng.close()
    assert [len(t) for t in got] == [m for _, m in GRAPH_REQUESTS]
    assert st["radix"]["prefix_hits_total"] >= len(GRAPH_REQUESTS) - 1
    assert st["graph_replays"] == len(recorded)
    eng.cache.check_integrity()
    eng.cache.drop_trie()
    eng.cache.check_integrity()
    assert eng.stats()["cache"]["pages_in_use"] == 0
    _replays_equal_eager_steps(bound, recorded)


def test_graph_capture_failure_raises(cuda, monkeypatch):
    """A step that reads a device value on the host cannot be captured:
    the capture raises (no eager fallback), and so does the engine's
    constructor; the card works on afterwards."""
    from paddle_tpu_torch.generation.model import RaggedStepModel
    from paddle_tpu_torch.runtime.graphs import GraphedStep

    def host_read(x):
        return x * float(x.sum())

    step = GraphedStep(host_read, {"x": ((4,), torch.float32)}, {}, cuda,
                       "host-read")
    with pytest.raises(RuntimeError, match="capture of the host-read step"):
        step.capture()
    assert step.graph is None
    real = RaggedStepModel.forward

    def forward(self, tokens, *args, **kw):
        int(tokens.sum())
        return real(self, tokens, *args, **kw)

    monkeypatch.setattr(RaggedStepModel, "forward", forward)
    pred = create_predictor(
        Config().set_params(GRAPH_CFG, _tiny_params(GRAPH_CFG)), "cuda")
    with pytest.raises(RuntimeError, match="capture of the ragged step"):
        GenerationEngine(pred, GRAPH_CFG, page_size=4, num_pages=24,
                         max_decode_batch=2, chunk_tokens=6)
    x = torch.arange(4.0, device=cuda)
    assert float((x * 2).sum()) == 12.0


# -- the Program predictor, serving and the hot swap on the card ---------------


def _save_tiny_lm(tmp_path, seq=24):
    """A tiny build_lm_program GPT, initialized on the CPU by the port's
    startup program and saved with save_inference_model."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.generation import build_lm_program

    main, startup, _f, fetches = build_lm_program(GRAPH_CFG, seq)
    main.random_seed = startup.random_seed = 3
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        fluid.io.save_inference_model(str(tmp_path), ["tokens"],
                                      [fetches["logits"]], exe, main)
    return str(tmp_path)


@pytest.mark.parametrize("mode", ["off", "int8"])
def test_program_predictor_on_cuda_matches_cpu(cuda, tmp_path, mode):
    """The LM Program runs K1 (and, quantized at load, K11) with exact
    launches a run, and its logits equal the CPU's within the float32
    tolerance and the module's over the same tensors."""
    d = _save_tiny_lm(tmp_path)
    preds = {}
    for dev in ("cpu", "cuda"):
        c = Config(d)
        if mode != "off":
            c.enable_weight_quantization(mode)
        preds[dev] = create_predictor(c, dev)
    tokens = np.random.RandomState(5).randint(0, 97, (3, 24))
    (want,) = preds["cpu"].run([tokens])
    before = K.launch_counts()
    (got,) = preds["cuda"].run([tokens])
    torch.cuda.synchronize()
    after = K.launch_counts()
    L = GRAPH_CFG.num_layers
    assert after["layer_norm"] - before["layer_norm"] == 2 * L + 1
    assert (after["quantized_matmul"] - before["quantized_matmul"]
            == (4 * L + 1 if mode != "off" else 0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    lm = preds["cuda"].lm(torch.as_tensor(tokens)).cpu().numpy()
    np.testing.assert_allclose(got, lm, rtol=1e-4, atol=1e-4)


def test_meta_shape_route_never_takes_a_cuda_tensor(cuda):
    """Inside shape evaluation a meta tensor takes the plain version; a
    CUDA tensor still launches the kernel."""
    from paddle_tpu_torch.kernels import _build

    # no draw from the card's generator: a failed capture earlier in
    # the file (test_graph_capture_failure_raises) leaves it unusable
    x = torch.linspace(-2.0, 3.0, 256, device=cuda).reshape(4, 64)
    g, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    before = K.layer_norm.launches
    with _build.evaluating_shapes():
        assert not _build.takes_plain(x)
        y = K.layer_norm(x, g, b)
        m = K.layer_norm(x.to("meta"), g.to("meta"), b.to("meta"))
    torch.cuda.synchronize()
    assert K.layer_norm.launches == before + 1
    assert y.is_cuda and m.device.type == "meta"
    torch.testing.assert_close(y, K.layer_norm_plain(x, g, b), **TOL[
        torch.float32])


def test_graph_capture_beside_a_serving_worker(cuda, tmp_path):
    """A GenerationEngine captures its step's CUDA graph while a
    ServingEngine's workers run Program requests on the card (another
    thread allocating and synchronizing): the capture holds, and the
    engine's tokens equal an engine captured alone."""
    import threading

    from paddle_tpu_torch.serving import ServingEngine

    d = _save_tiny_lm(tmp_path)
    pred = create_predictor(Config(d), "cuda")
    serve = ServingEngine(pred, max_batch_size=4, num_workers=2)
    stop, errors, done = threading.Event(), [], []
    tokens = np.random.RandomState(1).randint(0, 97, (2, 24))

    def pump():
        while not stop.is_set():
            try:
                serve.predict({"tokens": tokens}, timeout=60)
                done.append(1)
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    try:
        while not done:
            th.join(0.01)
        eng = GenerationEngine(pred, pred.gpt_config, page_size=4,
                               num_pages=64, max_decode_batch=4, warmup=True)
        got = eng.generate([5, 9, 2, 40], max_new_tokens=8, timeout=120)
        assert eng.stats()["graph_captures"] == 1
        eng.close()
    finally:
        stop.set()
        th.join(60)
        serve.close()
    assert not errors, errors
    with GenerationEngine(pred, pred.gpt_config, page_size=4, num_pages=64,
                          max_decode_batch=4, warmup=True) as alone:
        assert alone.generate([5, 9, 2, 40], max_new_tokens=8,
                              timeout=120) == got


@pytest.mark.parametrize("mode", ["off", "int8"])
def test_swap_base_under_graph_equals_a_fresh_engine(cuda, mode):
    """swap_base copies into the tensors the captured graph replays: no
    recapture, and the tokens after it equal an engine built on the new
    weights (quantized the same way)."""
    from paddle_tpu_torch.kernels.quant_matmul import quantize_weight

    params = _tiny_params(GRAPH_CFG)
    rng = np.random.RandomState(11)
    names = [f"dec{i}_qkv.w" for i in range(GRAPH_CFG.num_layers)]
    new = {n: params[n] + 0.5 * rng.randn(*params[n].shape).astype(
               np.float32) for n in names + ["gpt_head.w"]}
    kw = dict(page_size=4, num_pages=64, max_decode_batch=4, warmup=True,
              quantize_weights=mode)
    prompt = [7, 3, 30, 2, 9]
    pred = create_predictor(Config().set_params(GRAPH_CFG, params), "cuda")
    with GenerationEngine(pred, GRAPH_CFG, **kw) as eng:
        bound = eng._ragged_bound
        before = eng.generate(prompt, max_new_tokens=10, timeout=120)
        assert eng.swap_base(new) == "swap-1"
        after = eng.generate(prompt, max_new_tokens=10, timeout=120)
        assert eng._ragged_bound is bound
        assert eng.stats()["graph_captures"] == 1
    fresh = create_predictor(Config().set_params(GRAPH_CFG, dict(params,
                                                                 **new)),
                             "cuda")
    with GenerationEngine(fresh, GRAPH_CFG, **kw) as feng:
        assert feng.generate(prompt, max_new_tokens=10, timeout=120) == after
    if mode != "off":
        q, s = quantize_weight(torch.as_tensor(new["dec0_qkv.w"]).cuda(),
                               mode)
        assert torch.equal(pred.lm.layers[0].qkv.qweight, q)
    assert after != before


# -- checkpoints and supervised training (A13b, resilience/) -------------------


def test_lookup_table_grad_repeats_its_bits_on_the_card(cuda):
    """BERT-large's word-embedding gradient shape with heavily repeated
    ids (8 x 512 ids over 64 rows, padding id 0): two calls give the
    same bits (``index_add_``'s float atomics would not), and the
    result equals the CPU's segment sum within float32 summation noise."""
    from paddle_tpu_torch.core.registry import get_op_def

    class _Op:
        attrs = {"padding_idx": 0}

    g = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn(30522, 1024, device=cuda, generator=g)
    ids = torch.randint(0, 64, (8, 512, 1), device=cuda, generator=g)
    og = torch.randn(8, 512, 1024, device=cuda, generator=g)
    lower = get_op_def("lookup_table_grad").lower
    ins = {"W": [w], "Ids": [ids], "Out@GRAD": [og]}
    a = lower(None, _Op(), ins)["W@GRAD"][0]
    b = lower(None, _Op(), ins)["W@GRAD"][0]
    assert torch.equal(a, b)
    cpu = lower(None, _Op(), {k: [v[0].cpu()] for k, v in ins.items()})
    torch.testing.assert_close(a.cpu(), cpu["W@GRAD"][0], atol=1e-4,
                               rtol=1e-5)
    assert not a[0].any() and not a[64:].any()


def test_supervised_resume_on_cuda_is_bitwise(cuda, tmp_path):
    """A dropout MLP under Lamb and a warmup-then-decay lr on the card:
    a Supervisor running every step on its watchdog's worker thread
    commits at step 4 and runs to 8; a fresh Executor and scope (startup
    under another seed) resume from 4 on the caller's thread. Losses,
    lr and every persistable equal the uninterrupted run bit for bit:
    the worker launches on the caller's device and stream, and the run
    counter, the schedule's counter and Lamb's state round-trip."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io, resilience

    def build():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 3
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", [64])
            y = fluid.layers.data("y", [1], dtype="int64")
            h = fluid.layers.dropout(fluid.layers.fc(x, 256, act="relu"),
                                     0.1)
            loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
                fluid.layers.fc(h, 8), y))
            lr = fluid.layers.linear_lr_warmup(fluid.layers.polynomial_decay(
                1e-2, 8, end_learning_rate=0.0), 2, 0.0, 1e-2)
            fluid.optimizer.LambOptimizer(lr).minimize(loss)
        return main, startup, loss, lr

    def feed(step):
        r = np.random.RandomState(step)
        return {"x": r.randn(32, 64).astype("float32"),
                "y": r.randint(0, 8, (32, 1)).astype("int64")}

    def run(ck, resume, watchdog, seed):
        main, startup, loss, lr = build()
        startup.random_seed = seed
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        out = {}
        sup = resilience.Supervisor(
            exe, main, str(ck), feed_fn=feed, fetch_list=[loss, lr],
            scope=scope, watchdog_timeout_s=watchdog,
            policy=resilience.CheckpointPolicy(str(ck), every_steps=4,
                                               keep_last=2),
            on_step=lambda s, f: out.__setitem__(
                s, (f[0].tobytes(), f[1].tobytes())))
        stats = sup.run_loop(8, resume=resume)
        state = {v.name: scope.find_var(v.name).cpu()
                 for v in main.list_vars() if v.persistable and not v.is_data}
        return out, stats, state

    import shutil

    ck = tmp_path / "ck"
    ref, _, ref_state = run(ck, False, 60.0, 3)
    assert io.committed_checkpoint_steps(str(ck)) == [4, 8]
    shutil.rmtree(ck / "8")
    got, stats, state = run(ck, True, 0.0, 77)
    assert stats["resumed_from"] == 4
    assert sorted(got) == [4, 5, 6, 7]
    assert got == {s: ref[s] for s in range(4, 8)}
    assert sorted(state) == sorted(ref_state)
    for n in ref_state:
        assert torch.equal(state[n], ref_state[n]), n
    assert float(ref_state["@LR_DECAY_COUNTER@"][0]) == 8.0


# -- SelectedRows, switch-MoE and control flow on the card ----------------------


def test_selected_rows_merge_bits_repeat_on_the_card(cuda):
    """Duplicate rows summed in order: two merges (and two to_dense)
    give the same bits, equal to the CPU's."""
    from paddle_tpu_torch.core.selected_rows import SelectedRows

    g = torch.Generator(device=cuda).manual_seed(3)
    rows = torch.randint(0, 50, (40960,), device=cuda, generator=g)
    vals = torch.randn(40960, 16, device=cuda, generator=g)
    sr = SelectedRows(rows, vals, 50)
    a, b = sr.merge(), sr.merge()
    assert torch.equal(a.rows, b.rows) and torch.equal(a.values, b.values)
    assert torch.equal(sr.to_dense(), sr.to_dense())
    cpu = SelectedRows(rows.cpu(), vals.cpu(), 50).merge()
    assert torch.equal(a.rows.cpu(), cpu.rows)
    torch.testing.assert_close(a.values.cpu(), cpu.values, atol=1e-4,
                               rtol=1e-5)


def test_sparse_updates_with_every_row_of_the_table(cuda):
    """The rows JAX pads its merge with (index ``height``) never reach the
    card: a batch touching the last row and one touching every row
    update in range, untouched rows keep their bits."""
    from paddle_tpu_torch.core.registry import get_op_def
    from paddle_tpu_torch.core.selected_rows import SelectedRows

    class _Op:
        attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}

    H, D = 64, 8
    for rows in (torch.tensor([H - 1, H - 1, 0]), torch.arange(H).repeat(2)):
        rows = rows.to(cuda)
        vals = torch.ones(rows.numel(), D, device=cuda)
        p = torch.zeros(H, D, device=cuda)
        ins = {"Param": [p], "Grad": [SelectedRows(rows, vals, H)],
               "LearningRate": [torch.full((1,), 0.1, device=cuda)],
               "Moment1": [torch.zeros(H, D, device=cuda)],
               "Moment2": [torch.zeros(H, D, device=cuda)],
               "Beta1Pow": [torch.full((1,), 0.9, device=cuda)],
               "Beta2Pow": [torch.full((1,), 0.999, device=cuda)]}
        out = get_op_def("adam").lower(None, _Op(), ins)
        torch.cuda.synchronize()
        touched = torch.zeros(H, dtype=torch.bool, device=cuda)
        touched[rows] = True
        assert (out["ParamOut"][0][touched] != 0).all()
        assert (out["ParamOut"][0][~touched] == 0).all()


def test_switch_moe_on_cuda_matches_cpu(cuda):
    """The op and its six gradients on the card against the CPU, tokens
    dropped (capacity 0.5); routing identical; two card runs equal bit
    for bit."""
    from paddle_tpu_torch.ops.moe import moe_capacity, route, switch_moe

    g = torch.Generator().manual_seed(4)
    T, D, E, F = 512, 64, 8, 128
    args = [torch.randn(T, D, generator=g), torch.randn(D, E, generator=g),
            0.1 * torch.randn(E, D, F, generator=g),
            0.1 * torch.randn(E, F, generator=g),
            0.1 * torch.randn(E, F, D, generator=g),
            0.1 * torch.randn(E, D, generator=g)]
    w = torch.randn(T, D, generator=g)
    cap = moe_capacity(T, 0.5, E)

    def run(dev):
        leaves = [a.to(dev).requires_grad_(True) for a in args]
        out, aux = switch_moe(*leaves, cap)
        loss = (out * w.to(dev)).sum() + aux
        grads = torch.autograd.grad(loss, leaves)
        probs = torch.softmax(leaves[0] @ leaves[1], -1).detach()
        return out.detach(), aux.detach(), grads, route(probs, cap)[0]

    c_out, c_aux, c_g, c_e = run("cpu")
    a_out, a_aux, a_g, a_e = run(cuda)
    b_out, _, b_g, _ = run(cuda)
    assert torch.equal(a_e.cpu(), c_e)
    assert torch.equal(a_out, b_out)
    assert all(torch.equal(x, y) for x, y in zip(a_g, b_g))
    torch.testing.assert_close(a_out.cpu(), c_out, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(a_aux.cpu(), c_aux, atol=1e-5, rtol=1e-5)
    for x, y in zip(a_g, c_g):
        torch.testing.assert_close(x.cpu(), y, atol=1e-3, rtol=1e-3)


# -- the fake-quantize family, clip-built activations and scatter -------------


def _lower_op(op_type, inputs, attrs, device, grads=(), seed=0):
    """One lowering on ``device`` under autograd: its outputs and, for
    the ``grads`` slots, the gradients of every float output summed
    against seeded weights."""
    from paddle_tpu_torch.core.registry import LoweringContext, get_op_def

    class Op:
        pass

    Op.attrs = dict(attrs, op_ident=1)
    ins, leaves = {}, []
    for slot, vals in inputs.items():
        ins[slot] = []
        for a in (vals if isinstance(vals, list) else [vals]):
            t = torch.as_tensor(np.asarray(a)).to(device)
            if slot in grads:
                t.requires_grad_(True)
                leaves.append(t)
            ins[slot].append(t)
    Op.inputs = {s: [f"{s}{k}" for k in range(len(v))] for s, v in ins.items()}
    with torch.enable_grad():
        outs = get_op_def(op_type).lower(LoweringContext(device), Op, ins)
        Op.outputs = {s: [s] for s in outs}
        flat = [o for s in sorted(outs) for o in outs[s]]
        res = [o.detach().cpu() for o in flat]
        if leaves:
            g = torch.Generator().manual_seed(seed)
            terms = [(o * torch.randn(o.shape, generator=g).to(device)).sum()
                     for o in flat if o.is_floating_point() and o.requires_grad]
            res += [x.cpu() for x in torch.autograd.grad(sum(terms), leaves)]
    return res


def _same_on_both(op_type, inputs, attrs, grads=(), exact=False):
    cpu = _lower_op(op_type, inputs, attrs, "cpu", grads)
    card = _lower_op(op_type, inputs, attrs, "cuda", grads)
    assert len(cpu) == len(card)
    for a, b in zip(card, cpu):
        if exact or not b.is_floating_point():
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


_X = np.random.RandomState(0).randn(6, 5).astype(np.float32)
_P = np.array([0.9], np.float32)

FAKE_QUANT = {
    "fake_quantize_abs_max": ({"X": _X}, {"bit_length": 8}),
    "fake_quantize_dequantize_moving_average_abs_max": (
        {"X": _X, "InScale": _P, "InAccum": _P * 2, "InState": _P + 1},
        {"moving_rate": 0.9}),
    "fake_quantize_moving_average_abs_max": (
        {"X": _X, "InScale": _P}, {"is_test": True}),
    "fake_channel_wise_quantize_abs_max": ({"X": _X.reshape(6, 5, 1)}, {}),
    "fake_dequantize_max_abs": ({"X": _X, "Scale": _P}, {}),
    "fake_quantize_range_abs_max": (
        {"X": _X, "InScale": _P, "Iter": np.array([3.0], np.float32),
         "InScales": np.array([0.5, 4.0, 0.2], np.float32)}, {}),
    "moving_average_abs_max_scale": ({"X": _X, "InAccum": _P,
                                      "InState": _P}, {}),
    "fake_channel_wise_dequantize_max_abs": (
        {"X": _X, "Scales": [np.abs(_X[:, 0]) + 0.1, _P]},
        {"quant_bits": [8, 4]}),
    "dequantize_abs_max": ({"X": (_X * 40).astype(np.int8), "Scale": _P},
                           {}),
    "quantize": ({"Input": _X * 20}, {"Scale": 3.0, "Shift": 128.0}),
    "dequantize": ({"Input": (np.abs(_X) * 40).astype(np.uint8)},
                   {"Scale": 3.0, "Shift": 1.0}),
    "requantize": ({"Input": (_X * 40).astype(np.int8)},
                   {"Scale_in": 3.0, "Scale_out": 2.0}),
    "lookup_table_dequant": ({"W": np.abs(_X), "Ids": np.array([5, 0, 5])},
                             {}),
}


@pytest.mark.parametrize("op", sorted(FAKE_QUANT))
def test_fake_quant_op_on_cuda_matches_cpu(cuda, op):
    inputs, attrs = FAKE_QUANT[op]
    grads = ("X",) if "X" in inputs and inputs["X"].dtype == np.float32 \
        and op not in ("lookup_table_dequant",) else ()
    _same_on_both(op, inputs, attrs, grads)


def test_fake_quant_rounds_half_to_even_on_cuda(cuda):
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 100.5]],
                 np.float32)
    _same_on_both("fake_quantize_abs_max", {"X": x}, {}, ("X",), exact=True)
    _same_on_both("fake_quantize_abs_max", {"X": np.zeros((2, 3), np.float32)},
                  {}, ("X",), exact=True)


@pytest.mark.parametrize("op,x,attrs", [
    ("relu6", [-1.0, 0.0, 3.0, 6.0, 7.0], {}),
    ("hard_swish", [-4.0, -3.0, 0.0, 3.0, 4.0], {}),
    ("hard_sigmoid", [-3.0, -2.0, 0.0, 2.0, 3.0], {"slope": 0.25,
                                                   "offset": 0.5}),
])
def test_clip_built_activations_at_bounds_on_cuda(cuda, op, x, attrs):
    """The 0.5 gradient at each bound (``_bounded``) on the card, bit for
    bit as on the CPU."""
    _same_on_both(op, {"X": np.array([x], np.float32)}, attrs, ("X",),
                  exact=True)


def test_scatter_with_repeated_ids_on_cuda_takes_the_last_update(cuda):
    """A repeated id under ``overwrite`` takes its last update on the
    card as on the CPU (rows reduced to one write each: no race), with
    no gradient to the overwritten updates."""
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 50, 4000).astype(np.int64)
    x = rng.randn(50, 8).astype(np.float32)
    upd = rng.randn(4000, 8).astype(np.float32)
    inputs = {"X": x, "Ids": ids, "Updates": upd}
    _same_on_both("scatter", inputs, {"overwrite": True}, ("X", "Updates"),
                  exact=True)
    out = _lower_op("scatter", inputs, {"overwrite": True}, "cuda")[0]
    last = {int(i): k for k, i in enumerate(ids)}
    for i, k in last.items():
        np.testing.assert_array_equal(out[i].numpy(), upd[k])


# -- the disaggregated splice on the card (A9a) ----------------------------------


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_ingest_under_a_captured_graph_serves_the_spliced_pages(cuda,
                                                                kv_dtype):
    """A decode engine whose step is a captured CUDA graph ingests a run
    from a page store in place (``index_copy_`` into the same pool
    tensors): the graph is not recaptured, the spliced pages are the
    store's bit for bit, and the tokens equal the engine that prefilled
    the prompt itself."""
    from paddle_tpu_torch.disagg import HostPageStore, run_for_pool

    params = _tiny_params(GRAPH_CFG)
    kw = dict(page_size=4, num_pages=64, max_decode_batch=4, warmup=True,
              kv_dtype=kv_dtype, prefix_cache=True)
    prompt = np.arange(3, 26, dtype=np.int64)          # 5 full pages + 3
    store = HostPageStore(page_size=4)
    pred = create_predictor(Config().set_params(GRAPH_CFG, params), "cuda")
    with GenerationEngine(pred, GRAPH_CFG, page_store=store, **kw) as a:
        want = a.generate(prompt, max_new_tokens=8, timeout=120)
        assert a.spill_run(prompt) == 5
        a.cache.drop_trie()
    with GenerationEngine(pred, GRAPH_CFG, page_store=store, **kw) as b:
        bound = b._ragged_bound
        ptrs = [t.data_ptr() for t in b.cache.k_pages]
        got = b.generate(prompt, max_new_tokens=8, timeout=120)
        st = b.stats()
        assert st["store"]["pages_pulled_total"] == 5
        assert b._ragged_bound is bound and st["graph_captures"] == 1
        assert [t.data_ptr() for t in b.cache.k_pages] == ptrs
        n, k_run, v_run, ks, vs = b.cache.export_run(prompt, max_pages=5)
        ref = run_for_pool(store.match(prompt), kv_dtype)
        assert n == 5
        assert np.array_equal(k_run, ref[1]) and np.array_equal(v_run, ref[2])
        if kv_dtype == "int8":
            assert np.array_equal(ks, ref[3]) and np.array_equal(vs, ref[4])
        b.cache.drop_trie()
    assert got == want


def test_export_from_another_thread_sees_the_step_s_writes(cuda):
    """``spill_run`` from a thread other than the loop's (the prefill
    worker's dispatcher) reads pages after the step that wrote them: its
    reads wait on the event the loop records after each step. Held to
    a direct read of the pool after a full device synchronize."""
    import threading

    params = _tiny_params(GRAPH_CFG)
    pred = create_predictor(Config().set_params(GRAPH_CFG, params), "cuda")
    prompt = np.arange(5, 37, dtype=np.int64)           # 8 full pages
    with GenerationEngine(pred, GRAPH_CFG, page_size=4, num_pages=64,
                          max_decode_batch=4, warmup=True,
                          prefix_cache=True) as eng:
        # the engine's stream ends in max_new 1: the prompt's pages are
        # published by the step that samples the first token
        eng.generate(prompt, max_new_tokens=1, timeout=120)
        assert eng.cache._written is not None
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "run", eng.cache.export_run(prompt)))
        t.start()
        t.join(60)
        torch.cuda.synchronize()
        n, k_run, v_run, _, _ = out["run"]
        assert n == 8
        node, pids = eng.cache._root, []
        for i in range(8):
            node = node.children[eng.cache._page_key(prompt, i)]
            pids.append(node.page)
        sel = torch.tensor(pids, device=cuda)
        for li, buf in enumerate(eng.cache.k_pages):
            direct = buf.index_select(1, sel).movedim(1, 0).cpu().numpy()
            assert np.array_equal(k_run[:, li], direct)
        eng.cache.drop_trie()


# -- the data tiers: device prefetch, the overlapped step, the native parser --


def _loader_mlp(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [256])
        y = fluid.layers.data("y", [1], dtype="int64")
        h = fluid.layers.fc(x, 512, act="relu")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(h, 10), y))
        fluid.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss, x, y


def _loader_feeds(n, rows=64):
    for i in range(n):
        rng = np.random.RandomState(300 + i)
        yield {"x": rng.rand(rows, 256),           # float64: cast on the host
               "y": rng.randint(0, 10, (rows, 1)).astype("int64")}


def test_prefetched_batch_is_on_the_card_and_equals_its_host_batch(cuda):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.reader import GeneratorLoader

    _, _, _, x, y = _loader_mlp(fluid)
    feeds = list(_loader_feeds(5))
    loader = GeneratorLoader([x, y], prefetch_depth=2)
    loader.set_batch_generator(lambda: iter(feeds),
                               places=[fluid.CUDAPlace(0)])
    got = list(loader)
    assert len(got) == 5
    for b, f in zip(got, feeds):
        assert b["x"].is_cuda and b["x"].dtype == torch.float32
        assert b["y"].is_cuda and b["y"].dtype == torch.int64
        assert torch.equal(b["x"].cpu(), torch.from_numpy(f["x"]).float())
        assert torch.equal(b["y"].cpu(), torch.from_numpy(f["y"]))


def test_dropped_batches_while_copies_run_stay_uncorrupted(cuda):
    """A consumer that keeps a few batches, drops the others at once and
    queues slow work on its stream while the next copies run: every kept
    batch still holds its own values (record_stream keeps a block from
    the next copy until the consumer's stream is done with it)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.reader import GeneratorLoader

    n = 24

    def gen():
        for i in range(n):
            yield {"x": np.full((1024, 1024), float(i), "float32")}

    loader = GeneratorLoader([], prefetch_depth=3)
    loader.set_batch_generator(gen, places=[fluid.CUDAPlace(0)])
    kept, sums = [], []
    for i, b in enumerate(loader):
        torch.cuda._sleep(2_000_000)           # the step still running
        s = b["x"].sum()                        # queued behind the sleep
        sums.append(s)
        if i % 4 == 0:
            kept.append((i, b["x"]))
        del b                                   # dropped while queued
    torch.cuda.synchronize()
    for i, s in enumerate(sums):
        assert float(s) == float(i) * 1024 * 1024, i
    for i, t in kept:
        assert bool((t == float(i)).all()), i


def test_pipelined_equals_run_bitwise_on_the_card(cuda):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.reader import GeneratorLoader

    losses, params = [], []
    for mode in ("run", "pipelined", "loader"):
        main, startup, loss, x, y = _loader_mlp(fluid)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        feeds = _loader_feeds(8)
        if mode == "run":
            out = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
                   for f in feeds]
        elif mode == "pipelined":
            out = [o[0] for o in exe.run_pipelined(main, feeds, [loss],
                                                   scope=scope)]
        else:
            loader = GeneratorLoader([x, y], prefetch_depth=2)
            loader.set_batch_generator(lambda f=list(feeds): iter(f),
                                       places=[fluid.CUDAPlace(0)])
            out = [o[0] for o in exe.run_pipelined(main, loader, [loss],
                                                   scope=scope)]
        losses.append([o.tobytes() for o in out])
        params.append({p.name: scope.find_var(p.name).cpu()
                       for p in main.all_parameters()})
    assert losses[0] == losses[1] == losses[2]
    for name, t in params[0].items():
        assert torch.equal(t, params[1][name]) and torch.equal(
            t, params[2][name]), name


def test_closed_pipeline_leaves_no_device_batch(cuda):
    import paddle_tpu_torch as fluid

    main, startup, loss, _, _ = _loader_mlp(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    list(exe.run_pipelined(main, _loader_feeds(2), [loss], scope=scope))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()

    def endless():
        while True:
            yield from _loader_feeds(1, rows=4096)

    gen = exe.run_pipelined(main, endless(), [loss], scope=scope, depth=3)
    for n, _ in enumerate(gen):
        if n == 3:
            break
    gen.close()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= base + (1 << 20)


def test_native_parser_builds_on_the_card_machine(cuda, tmp_path):
    from paddle_tpu_torch.native import datafeed

    assert datafeed.available()
    p = tmp_path / "d.txt"
    p.write_text("2 1.5 2.5 1 7\n2 3.0 4.0 1 9\n")
    rows = list(datafeed.parse_file(str(p), 2, ["float32", "int64"]))
    assert [list(r[0]) for r in rows] == [[1.5, 2.5], [3.0, 4.0]]
    assert [int(r[1][0]) for r in rows] == [7, 9]


# -- distribution: worlds on the card -------------------------------------------

_DIST_WORKER = '''
import json, os, sys
import numpy as np
import torch
import paddle_tpu_torch as fluid
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.kernels.quant import quantized_mean
from paddle_tpu_torch.parallel import comm
from paddle_tpu_torch.parallel.env import init_parallel_env
from paddle_tpu_torch.parallel.mesh import world_group

env = init_parallel_env()
r, n = env.rank, env.world_size
g = world_group()
dev = torch.device("cuda", 0)
out = {"backend": torch.distributed.get_backend(), "world": n}


def mlp():
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [64])
        y = fluid.layers.data("y", [1], dtype="int64")
        h = fluid.layers.fc(x, 128, act="relu")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(h, 8), y))
        fluid.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss


def train(compiled, planned):
    fluid.set_flags({"collective_bucket_mb": "0.01" if planned else "0"})
    try:
        main, startup, loss = mlp()
    finally:
        fluid.set_flags({"collective_bucket_mb": "0"})
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    prog = (fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name) if compiled else main)
    rng = np.random.RandomState(0)
    ls = []
    for _ in range(3):
        x = rng.randn(32, 64).astype("float32")
        y = rng.randint(0, 8, (32, 1)).astype("int64")
        k = 32 // n
        feed = {"x": x[r * k:(r + 1) * k], "y": y[r * k:(r + 1) * k]}
        ls.append(float(np.asarray(exe.run(
            prog, feed=feed, fetch_list=[loss], scope=scope)[0]).reshape(-1)[0]))
    return ls, {p.name: scope.find_var(p.name).cpu().numpy().tolist()
                for p in main.all_parameters()}


if n == 1:
    t = torch.randn(1000, device=dev)
    c = t.clone()
    comm.all_reduce(c, group=g)
    out["all_reduce_same_bits"] = bool(torch.equal(c, t))
    out["plain"] = train(False, False)
    out["bucketed"] = train(True, True)
else:
    rng = np.random.RandomState(100 + r)
    xs = [np.random.RandomState(100 + k).randn(8, 6).astype("float32")
          for k in range(n)]
    x = torch.from_numpy(xs[r]).to(dev)
    checks = {}
    for op, fn in (("sum", np.sum), ("max", np.max), ("min", np.min)):
        y = x.clone()
        comm.all_reduce(y, op=op, group=g)
        checks[f"all_reduce_{op}"] = bool(np.array_equal(
            y.cpu().numpy(), fn(np.stack(xs), axis=0)))
    y = comm.broadcast(x.clone(), 1, g)
    checks["broadcast"] = bool(np.array_equal(y.cpu().numpy(), xs[1]))
    comm.STATS.reset()
    checks["all_gather"] = bool(np.array_equal(
        comm.all_gather(x, g).cpu().numpy(), np.concatenate(xs)))
    checks["reduce_scatter"] = bool(np.allclose(
        comm.reduce_scatter(x, g).cpu().numpy(),
        np.split(np.sum(np.stack(xs), 0), n)[r], rtol=1e-6, atol=1e-6))
    checks["all_to_all"] = bool(np.array_equal(
        comm.all_to_all(x, g).cpu().numpy(),
        np.concatenate([np.split(xk, n)[r] for xk in xs])))
    out["comm"] = comm.STATS.snapshot()
    q = torch.from_numpy(np.concatenate(xs).reshape(n, -1)[r].copy()).to(dev)
    a = quantized_mean(q, g, 16, exchange=True).cpu().numpy()
    b = quantized_mean(q, g, 16, exchange=False).cpu().numpy()
    ref = np.concatenate(xs).reshape(n, -1).mean(0)
    checks["quantized_mean"] = bool(np.allclose(a, b, atol=1e-5) and
                                    np.abs(a - ref).max() < 0.1)
    out["checks"] = checks
    # the bucket op's reduced gradient is read only after its wait
    seen = []
    for t_ in ("adam", "fused_adam"):
        d = get_op_def(t_)
        orig = d.lower

        def wrapped(ctx, op, ins, _orig=orig):
            seen.append([nm for nm in op.inputs.get("Grad", [])
                         if nm in ctx.pending])
            return _orig(ctx, op, ins)

        d.lower = wrapped
    out["unplanned"] = train(True, False)
    out["planned"] = train(True, True)
    out["read_pending"] = [s for s in seen if s]
    out["optimizer_ops_seen"] = len(seen)
with open(os.path.join(sys.argv[1], f"rank{r}.json"), "w") as f:
    json.dump(out, f)
'''


def _launch_world(tmp_path, nproc, backend):
    import json
    import os
    import subprocess
    import sys

    from paddle_tpu_torch.parallel.env import free_port

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "dist_worker.py"
    worker.write_text(_DIST_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = root
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={nproc}", f"--backend={backend}",
         f"--started_port={free_port()}", f"--run_dir={tmp_path / 'run'}",
         str(worker), str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(nproc)]


def test_nccl_world_of_one_keeps_the_bits(cuda, tmp_path):
    (r0,) = _launch_world(tmp_path, 1, "nccl")
    assert r0["backend"] == "nccl" and r0["world"] == 1
    assert r0["all_reduce_same_bits"]
    # the bucketed data-parallel step at one rank is the plain step
    assert r0["bucketed"] == r0["plain"]


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return _launch_world(tmp_path_factory.mktemp("gloo2"), 2, "gloo")


def test_gloo_world_of_two_on_one_card_comm_layer(cuda, gloo_world):
    for rk in gloo_world:
        assert rk["backend"] == "gloo"
        assert all(rk["checks"].values()), rk["checks"]
        # gloo's own all_gather, reduce_scatter and all_to_all on the
        # CUDA tensors, each counted once with the bytes it was handed
        assert rk["comm"]["comm_calls_total"] == 3
        assert rk["comm"]["comm_bytes_total"] == (2 + 1 + 1) * 8 * 6 * 4


def test_async_bucket_reduce_is_read_only_after_its_wait(cuda, gloo_world):
    for rk in gloo_world:
        assert rk["optimizer_ops_seen"] > 0
        assert rk["read_pending"] == []
        assert rk["planned"][0] == rk["unplanned"][0]
        assert rk["planned"][1] == rk["unplanned"][1]
    assert gloo_world[0]["planned"][1] == gloo_world[1]["planned"][1]


# -- tensor and sequence parallelism on the card (gloo world of 2) ------------

_A10B_WORKER = '''
import json, os, sys
import numpy as np
import torch
import paddle_tpu_torch as fluid
from paddle_tpu_torch.models.gpt import (GPTConfig, build_gpt_lm,
                                         apply_gpt_megatron_sharding,
                                         synthetic_lm_batch)
from paddle_tpu_torch.parallel import comm
from paddle_tpu_torch.parallel.env import init_parallel_env
from paddle_tpu_torch.parallel.mesh import world_group
from paddle_tpu_torch.parallel.ring_attention import ring_attention

env = init_parallel_env()
r, n = env.rank, env.world_size
g = world_group()
dev = torch.device("cuda", 0)
out = {}
x = torch.arange(6, dtype=torch.float32, device=dev) + 10 * r
out["permute"] = [comm.permute(x, g).cpu().tolist(),
                  comm.permute(x, g, 1, ring=False).cpu().tolist(),
                  comm.permute(x, g, -1, ring=False).cpu().tolist()]
xl = x.clone().requires_grad_(True)
(comm.permute_autograd(xl, g) * (r + 2)).sum().backward()
out["permute_grad"] = xl.grad.cpu().tolist()
gd = comm.gather_dim(xl.reshape(2, 3), 1, g)
out["gather"] = list(gd.shape)

rng = np.random.RandomState(0)
q, k, v = (torch.from_numpy(rng.randn(1, 2, 64, 16).astype("float32"))
           .to(dev) for _ in range(3))
o = ring_attention(q[:, :, 32 * r:32 * r + 32], k[:, :, 32 * r:32 * r + 32],
                   v[:, :, 32 * r:32 * r + 32], g, causal=True)
ref = torch.softmax((q @ k.transpose(-1, -2)) / 4.0 + torch.triu(
    torch.full((64, 64), -1e30, device=dev), 1), -1) @ v
out["ring_err"] = float((o - ref[:, :, 32 * r:32 * r + 32]).abs().max())

cfg = GPTConfig.tiny()
cfg.use_flash_attention = True
batches = [synthetic_lm_batch(np.random.RandomState(s), 2, 32,
                              cfg.vocab_size) for s in range(2)]
res = {}
for kind in ("one", "tp"):
    with fluid.unique_name.guard():
        main, startup, _, f = build_gpt_lm(cfg, 32,
                                           optimizer=fluid.optimizer.Adam(1e-3))
    main.random_seed = startup.random_seed = 3
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    prog = main
    if kind == "tp":
        apply_gpt_megatron_sharding(main, mp_axis="tp")
        prog = fluid.CompiledProgram(main).with_partitioning(
            mesh_axes={"tp": 2})
    res[kind] = [float(np.asarray(exe.run(prog, feed=b, fetch_list=[f["loss"]],
                                          scope=scope)[0]).reshape(-1)[0])
                 for b in batches]
    res[kind + "_qkv"] = list(scope.find_var("dec0_qkv.w").shape)
    res[kind + "_dev"] = str(scope.find_var("dec0_qkv.w").device)
out["tp"] = res
with open(os.path.join(sys.argv[1], f"rank{r}.json"), "w") as fh:
    json.dump(out, fh)
'''


@pytest.fixture(scope="module")
def a10b_world(tmp_path_factory):
    import json
    import os
    import subprocess
    import sys

    from paddle_tpu_torch.parallel.env import free_port

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    d = tmp_path_factory.mktemp("a10b")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    (d / "worker.py").write_text(_A10B_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = root
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", "--backend=gloo",
         f"--started_port={free_port()}", f"--run_dir={d / 'run'}",
         str(d / "worker.py"), str(d)],
        capture_output=True, text=True, timeout=600, env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(2)]


def test_permute_on_cuda_tensors_over_gloo(cuda, a10b_world):
    for r, rk in enumerate(a10b_world):
        other = [float(i) + 10 * (1 - r) for i in range(6)]
        ring, fwd, bwd = rk["permute"]
        assert ring == other
        assert fwd == (other if r == 1 else [0.0] * 6)
        assert bwd == (other if r == 0 else [0.0] * 6)
        # the gradient came back from the rank that scaled it
        assert rk["permute_grad"] == [float(1 - r + 2)] * 6
        assert rk["gather"] == [2, 6]
        assert rk["ring_err"] < 1e-4


def test_tp_gpt_on_cuda_matches_one_process_with_its_qkv_shard(cuda,
                                                               a10b_world):
    for rk in a10b_world:
        tp = rk["tp"]
        np.testing.assert_allclose(tp["tp"], tp["one"], rtol=1e-3)
        assert tp["one_qkv"] == [64, 192] and tp["tp_qkv"] == [64, 96]
        assert tp["tp_dev"].startswith("cuda")
    assert a10b_world[0]["tp"]["tp"] == a10b_world[1]["tp"]["tp"]


# -- recurrence and sequences (A11b) ----------------------------------------------


def _drnn_program(B, T, D, Hd):
    """A DynamicRNN over [B, T, D] with lengths whose step is an fc of
    [x, h]: (main, startup, fetch names)."""
    import paddle_tpu_torch as fl

    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 3
    with fl.program_guard(main, startup), fl.unique_name.guard():
        L = fl.layers
        blk = main.global_block()
        x = blk.create_var(name="x", shape=(B, T, D), dtype="float32",
                           is_data=True, stop_gradient=False)
        ln = blk.create_var(name="len", shape=(B,), dtype="int32",
                            is_data=True)
        drnn = L.DynamicRNN()
        with drnn.block():
            w = drnn.step_input(x, length=ln)
            prev = drnn.memory(shape=[Hd], value=0.0)
            h = L.fc([w, prev], Hd, act="tanh")
            drnn.update_memory(prev, h)
            drnn.output(h)
        out = drnn()
        loss = L.reduce_sum(L.elementwise_mul(out, out))
        fl.append_backward(loss)
    op = [o for o in main.global_block().ops if o.type == "recurrent"][0]
    fetch = [out.name, op.outputs["FinalMemories"][0], "x@GRAD"] + [
        v.name + "@GRAD" for v in main.list_vars() if v.persistable]
    return main, startup, fetch


def test_recurrent_and_dynamic_rnn_frozen_rows_on_cuda_match_the_cpu(cuda):
    import paddle_tpu_torch as fl

    B, T, D, Hd = 6, 9, 5, 7
    main, startup, fetch = _drnn_program(B, T, D, Hd)
    rng = np.random.RandomState(0)
    lens = np.array([9, 1, 4, 0, 7, 2], np.int32)
    feed = {"x": rng.randn(B, T, D).astype(np.float32), "len": lens}
    res = {}
    for dev, place in (("cpu", fl.CPUPlace()), ("cuda", fl.CUDAPlace(0))):
        scope = fl.Scope()
        exe = fl.Executor(place)
        exe.run(startup, scope=scope)
        if dev == "cuda":
            for n, v in res["cpu_init"].items():
                scope.set_var(n, torch.from_numpy(v).to(cuda))
        else:
            res["cpu_init"] = {v.name: np.array(scope.get_numpy(v.name))
                               for v in main.list_vars() if v.persistable}
        res[dev] = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    for a, b in zip(res["cpu"], res["cuda"]):
        np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-5)
    out, fin = res["cuda"][0], res["cuda"][1]
    for b, n in enumerate(lens):
        assert np.all(out[b, n:] == 0.0)
        np.testing.assert_array_equal(fin[b], out[b, n - 1] if n else 0.0)


def test_beam_search_tie_order_on_cuda(cuda):
    """Ties in a [B, beam·V] row (finished beams make NEG_INF ties) keep
    jax.lax.top_k's order, the lower flat index first, on the card."""
    from paddle_tpu_torch.core.registry import LoweringContext, get_op_def

    class _Op:
        attrs = {"beam_size": 8, "end_id": 1, "is_accumulated": True}

    rng = np.random.RandomState(5)
    B, beam, Vd = 4, 8, 3000
    scores = rng.randint(-3, 0, (B, beam, Vd)).astype(np.float32)
    pre_ids = rng.randint(0, 3, (B, beam)).astype(np.int64)
    pre_scores = rng.randint(-2, 0, (B, beam)).astype(np.float32)
    outs = {}
    for dev in ("cpu", "cuda"):
        ins = {"pre_ids": [torch.from_numpy(pre_ids).to(dev)],
               "pre_scores": [torch.from_numpy(pre_scores).to(dev)],
               "scores": [torch.from_numpy(scores).to(dev)]}
        r = get_op_def("beam_search").lower(LoweringContext(dev), _Op(), ins)
        outs[dev] = {k: v[0].cpu().numpy() for k, v in r.items()}
    flat = np.where((pre_ids == 1)[..., None], -1e9, scores)
    for k in outs["cpu"]:
        np.testing.assert_array_equal(outs["cuda"][k], outs["cpu"][k])
    # the reference rule: a stable descending sort of the flat row
    acc = flat.copy()
    acc[..., 1] = np.where(pre_ids == 1, pre_scores, scores[..., 1])
    order = np.argsort(-acc.reshape(B, -1), axis=1, kind="stable")[:, :8]
    np.testing.assert_array_equal(outs["cuda"]["parent_idx"], order // Vd)
    np.testing.assert_array_equal(outs["cuda"]["selected_ids"], order % Vd)


def test_linear_chain_crf_gradient_on_cuda(cuda):
    from paddle_tpu_torch.core.registry import LoweringContext, get_op_def

    class _Op:
        attrs = {}

    rng = np.random.RandomState(6)
    B, T, C = 8, 30, 60
    em = rng.randn(B, T, C).astype(np.float32)
    tr = rng.randn(C + 2, C).astype(np.float32) * 0.1
    lab = rng.randint(0, C, (B, T)).astype(np.int64)
    lens = rng.randint(1, T + 1, B).astype(np.int32)
    res = {}
    for dev in ("cpu", "cuda"):
        e = torch.from_numpy(em).to(dev).requires_grad_(True)
        t = torch.from_numpy(tr).to(dev).requires_grad_(True)
        r = get_op_def("linear_chain_crf").lower(
            LoweringContext(dev), _Op(),
            {"Emission": [e], "Transition": [t],
             "Label": [torch.from_numpy(lab).to(dev)],
             "Length": [torch.from_numpy(lens).to(dev)]})
        nll = r["LogLikelihood"][0]
        ge, gt = torch.autograd.grad(nll.sum(), [e, t])
        res[dev] = [nll.detach().cpu().numpy(), ge.cpu().numpy(),
                    gt.cpu().numpy()]
    for a, b in zip(res["cpu"], res["cuda"]):
        np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-5)


# -- the imperative mode (dygraph) ----------------------------------------------


def _dygraph_step(device_place, state=None, x=None, y=None):
    """One dygraph Linear -> LayerNorm -> Linear step with K4's loss:
    (loss, {name: gradient}, state_dict, launches)."""
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.dygraph as dg
    from paddle_tpu_torch.dygraph.base import _trace

    with dg.guard(device_place):
        model = dg.Sequential(dg.Linear(16, 32), dg.LayerNorm(32),
                              dg.Linear(32, 10))
        if state is not None:
            model.set_dict(state)
        sd = model.state_dict()
        K.reset_launch_counts()
        _, per_row = _trace("softmax_with_cross_entropy",
                            {"Logits": [model(x)],
                             "Label": [dg.to_variable(y)]},
                            ["Softmax", "Loss"], {})
        loss = fluid.layers.mean(per_row)
        loss.backward()
        grads = {k: p.gradient for k, p in model.named_parameters()}
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return float(loss.numpy()), grads, sd, K.launch_counts()


def test_dygraph_step_on_cuda_launches_each_kernel_once(cuda):
    import paddle_tpu_torch as fluid

    rng = np.random.RandomState(3)
    x = rng.randn(64, 16).astype(np.float32)
    y = rng.randint(0, 10, (64, 1)).astype(np.int64)
    loss, grads, sd, counts = _dygraph_step(fluid.CUDAPlace(0), x=x, y=y)
    want = {"layer_norm": 1, "layer_norm_bwd": 1, "softmax_xent_fwd": 1,
            "softmax_xent_bwd": 1}
    assert {k: v for k, v in counts.items() if v} == want
    closs, cgrads, _, ccounts = _dygraph_step(fluid.CPUPlace(), state=sd,
                                              x=x, y=y)
    assert not any(ccounts.values())
    np.testing.assert_allclose(loss, closs, rtol=1e-5)
    for k in cgrads:
        np.testing.assert_allclose(grads[k], cgrads[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_traced_layer_replay_equals_eager_on_cuda(cuda):
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.dygraph as dg

    rng = np.random.RandomState(4)
    with dg.guard(fluid.CUDAPlace(0)):
        model = dg.Sequential(dg.Conv2D(3, 8, 3, padding=1, act="relu"),
                              dg.BatchNorm(8), dg.Pool2D(2, "max", 2),
                              dg.LayerNorm([8, 4, 4]))
        model.eval()
        _, traced = dg.TracedLayer.trace(
            model, [rng.randn(4, 3, 8, 8).astype(np.float32)])
        for _ in range(2):
            x = dg.to_variable(rng.randn(4, 3, 8, 8).astype(np.float32))
            with dg.no_grad():
                want = model(x).value
            before = K.layer_norm.launches
            got = traced([x])[0].value
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            # the replay counts the graph's K1 node
            assert K.layer_norm.launches == before + 1


def test_traced_layer_names_the_op_it_cannot_capture(cuda):
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.dygraph as dg

    class HostRead(dg.Layer):
        def __init__(self):
            super().__init__()
            self.fc = dg.Linear(4, 4)

        def forward(self, x):
            y = self.fc(x)
            return y * float(y.numpy().sum())

    with dg.guard(fluid.CUDAPlace(0)):
        with pytest.raises(RuntimeError, match="cannot be captured"):
            dg.TracedLayer.trace(HostRead(),
                                 [np.ones((2, 4), np.float32)])


def test_dygraph_guard_with_no_place():
    """``guard()`` names no place: CUDAPlace(0) on a card, and on a box
    with none it raises rather than fall back to the CPU."""
    import paddle_tpu_torch.dygraph as dg

    if torch.cuda.is_available():
        with dg.guard():
            assert dg.to_variable(np.ones(2)).value.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with dg.guard():
                pass


def _det_op(**attrs):
    class _Op:
        pass

    op = _Op()
    op.attrs = dict(attrs, op_ident=1)
    return op


def test_multiclass_nms_on_cuda_matches_the_cpu(cuda):
    """The batched greedy NMS on the card picks the CPU's boxes: rows,
    box indices and counts equal, exactly tied scores included."""
    from paddle_tpu_torch.core.registry import LoweringContext, get_op_def

    rng = np.random.RandomState(8)
    B, C, M = 3, 6, 1500
    xy = rng.rand(B, M, 2) * 0.85
    boxes = np.concatenate([xy, xy + rng.rand(B, M, 2) * 0.15 + 0.01],
                           -1).astype(np.float32)
    scores = rng.rand(B, C, M).astype(np.float32)
    scores[:, :, ::7] = 0.5          # exact ties across boxes and classes
    op = _det_op(background_label=0, score_threshold=0.05,
                 nms_threshold=0.45, keep_top_k=40, nms_eta=0.95)
    outs = {}
    for dev in ("cpu", "cuda"):
        ins = {"BBoxes": [torch.from_numpy(boxes).to(dev)],
               "Scores": [torch.from_numpy(scores).to(dev)]}
        r = get_op_def("multiclass_nms2").lower(LoweringContext(dev), op, ins)
        outs[dev] = {k: v[0].cpu().numpy() for k, v in r.items()}
    for k in ("Index", "NmsRoisNum"):
        np.testing.assert_array_equal(outs["cuda"][k], outs["cpu"][k])
    np.testing.assert_array_equal(outs["cuda"]["Out"][..., 0],
                                  outs["cpu"]["Out"][..., 0])
    np.testing.assert_allclose(outs["cuda"]["Out"], outs["cpu"]["Out"],
                               rtol=1e-5, atol=1e-6)
    assert (outs["cuda"]["NmsRoisNum"] == 40).all()


def test_ssd_loss_dense_on_cuda_matches_the_cpu(cuda):
    """ssd_loss_dense's loss and its Loc / Conf gradients, card against
    CPU (rtol 1e-5 / 1e-4): the same positives and mined negatives."""
    from paddle_tpu_torch.core.registry import LoweringContext, get_op_def
    import paddle_tpu_torch.models  # noqa: F401 (registers the op)

    rng = np.random.RandomState(9)
    B, P, G, C = 4, 2000, 5, 21
    xy = rng.rand(P, 2) * 0.8
    prior = np.concatenate([xy, xy + rng.rand(P, 2) * 0.2 + 0.02],
                           -1).astype(np.float32)
    gxy = rng.rand(B, G, 2) * 0.6
    gt = np.concatenate([gxy, gxy + rng.rand(B, G, 2) * 0.3 + 0.1],
                        -1).astype(np.float32)
    label = rng.randint(0, C, (B, G)).astype(np.int64)
    loc = (rng.randn(B, P, 4) * 0.5).astype(np.float32)
    conf = rng.randn(B, P, C).astype(np.float32)
    pvar = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), (P, 1))
    op = _det_op(overlap_threshold=0.5, neg_pos_ratio=3.0)
    res = {}
    for dev in ("cpu", "cuda"):
        l = torch.from_numpy(loc).to(dev).requires_grad_()
        c = torch.from_numpy(conf).to(dev).requires_grad_()
        ins = {"Loc": [l], "Conf": [c],
               "GtBox": [torch.from_numpy(gt).to(dev)],
               "GtLabel": [torch.from_numpy(label).to(dev)],
               "Prior": [torch.from_numpy(prior).to(dev)],
               "PVar": [torch.from_numpy(pvar).to(dev)]}
        loss = get_op_def("ssd_loss_dense").lower(LoweringContext(dev), op,
                                                  ins)["Loss"][0]
        gl, gc = torch.autograd.grad(loss.sum(), [l, c])
        res[dev] = [t.detach().cpu().numpy() for t in (loss, gl, gc)]
    np.testing.assert_allclose(res["cuda"][0], res["cpu"][0], rtol=1e-5)
    for a, b in zip(res["cpu"][1:], res["cuda"][1:]):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-7)


# -- the serving kernels' Program forms (A11f) ----------------------------------


def _tiny_serving_scope(dev, seed=5):
    """A 2-layer GPT's weights (seeded, on ``dev``) in a Scope."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.generation.model import GPTLM

    cfg = GPTConfig(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
                    ffn_size=128, max_position=128, hidden_dropout=0.0,
                    attention_dropout=0.0)
    g = torch.Generator().manual_seed(seed)
    scope = fluid.Scope()
    for n, p in GPTLM(cfg, device="meta").jax_params().items():
        scope.set_var(n, (0.05 * torch.randn(tuple(p.shape),
                                             generator=g)).to(dev))
    return cfg, scope


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_ragged_step_program_on_cuda_matches_the_cpu(cuda, kv):
    """One mixed ragged step through the Program on the card (K2 / K2q,
    K1) against the CPU Program: tokens equal, pools within 1e-5 (int8
    pools one step), the fed pools left as they were."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.generation import (CacheGeometry,
                                             build_ragged_step_program)

    rng = np.random.RandomState(3)
    R, C, P, ps, maxp = 4, 8, 24, 4, 12
    tables = np.zeros((R, maxp), np.int32)
    tables[0, :2], tables[1, :4], tables[2, :3] = [1, 2], [3, 4, 5, 6], \
        [7, 8, 9]
    feed = {"gen_tokens": rng.randint(1, 97, (R, C)).astype(np.int64),
            "gen_positions": np.array([0, 9, 4, 0], np.int64),
            "gen_num_valid": np.array([8, 1, 5, 0], np.int32),
            "gen_block_tables": tables}
    feed["gen_pos_ids"] = feed["gen_positions"][:, None] + np.arange(C)
    for i in range(2):
        for s in "kv":
            if kv == "int8":
                feed[f"gen_{s}_pages_{i}"] = rng.randint(
                    -127, 128, (4, P, ps, 16)).astype(np.int8)
                feed[f"gen_{s}_scales_{i}"] = (
                    0.02 * rng.rand(4, P, ps)).astype(np.float32)
            else:
                feed[f"gen_{s}_pages_{i}"] = rng.randn(4, P, ps, 16).astype(
                    np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        cfg, scope = _tiny_serving_scope(dev)
        prog, fetches = build_ragged_step_program(
            cfg, CacheGeometry(P, ps, maxp), C, kv)
        tfeed = {k: torch.as_tensor(v).to(dev) for k, v in feed.items()}
        before = {k: v.clone() for k, v in tfeed.items()}
        K.reset_launch_counts()
        res = fluid.Executor(fluid.CPUPlace() if dev == "cpu" else
                             fluid.CUDAPlace(0)).run(
            prog, feed=tfeed, fetch_list=fetches, scope=scope)
        counts = K.launch_counts()
        for k in tfeed:
            assert torch.equal(tfeed[k], before[k]), k
        if dev == "cuda":
            name = "ragged_paged_attention" + ("_q" if kv == "int8" else "")
            assert counts[name] == 2 and counts["layer_norm"] == 5
        out[dev] = [np.asarray(r) for r in res]
    nv = feed["gen_num_valid"]
    tg, tc = out["cuda"][0].reshape(R, C), out["cpu"][0].reshape(R, C)
    for r in range(R):
        np.testing.assert_array_equal(tg[r, :nv[r]], tc[r, :nv[r]])
    for a, b in zip(out["cuda"][1:5], out["cpu"][1:5]):
        a, b = a.astype(np.float64), b.astype(np.float64)
        a[:, 0, 0] = b[:, 0, 0] = 0
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1.0 if kv == "int8" else 1e-5)


def test_decode_program_on_cuda_matches_the_cpu(cuda):
    """The decode Program (K13) on the card against the CPU's."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.generation import (CacheGeometry,
                                             build_decode_program)

    rng = np.random.RandomState(4)
    B, P, ps, maxp = 3, 16, 4, 8
    tables = np.zeros((B, maxp), np.int32)
    tables[:, :3] = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]
    feed = {"gen_tokens": rng.randint(1, 97, (B, 1)).astype(np.int64),
            "gen_positions": np.array([5, 0, 10], np.int64),
            "gen_num_valid": np.array([1, 1, 0], np.int32),
            "gen_attend_lens": np.array([6, 1, 0], np.int32),
            "gen_block_tables": tables}
    for i in range(2):
        for s in "kv":
            feed[f"gen_{s}_pages_{i}"] = rng.randn(4, P, ps, 16).astype(
                np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        cfg, scope = _tiny_serving_scope(dev)
        prog, fetches = build_decode_program(cfg, CacheGeometry(P, ps, maxp))
        K.reset_launch_counts()
        out[dev] = [np.asarray(r) for r in fluid.Executor(
            fluid.CPUPlace() if dev == "cpu" else fluid.CUDAPlace(0)).run(
            prog, feed=feed, fetch_list=fetches, scope=scope)]
        if dev == "cuda":
            assert K.launch_counts()["paged_attention"] == 2
    np.testing.assert_array_equal(out["cuda"][0][:2], out["cpu"][0][:2])
    for a, b in zip(out["cuda"][1:], out["cpu"][1:]):
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], atol=1e-5, rtol=0)


def test_batched_lora_fc_program_on_cuda_matches_the_cpu(cuda):
    """The Program rewrite over an int8 base: ``batched_lora_fc`` on the
    card (K11 + K12) against the CPU, one adapter row and a base row."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.adapters import AdapterStore, rewrite_for_lora
    from paddle_tpu_torch.quantize import rewrite_for_inference

    rng = np.random.RandomState(6)
    x = rng.randn(4, 32).astype(np.float32)
    w = (0.1 * rng.randn(32, 48)).astype(np.float32)
    fac = {"lf.w": ((0.1 * rng.randn(32, 8)).astype(np.float32),
                    (0.1 * rng.randn(8, 48)).astype(np.float32))}
    out = {}
    for dev in ("cpu", "cuda"):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            xv = fluid.layers.data("x", [32])
            y = fluid.layers.fc(xv, 48, bias_attr=False,
                                param_attr=fluid.ParamAttr(name="lf.w"))
        scope = fluid.Scope()
        scope.set_var("lf.w", torch.from_numpy(w.copy()).to(dev))
        rewrite_for_inference(main, scope, "int8")
        store = AdapterStore.for_program(main, slots_per_bucket=1, device=dev)
        assert rewrite_for_lora(main, store).n_repointed == 1
        store.attach(scope)
        store.upload("ad", fac, alpha=16.0)
        slots = np.stack([store.slots_row(a) for a in ("ad", None, "ad",
                                                       None)])
        K.reset_launch_counts()
        (r,) = fluid.Executor(fluid.CPUPlace() if dev == "cpu" else
                              fluid.CUDAPlace(0)).run(
            main, feed={"x": x, "gen_adapter_slots": slots.astype(np.int32)},
            fetch_list=[y], scope=scope)
        if dev == "cuda":
            c = K.launch_counts()
            assert c["quantized_matmul"] == 1 and c["batched_lora_add_"] == 1
        out[dev] = np.asarray(r)
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-5)


# -- the NCHW -> NHWC pass (transpiler.auto_nhwc) -----------------------------------


def _small_resnet_nhwc(fluid, flip, optimizer, size=16):
    """The two-bottleneck net of ``tests/test_torch_resnet.py`` built
    NCHW, through ``auto_nhwc`` when ``flip``, then minimized."""
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.transpiler import auto_nhwc

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("image", [3, size, size])
        label = fluid.layers.data("label", [1], dtype="int64")
        x = resnet._conv_bn(img, 8, 3, stride=2, name="stem")
        x = fluid.layers.pool2d(x, 3, "max", pool_stride=2, pool_padding=1)
        x = resnet._bottleneck(x, 4, 1, "a")
        x = resnet._bottleneck(x, 4, 1, "c")
        x = resnet._bottleneck(x, 4, 2, "b")
        pool = fluid.layers.pool2d(x, 2, "avg", global_pooling=True)
        logits = fluid.layers.fc(pool, 5,
                                 param_attr=fluid.ParamAttr(name="head.w"))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        if flip:
            assert auto_nhwc(main) >= 20
        optimizer.minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_auto_nhwc_step_on_cuda_matches_nchw(cuda, opt):
    """The two-bottleneck ResNet through ``auto_nhwc``: one fused step on
    the card (K10m or K10, once a parameter, every gradient handed to the
    kernel contiguous) from the NCHW program's values: the loss within
    rtol 1e-4 of the NCHW step's, the update's state (Momentum's
    velocities, Adam's first moments: the gradients) within relative L2
    1e-4, the parameters within 2 * lr."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import optim

    lr = 0.01 if opt == "momentum" else 1e-3
    wrapper = ("fused_momentum_update" if opt == "momentum"
               else "fused_adam_update")
    state = "velocity" if opt == "momentum" else "moment1"

    def make():
        return (fluid.optimizer.MomentumOptimizer(lr, 0.9) if opt == "momentum"
                else fluid.optimizer.AdamOptimizer(lr))

    handed = []
    update = getattr(optim, wrapper)

    def spy(p, g, *a, **kw):
        handed.append(g.is_contiguous())
        return update(p, g, *a, **kw)

    rng = np.random.RandomState(0)
    batch = {"image": rng.randn(16, 3, 16, 16).astype("float32"),
             "label": rng.randint(0, 5, (16, 1)).astype("int64")}
    fluid.set_flags({"optimizer_fuse": "on"})
    try:
        progs = {flip: _small_resnet_nhwc(fluid, flip, make())
                 for flip in (False, True)}
        main, startup, _ = progs[False]
        n_params = len(main.all_parameters())
        scope0 = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope0)
        names = [v.name for v in main.list_vars()
                 if v.persistable and not v.is_data]
        out = {}
        for flip in (False, True):
            prog, _, loss = progs[flip]
            scope = fluid.Scope()
            for n in names:
                scope.set_var(n, scope0.find_var(n).clone())
            K.reset_launch_counts()
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(optim, wrapper, spy)
                (lv,) = exe.run(prog, feed=batch, fetch_list=[loss],
                                scope=scope)
            torch.cuda.synchronize()
            assert getattr(K, wrapper).launches == n_params
            out[flip] = (float(np.asarray(lv).reshape(-1)[0]),
                         {n: scope.find_var(n) for n in names})
        assert len(handed) == 2 * n_params and all(handed)
        np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-4)
        for v in main.global_block().vars.values():
            if getattr(v, "is_accumulator", False) and state in v.name:
                a, b = out[True][1][v.name], out[False][1][v.name]
                err = float((a - b).norm() / b.norm().clamp_min(1e-30))
                assert err <= 1e-4, (v.name, err)
        for p in main.all_parameters():
            d = float((out[True][1][p.name] - out[False][1][p.name]).abs().max())
            assert d <= 2 * lr, (p.name, d)
    finally:
        fluid.set_flags({"optimizer_fuse": "auto"})
