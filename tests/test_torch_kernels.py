"""paddle_tpu_torch kernels against the JAX package, on the CPU.

On a CPU tensor each kernel wrapper runs its plain PyTorch version, so
these tests hold the port's arithmetic (the yardstick the CUDA kernels
are held to on the card by chip_smoke.py and tests/test_torch_gpu.py)
against the JAX package: its pure-JAX reference path and its Pallas
kernel body in interpret mode (PADDLE_TPU_KERNEL_INTERPRET=1, as
tests/test_ragged.py runs it). Inputs are made with numpy from a seed
and handed to both frameworks.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.kernels.layer_norm import fused_layer_norm
from paddle_tpu.kernels.paged_attention import kv_cache_write as jax_kv_write
from paddle_tpu.kernels.ragged_paged_attention import (
    ragged_paged_attention as jax_ragged)
from paddle_tpu.param_attr import ParamAttr
from paddle_tpu_torch import kernels as K
from paddle_tpu_torch.kernels import _build

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# (B, C, H, KVH, D, P, ps, maxp, starts, num_valid)
RAGGED_CASES = {
    # the four row kinds one engine step mixes (tests/test_ragged.py
    # _mixed_batch): a prefill chunk from 0, a decode row over a 6-token
    # prefix, a mid-prompt chunk, an idle lane
    "mixed": (4, 5, 4, 4, 8, 24, 4, 5, [0, 6, 9, 0], [5, 1, 3, 0]),
    # the same rows under grouped-query attention, group 2
    "gqa": (4, 5, 8, 4, 8, 24, 4, 5, [0, 6, 9, 0], [5, 1, 3, 0]),
    # long rows whose last page is partial (stale rows past the length),
    # one ending exactly on a page boundary, a chunk cut short
    "stale_tail": (3, 6, 4, 2, 16, 40, 8, 6,
                   [13, 34, 40], [3, 6, 2]),
}


def _ragged_inputs(case, seed=0):
    """Pools full of random data (every page, the junk page 0 included,
    holds stale rows), distinct pages per row, zero past each chain."""
    B, C, H, KVH, D, P, ps, maxp, starts, nvalid = RAGGED_CASES[case]
    rng = np.random.RandomState(seed)
    kp = rng.randn(KVH, P, ps, D).astype(np.float32)
    vp = rng.randn(KVH, P, ps, D).astype(np.float32)
    q = rng.randn(B, C, H, D).astype(np.float32)
    tables = np.zeros((B, maxp), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        n = -(-(starts[b] + nvalid[b]) // ps) if nvalid[b] else 0
        tables[b, :n] = [free.pop() for _ in range(n)]
    return (q, kp, vp, np.asarray(starts, np.int32),
            np.asarray(nvalid, np.int32), tables)


def _port_ragged(arrs, dtype):
    q, kp, vp, st, nv, tb = arrs
    dt = TORCH_DT[dtype]
    out = K.ragged_paged_attention(
        torch.from_numpy(q).to(dt), torch.from_numpy(kp).to(dt),
        torch.from_numpy(vp).to(dt), torch.from_numpy(st),
        torch.from_numpy(nv), torch.from_numpy(tb))
    assert out.dtype == dt
    return out.float().numpy()


def _jax_ragged(arrs, dtype):
    q, kp, vp, st, nv, tb = arrs
    dt = JAX_DT[dtype]
    return np.asarray(jax_ragged(
        jnp.asarray(q, dt), jnp.asarray(kp, dt), jnp.asarray(vp, dt),
        jnp.asarray(st), jnp.asarray(nv), jnp.asarray(tb))).astype(np.float32)


@pytest.mark.parametrize("path", ["reference", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_ragged_plain_matches_jax(case, dtype, path, monkeypatch):
    """The port's plain ragged attention equals the JAX package's, both
    its reference path and its Pallas kernel body (interpret mode)."""
    if path == "interpret":
        monkeypatch.setenv("PADDLE_TPU_KERNEL_INTERPRET", "1")
    else:
        monkeypatch.delenv("PADDLE_TPU_KERNEL_INTERPRET", raising=False)
    arrs = _ragged_inputs(case)
    got = _port_ragged(arrs, dtype)
    want = _jax_ragged(arrs, dtype)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    nvalid = arrs[4]
    assert np.all(np.isfinite(got))
    for b, n in enumerate(nvalid):
        # rows past num_valid and whole idle lanes are exactly zero
        assert np.all(got[b, int(n):] == 0.0), (case, b)


def test_ragged_plain_against_dense_rows():
    """Each valid row of the plain version is a dense softmax over the
    row's first start + j + 1 keys, gathered by hand from the pages."""
    q, kp, vp, st, nv, tb = arrs = _ragged_inputs("gqa", seed=3)
    got = _port_ragged(arrs, "float32")
    H, KVH, ps, D = q.shape[2], kp.shape[0], kp.shape[2], q.shape[3]
    for b in range(q.shape[0]):
        for j in range(int(nv[b])):
            n = int(st[b]) + j + 1
            pos = np.arange(n)
            pages = tb[b, pos // ps]
            for h in range(H):
                kv = h // (H // KVH)
                keys = kp[kv, pages, pos % ps]
                vals = vp[kv, pages, pos % ps]
                s = keys @ q[b, j, h] / np.sqrt(D)
                p = np.exp(s - s.max())
                np.testing.assert_allclose(
                    got[b, j, h], (p / p.sum()) @ vals, rtol=1e-5, atol=1e-5)


def _ln_inputs(R, C, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(R, C) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    b = (0.1 * rng.randn(C)).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,C", [(300, 64), (7, 40)])
def test_layer_norm_plain_matches_pallas_interpret(R, C, dtype, monkeypatch):
    """R not a multiple of the TPU kernel's 256-row block."""
    monkeypatch.setenv("PADDLE_TPU_KERNEL_INTERPRET", "1")
    x, g, b = _ln_inputs(R, C)
    dt, jdt = TORCH_DT[dtype], JAX_DT[dtype]
    got = K.layer_norm(torch.from_numpy(x).to(dt), torch.from_numpy(g).to(dt),
                       torch.from_numpy(b).to(dt), 1e-5)
    want = fused_layer_norm(jnp.asarray(x, jdt), jnp.asarray(g, jdt),
                            jnp.asarray(b, jdt), 1e-5)
    assert got.dtype == dt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[dtype])


def test_layer_norm_plain_matches_xla_layer_norm_op(monkeypatch):
    """The ``layer_norm`` op's plain XLA lowering (ops/nn.py, what the
    JAX engine runs on a CPU), through a Program and the Executor."""
    monkeypatch.delenv("PADDLE_TPU_KERNEL_INTERPRET", raising=False)
    R, C = 300, 48
    x, g, b = _ln_inputs(R, C, seed=1)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        xv = fluid.layers.data("x", [C], dtype="float32")
        yv = fluid.layers.layer_norm(
            xv, begin_norm_axis=1, param_attr=ParamAttr(name="ln.scale"),
            bias_attr=ParamAttr(name="ln.bias"))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.TPUPlace())
        exe.run(startup)
        scope.set_var("ln.scale", jnp.asarray(g))
        scope.set_var("ln.bias", jnp.asarray(b))
        (want,) = exe.run(main, feed={"x": x}, fetch_list=[yv])
    got = K.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                       torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_kv_cache_write_matches_jax_functional_write():
    """In-place index_put_ == the JAX functional scatter, junk-page
    routing included: invalid rows land only on slot 0 of page 0."""
    rng = np.random.RandomState(5)
    B, S, KVH, D, P, ps, maxp = 4, 5, 2, 8, 16, 4, 4
    tables = np.zeros((B, maxp), np.int32)
    tables[0, :2] = [3, 7]
    tables[1, :3] = [1, 2, 9]
    tables[2, :1] = [4]
    positions = np.array([0, 6, 1, 0], np.int32)
    num_valid = np.array([5, 4, 2, 0], np.int32)
    k_new = rng.randn(B, S, KVH, D).astype(np.float32)
    v_new = rng.randn(B, S, KVH, D).astype(np.float32)
    zeros = np.zeros((KVH, P, ps, D), np.float32)
    jk, jv = jax_kv_write(jnp.asarray(zeros), jnp.asarray(zeros),
                          jnp.asarray(k_new), jnp.asarray(v_new),
                          jnp.asarray(tables), jnp.asarray(positions),
                          jnp.asarray(num_valid))
    tk, tv = torch.zeros(KVH, P, ps, D), torch.zeros(KVH, P, ps, D)
    K.kv_cache_write(tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new),
                     torch.from_numpy(tables), torch.from_numpy(positions),
                     torch.from_numpy(num_valid))
    for mine, ref, new in ((tk, jk, k_new), (tv, jv, v_new)):
        mine, ref = mine.numpy(), np.asarray(ref)
        np.testing.assert_array_equal(mine[:, 1:], ref[:, 1:])
        # the junk page: only slot 0 is ever written, by an invalid row
        assert np.all(mine[:, 0, 1:] == 0) and np.all(ref[:, 0, 1:] == 0)
        invalid = [new[b, j] for b in range(B) for j in range(S)
                   if j >= num_valid[b]]
        assert any(np.array_equal(mine[:, 0, 0], r) for r in invalid)
    # a live row's page was written where the table says
    np.testing.assert_array_equal(tk.numpy()[:, 2, 2], k_new[1, 0])


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    K.reset_launch_counts()
    q, kp, vp, st, nv, tb = _ragged_inputs("mixed")
    t = torch.from_numpy
    out = K.ragged_paged_attention(t(q), t(kp), t(vp), t(st), t(nv), t(tb))
    ref = K.ragged_paged_attention_plain(t(q), t(kp), t(vp), t(st), t(nv),
                                         t(tb))
    assert torch.equal(out, ref)
    x, g, b = (t(a) for a in _ln_inputs(9, 16))
    assert torch.equal(K.layer_norm(x, g, b), K.layer_norm_plain(x, g, b))
    # the training slice's kernels too
    y, mean, rstd = K.layer_norm_fwd(x, g, b)
    for got, want in zip(K.layer_norm_bwd(x, g, y, mean, rstd),
                         K.layer_norm_bwd_plain(x, g, y, mean, rstd)):
        assert torch.equal(got, want)
    labels = torch.tensor([0, 3, 15, 7, 1, 2, 3, 4, 5])
    loss, lse = K.softmax_xent_fwd(x, labels)
    assert torch.equal(loss, K.softmax_xent_fwd_plain(x, labels)[0])
    assert torch.equal(K.softmax_xent_bwd(x, labels, lse, loss),
                       K.softmax_xent_bwd_plain(x, labels, lse, loss))
    one = torch.ones(1)
    K.fused_adam_update(x, y, x.clone(), x.square(), one, 0.5 * one,
                        0.5 * one)
    # and the flash-attention slice's
    qkv = x[None, None, :8]
    o, fl = K.flash_attention_fwd(qkv, qkv, qkv, None, None, 0.25, True)
    K.flash_attention_bwd(qkv, qkv, qkv, None, None, o, fl, o, 0.25, True)
    # and the quantized, multi-adapter serving slice's
    qw, qs = K.quantize_weight(x.T.contiguous(), "int8")
    assert torch.equal(K.quantized_matmul(x[:, :16], qw, qs),
                       K.quantized_matmul_plain(x[:, :16], qw, qs))
    # an int8_block block that is not a multiple of 16 (the FMA kernel's
    # case on CUDA) is the plain version too
    qw, qs = K.quantize_weight(x.T.contiguous(), "int8_block", 5)
    assert torch.equal(
        K.quantized_matmul(x[:, :16], qw, qs, mode="int8_block", block=5),
        K.quantized_matmul_plain(x[:, :16], qw, qs, "int8_block", 5))
    pools = [torch.ones(2, 16, 3)], [torch.ones(2, 3, 9)], [torch.ones(2)]
    K.batched_lora_add_(x[:, :9].clone(), x, *pools,
                        torch.ones(9, 1, dtype=torch.int32))
    kq = t(kp).round().clamp(-127, 127).to(torch.int8)
    scales = torch.ones(kp.shape[:3])
    K.ragged_paged_attention(t(q), kq, kq, t(st), t(nv), t(tb),
                             k_scales=scales, v_scales=scales)
    # and the Momentum / two_lane slice's
    K.fused_momentum_update(x, y, x.clone(), one, mu=0.9, use_nesterov=True,
                            clip_scale=0.5 * one)
    lens = torch.tensor([3, 0], dtype=torch.int32)
    tabs = torch.tensor([[1, 2], [0, 0]], dtype=torch.int32)
    pq, pk = torch.ones(2, 4, 8), torch.ones(2, 3, 2, 8)
    assert torch.equal(K.paged_attention(pq, pk, pk, lens, tabs),
                       K.paged_attention_plain(pq, pk, pk, lens, tabs))
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}
    assert K.flash_attention_bwd.kernel_launches == {"delta": 0, "dq": 0,
                                                     "dkv": 0}
    assert sorted(K.KERNELS) == sorted([
        "layer_norm", "ragged_paged_attention", "layer_norm_bwd",
        "softmax_xent_fwd", "softmax_xent_bwd", "fused_adam_update",
        "flash_attention_fwd", "flash_attention_bwd",
        "ragged_paged_attention_q", "quantized_matmul",
        "quantized_matmul_fma", "batched_lora_add_",
        "fused_momentum_update", "paged_attention"])


def test_wrappers_refuse_other_devices_instead_of_falling_back():
    """A tensor that is neither on the CPU nor on CUDA raises: no path
    quietly runs the plain version for a device it was not asked for."""
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.layer_norm(x, torch.empty(8, device="meta"),
                     torch.empty(8, device="meta"))
    q = torch.empty(2, 3, 4, 8, device="meta")
    pages = torch.empty(4, 6, 4, 8, device="meta")
    ints = [torch.empty(2, dtype=torch.int32, device="meta")] * 2
    tb = torch.empty(2, 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.ragged_paged_attention(q, pages, pages, *ints, tb)
    i8 = torch.empty(4, 6, 4, 8, dtype=torch.int8, device="meta")
    sc = torch.empty(4, 6, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.ragged_paged_attention_q(q, i8, i8, sc, sc, *ints, tb)
    with pytest.raises(ValueError, match="unsupported device"):
        K.quantized_matmul(x, torch.empty(8, 3, dtype=torch.int8,
                                          device="meta"),
                           torch.empty(3, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        K.batched_lora_add_(torch.empty(4, 3, device="meta"), x,
                            [torch.empty(2, 8, 1, device="meta")],
                            [torch.empty(2, 1, 3, device="meta")],
                            [torch.empty(2, device="meta")],
                            torch.empty(4, 1, dtype=torch.int32,
                                        device="meta"))


@pytest.mark.parametrize("bad", ["int64_starts", "heads", "pages", "tables",
                                 "ln_gamma"])
def test_wrappers_check_their_inputs(bad):
    q, kp, vp, st, nv, tb = (torch.from_numpy(a)
                             for a in _ragged_inputs("mixed"))
    if bad == "ln_gamma":
        with pytest.raises(ValueError, match="gamma"):
            K.layer_norm(torch.zeros(3, 8), torch.ones(7), torch.zeros(8))
        return
    if bad == "int64_starts":
        st, err = st.long(), TypeError
    elif bad == "heads":
        q, err = q[:, :, :3].contiguous(), ValueError   # 3 heads over 4
    elif bad == "pages":
        vp, err = vp[..., :4].contiguous(), ValueError
    else:
        tb, err = tb[:2], ValueError
    with pytest.raises(err):
        K.ragged_paged_attention(q, kp, vp, st, nv, tb)


def test_build_sources_and_hash(tmp_path, monkeypatch):
    """Every kernel is built from csrc/, and the library name follows
    the sources: an edit gives a new hash (a rebuild)."""
    names = [p.name for p in _build.sources()]
    assert names == ["flash_attention.cu", "fused_optim.cu", "layer_norm.cu",
                     "lora.cu", "paged_attention.cu", "quant_matmul.cu",
                     "ragged_paged_attention.cu", "softmax_xent.cu"]
    # every C entry the wrappers bind is declared with its argtypes
    for src, entries in (("fused_optim.cu", ["pt_fused_adam",
                                             "pt_fused_momentum"]),
                         ("paged_attention.cu", ["pt_paged_attention"]),
                         ("flash_attention.cu", [
                             "pt_flash_attention_fwd",
                             "pt_flash_attention_bwd_delta",
                             "pt_flash_attention_bwd_dq",
                             "pt_flash_attention_bwd_dkv"]),
                         ("softmax_xent.cu", ["pt_softmax_xent_fwd",
                                              "pt_softmax_xent_bwd"]),
                         ("layer_norm.cu", ["pt_layer_norm_fwd",
                                            "pt_layer_norm_bwd"]),
                         ("ragged_paged_attention.cu", [
                             "pt_ragged_paged_attention",
                             "pt_ragged_paged_attention_q"]),
                         ("quant_matmul.cu", ["pt_quant_matmul"]),
                         ("lora.cu", ["pt_batched_lora_add"])):
        text = (_build.CSRC_DIR / src).read_text()
        for entry in entries:
            assert f'extern "C" int {entry}(' in text
            assert entry in _build.SIGNATURES
    h0 = _build.source_hash()
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", copy)
    assert _build.source_hash() == h0
    (copy / "layer_norm.cu").write_text(
        (copy / "layer_norm.cu").read_text() + "\n// edit\n")
    assert _build.source_hash() != h0
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
