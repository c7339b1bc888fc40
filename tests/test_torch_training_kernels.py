"""The training slice's kernels, plain versions against the JAX package,
on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version, the
arithmetic the CUDA kernels are held to on the card (chip_smoke.py,
tests/test_torch_gpu.py). Here those plain versions are held against
the JAX package's Pallas kernels run in interpret mode
(PADDLE_TPU_KERNEL_INTERPRET=1, as tests/test_fused_kernels.py does)
and against ``jax.vjp`` of the reference math:

* K1 stats + K3: layer-norm mean/rstd and backward (dx, dgamma, dbeta);
* K4/K5: softmax cross-entropy forward (loss, lse) and backward, with
  ignore_index rows as the reference op masks them;
* K10: the fused Adam / AdamW update with a clip scale.

Tolerances: float32 rtol/atol 1e-5 (2e-5 where a sum over a 1024-wide
row or 300 rows meets another summation order), bfloat16 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import fused_optim as jfo
from paddle_tpu.kernels import layer_norm as jln
from paddle_tpu.kernels import softmax_xent as jsx
from paddle_tpu_torch import kernels as K

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_KERNEL_INTERPRET", "1")


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a)).to(TORCH_DT[dtype])


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _j(a, dtype="float32"):
    return jnp.asarray(a, JAX_DT[dtype])


def _ln_inputs(R, C, seed):
    rng = np.random.RandomState(seed)
    x = (2 * rng.randn(R, C) + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    b = (0.1 * rng.randn(C)).astype(np.float32)
    dy = rng.randn(R, C).astype(np.float32)
    return x, g, b, dy


# -- K1 stats and K3 ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,C", [(300, 128), (37, 96), (8, 1024)])
def test_layer_norm_fwd_and_bwd_plain_match_pallas(R, C, dtype, interpret):
    x, g, b, dy = _ln_inputs(R, C, seed=R + C)
    eps = 1e-5
    y, mean, rstd = K.layer_norm_fwd(_t(x, dtype), _t(g, dtype),
                                     _t(b, dtype), eps)
    jy, jmean, jrstd = jln._fwd_impl(_j(x, dtype), _j(g, dtype),
                                     _j(b, dtype), eps)
    np.testing.assert_allclose(_np(y), np.asarray(jy, np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:, 0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[:, 0],
                               rtol=1e-5, atol=1e-5)
    dx, dg, db = K.layer_norm_bwd(_t(x, dtype), _t(g, dtype), _t(dy, dtype),
                                  mean, rstd)
    jdx, jdg, jdb = jln._vjp_bwd(
        eps, (_j(x, dtype), _j(g, dtype), jmean[:, 0], jrstd[:, 0]),
        _j(dy, dtype))
    assert dx.dtype == dg.dtype == db.dtype == TORCH_DT[dtype]
    for got, want in ((dx, jdx), (dg, jdg), (db, jdb)):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **TOL[dtype])


def _ln_ref(x, g, b, eps):
    mean = jnp.mean(x, axis=1, keepdims=True)
    var = jnp.var(x, axis=1, keepdims=True)
    return (x - mean) / jnp.sqrt(var + eps) * g + b


@pytest.mark.parametrize("R,C", [(64, 2048), (5, 33)])
def test_layer_norm_function_grads_match_jax_vjp(R, C):
    """fused_layer_norm's autograd (K1 forward, K3 backward) against
    jax.vjp of the plain layer-norm math, float32."""
    x, g, b, dy = _ln_inputs(R, C, seed=C)
    xt, gt, bt = (_t(a).requires_grad_() for a in (x, g, b))
    y = K.fused_layer_norm(xt, gt, bt, 1e-5)
    y.backward(_t(dy))
    jy, vjp = jax.vjp(lambda *a: _ln_ref(*a, 1e-5), jnp.asarray(x),
                      jnp.asarray(g), jnp.asarray(b))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip((xt.grad, gt.grad, bt.grad), vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


# -- K4 / K5 --------------------------------------------------------------------


def _xent_inputs(R, C, seed, scale=3.0):
    rng = np.random.RandomState(seed)
    logits = (scale * rng.randn(R, C)).astype(np.float32)
    labels = rng.randint(0, C, R).astype(np.int64)
    labels[0], labels[-1] = 0, C - 1
    dloss = rng.rand(R).astype(np.float32) + 0.5
    return logits, labels, dloss


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,C,scale", [(24, 1000, 3.0), (9, 333, 3.0),
                                       (16, 512, 1e4)])
def test_softmax_xent_plain_matches_pallas(R, C, scale, dtype, interpret):
    logits, labels, dloss = _xent_inputs(R, C, seed=C, scale=scale)
    lt, lb = _t(logits, dtype), torch.from_numpy(labels)
    loss, lse = K.softmax_xent_fwd(lt, lb)
    jloss, jlse = jsx._fwd_impl(_j(logits, dtype), jnp.asarray(labels,
                                                               jnp.int32))
    assert loss.dtype == lse.dtype == torch.float32
    # the Pallas kernel stores the loss in the logits' dtype
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss, np.float32),
                               rtol=TOL[dtype]["rtol"],
                               atol=TOL[dtype]["atol"] * max(1.0, scale / 10))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0],
                               rtol=1e-5, atol=1e-5 * max(1.0, scale))
    ds = K.softmax_xent_bwd(lt, lb, lse, torch.from_numpy(dloss))
    jds, _ = jsx._vjp_bwd((_j(logits, dtype), jnp.asarray(labels, jnp.int32),
                           jlse[:, 0]), jnp.asarray(dloss))
    assert ds.dtype == TORCH_DT[dtype]
    np.testing.assert_allclose(_np(ds), np.asarray(jds, np.float32),
                               **TOL[dtype])


def _xent_op_ref(logits, labels, ignore_index):
    """The reference op's arithmetic (ops/nn.py:246-274): safe labels
    into the kernel math, ignored rows masked to 0."""
    safe = jnp.where(labels == ignore_index, 0, labels)
    m = jnp.max(logits, axis=1, keepdims=True)
    lse = (m + jnp.log(jnp.sum(jnp.exp(logits - m), axis=1,
                               keepdims=True)))[:, 0]
    picked = jnp.take_along_axis(logits, safe[:, None], axis=1)[:, 0]
    return jnp.where(labels != ignore_index, lse - picked, 0.0)


@pytest.mark.parametrize("ignore_index", [-100, -1, 3])
def test_softmax_xent_function_grads_match_jax_vjp(ignore_index):
    """fused_softmax_xent's autograd (K4 forward, K5 backward) against
    jax.vjp of the reference op, with ignore_index rows, float32."""
    logits, labels, dloss = _xent_inputs(12, 50, seed=5)
    labels[[2, 7]] = ignore_index
    lt = _t(logits).requires_grad_()
    loss = K.fused_softmax_xent(lt, torch.from_numpy(labels), ignore_index)
    loss.backward(_t(dloss))
    jloss, vjp = jax.vjp(
        lambda lg: _xent_op_ref(lg, jnp.asarray(labels), ignore_index),
        jnp.asarray(logits))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               rtol=1e-5, atol=1e-5)
    (jg,) = vjp(jnp.asarray(dloss))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    assert loss[2].item() == 0.0 and np.all(lt.grad[[2, 7]].numpy() == 0)


def test_softmax_xent_label_out_of_range_picks_nothing():
    logits, labels, _ = _xent_inputs(4, 10, seed=1)
    labels[1] = 10
    loss, lse = K.softmax_xent_fwd(_t(logits), torch.from_numpy(labels))
    assert loss[1].item() == pytest.approx(lse[1].item())


# -- K10 --------------------------------------------------------------------------


def _adam_inputs(shape, seed, dtype):
    rng = np.random.RandomState(seed)
    arrs = dict(p=rng.randn(*shape), g=0.1 * rng.randn(*shape),
                m1=0.01 * rng.randn(*shape), m2=1e-4 * rng.rand(*shape))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    if dtype == "bfloat16":   # start from values bf16 holds exactly
        arrs = {k: np.asarray(_j(v, dtype), np.float32)
                for k, v in arrs.items()}
    return arrs


@pytest.mark.parametrize("path", ["reference", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip,coeff", [(None, 0.0), (0.37, 0.0),
                                        (None, 0.01), (2.5, 0.01)])
def test_fused_adam_plain_matches_jax(clip, coeff, dtype, path, monkeypatch):
    if path == "interpret":
        monkeypatch.setenv("PADDLE_TPU_KERNEL_INTERPRET", "1")
    else:
        monkeypatch.delenv("PADDLE_TPU_KERNEL_INTERPRET", raising=False)
    shape = (37, 129)
    a = _adam_inputs(shape, seed=int(coeff * 100) + (clip is not None), dtype=dtype)
    lr, b1p, b2p = 3e-3, 0.9 ** 3, 0.999 ** 3
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=coeff)
    p, g, m1, m2 = (_t(a[k], dtype) for k in ("p", "g", "m1", "m2"))
    f32 = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    before = K.fused_adam_update.launches
    K.fused_adam_update(p, g, m1, m2, f32(lr), f32(b1p), f32(b2p),
                        clip_scale=None if clip is None else f32(clip), **kw)
    assert K.fused_adam_update.launches == before     # plain on the CPU
    jp, jm1, jm2 = jfo.fused_adam_update(
        *(_j(a[k], dtype) for k in ("p", "g", "m1", "m2")),
        jnp.float32(lr), jnp.float32(b1p), jnp.float32(b2p),
        clip_scale=None if clip is None else jnp.float32(clip), **kw)
    for got, want in ((p, jp), (m1, jm1), (m2, jm2)):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   **TOL[dtype])


def test_fused_adam_plain_is_the_unfused_chain_bitwise():
    """In float32 the plain version equals the reference's unfused chain
    (_reference_adam) bit for bit on the CPU."""
    a = _adam_inputs((64, 33), seed=3, dtype="float32")
    p, g, m1, m2 = (_t(a[k]) for k in ("p", "g", "m1", "m2"))
    lr, b1p, b2p = 1e-3, 0.9 ** 2, 0.999 ** 2
    f32 = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    K.fused_adam_update(p, g, m1, m2, f32(lr), f32(b1p), f32(b2p),
                        clip_scale=f32(0.5), weight_decay=0.01)
    lr_t = jnp.float32(lr) * jnp.sqrt(1 - jnp.float32(b2p)) / (
        1 - jnp.float32(b1p))
    want = jfo._reference_adam(*(jnp.asarray(a[k]) for k in
                                 ("p", "g", "m1", "m2")),
                               lr_t, jnp.float32(lr), jnp.float32(0.5), 0.9,
                               0.999, 1e-8, 0.01)
    for got, w in zip((p, m1, m2), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-7)


def test_fused_adam_refuses_mismatched_inputs():
    p = torch.zeros(4, 4)
    one = torch.ones(1)
    with pytest.raises(ValueError, match="g"):
        K.fused_adam_update(p, torch.zeros(4, 5), p.clone(), p.clone(), one,
                            one, one)
    with pytest.raises(ValueError, match="lr"):
        K.fused_adam_update(p, p.clone(), p.clone(), p.clone(),
                            torch.ones(1, dtype=torch.float64), one, one)
