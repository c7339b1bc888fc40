"""The port's flash attention against the JAX package's, on the CPU.

On CPU tensors ``paddle_tpu_torch.kernels.flash_attention`` runs its
plain versions (the CUDA kernels' arithmetic in float32: the online
softmax's lse, the lse-based backward). They are held against
``paddle_tpu.kernels.flash_attention`` run as its own tests run it, the
Pallas kernels in interpret mode (``PADDLE_TPU_FLASH_INTERPRET=1``;
``PADDLE_TPU_FLASH_PANEL_MAX=128`` takes the streaming kernels, as
tests/test_flash_attention.py:23-24 and :283-284 do). Inputs come from
a numpy seed; the tolerances are the JAX tests' own: forward atol/rtol
2e-5, gradients 5e-4 (tests/test_flash_attention.py:37, :56).

Two cases where the JAX package is not self-consistent are avoided:
a fully masked row that is also causal (its streaming route skips the
blocks above the diagonal, its panel route does not), and a fully
masked row at an S that JAX pads (the zero-padded keys join the uniform
average). So fully masked rows are checked non-causally at S = 256,
which JAX does not pad; every causal masked case keeps key 0.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core.framework import unique_name as jax_unique_name
from paddle_tpu.kernels import flash_attention as jax_flash
from paddle_tpu.kernels import flash_attention_layer as jax_flash_layer

import paddle_tpu_torch as fluid
from paddle_tpu_torch.kernels import flash_attention_layer

TF = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-4, rtol=5e-4)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLASH_INTERPRET", "1")


@pytest.fixture
def stream(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLASH_INTERPRET", "1")
    monkeypatch.setenv("PADDLE_TPU_FLASH_PANEL_MAX", "128")


def _inputs(seed, B, H, S, D, masked=False, bias_shape=None, keep_first=True,
            dead_row=None):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, H, S, D).astype("float32") for _ in range(4))
    mask = bias = None
    if masked:
        keep = rng.rand(B, S) > 0.3
        if keep_first:
            keep[:, 0] = True
        if dead_row is not None:
            keep[dead_row] = False
        mask = keep
    if bias_shape is not None:
        bias = rng.randn(*bias_shape, S, S).astype("float32")
    return q, k, v, g, mask, bias


def _jax(q, k, v, g, mask, bias, causal):
    """o and the cotangents of (q, k, v[, bias]) for the cotangent g."""
    jm = None if mask is None else jnp.asarray(mask)
    args = [jnp.asarray(a) for a in (q, k, v)]
    if bias is not None:
        args.append(jnp.asarray(bias))

    def f(*a):
        b = a[3] if bias is not None else None
        return jax_flash(a[0], a[1], a[2], causal, None, mask=jm, bias=b)

    o, vjp = jax.vjp(f, *args)
    return np.asarray(o), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port(q, k, v, g, mask, bias, causal):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tb = None if bias is None else torch.tensor(bias, requires_grad=True)
    tm = None if mask is None else torch.tensor(mask)
    o = TF.flash_attention(*ts, causal=causal, mask=tm, bias=tb)
    leaves = ts + ([tb] if tb is not None else [])
    grads = torch.autograd.grad(o, leaves, torch.tensor(g))
    return o.detach().numpy(), [x.numpy() for x in grads]


def _compare(case, interpret_or_stream=None):
    q, k, v, g, mask, bias, causal = case
    jo, jg = _jax(q, k, v, g, mask, bias, causal)
    to, tg = _port(q, k, v, g, mask, bias, causal)
    np.testing.assert_allclose(to, jo, **FWD)
    assert len(tg) == len(jg)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), tg, jg):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,D", [(64, 16), (300, 64)])
def test_matches_jax_panel_route(interpret, S, D, causal, masked):
    """The panel kernels; S = 300 is padded to 512 by JAX and not by the
    port (bounds-checked tiles)."""
    q, k, v, g, mask, _ = _inputs(S + D, 2, 2, S, D, masked=masked)
    _compare((q, k, v, g, mask, None, causal))


@pytest.mark.parametrize("bias_shape", [(2, 3), (1, 3), (2, 1), (1, 1)])
def test_bias_and_dbias_match_jax(interpret, bias_shape):
    """The four bias shapes, with a mask: dbias comes back bias-shaped,
    summed over the broadcast dims."""
    q, k, v, g, mask, bias = _inputs(7, 2, 3, 128, 16, masked=True,
                                     bias_shape=bias_shape)
    _compare((q, k, v, g, mask, bias, False))


@pytest.mark.parametrize("causal", [False, True])
def test_matches_jax_streaming_route(stream, causal):
    """S = 384 > PANEL_MAX 128: JAX's FA-2 streaming kernels (K7/K9)."""
    q, k, v, g, mask, _ = _inputs(11, 1, 2, 384, 16, masked=True)
    _compare((q, k, v, g, mask, None, causal))


def test_fully_masked_row_matches_jax(interpret):
    """Batch row 1 has every key masked: its output is V's uniform
    average (NEG_INF is added, not -inf), and the lse-based backward
    gives the TPU kernel's gradients for it."""
    q, k, v, g, mask, _ = _inputs(5, 2, 2, 256, 16, masked=True,
                                  dead_row=1)
    to, _ = _port(q, k, v, g, mask, None, False)
    np.testing.assert_allclose(
        to[1], np.broadcast_to(v[1].mean(axis=1, keepdims=True), to[1].shape),
        **FWD)
    _compare((q, k, v, g, mask, None, False))


def test_plain_versions_agree_with_reference_attention():
    """The kernels' plain forward equals the reference's softmax
    attention, and their plain backward equals its autograd, with an
    additive mask and a broadcast bias."""
    q, k, v, g, mask, bias = _inputs(3, 2, 2, 96, 32, masked=True,
                                     bias_shape=(1, 2))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tb = torch.tensor(bias, requires_grad=True)
    tm = TF.normalize_mask(torch.tensor(mask), 2, 96)
    for causal in (False, True):
        o, lse = TF.flash_attention_fwd_plain(tq, tk, tv, tm, tb, 0.2, causal)
        ref = TF.flash_attention_plain(tq, tk, tv, causal, 0.2, tm, tb)
        torch.testing.assert_close(o, ref, **FWD)
        want = torch.autograd.grad(ref, (tq, tk, tv, tb), torch.tensor(g))
        got = TF.flash_attention_bwd_plain(tq, tk, tv, tm, tb, o, lse,
                                           torch.tensor(g), 0.2, causal)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_mask_forms_and_bias_validation():
    """bool and additive masks of shape [S], [B, S] and [B, 1, 1, S]
    normalize to one additive float32 [B, S]; a bias that is not
    [B|1, H|1, S, S] is refused."""
    keep = np.random.RandomState(0).rand(2, 8) > 0.5
    want = np.where(keep, 0.0, TF.NEG_INF).astype("float32")
    for m in (torch.tensor(keep), torch.tensor(want),
              torch.tensor(keep).reshape(2, 1, 1, 8)):
        np.testing.assert_array_equal(TF.normalize_mask(m, 2, 8).numpy(),
                                      want)
    row = TF.normalize_mask(torch.tensor(keep[0]), 2, 8)
    np.testing.assert_array_equal(row.numpy(), np.stack([want[0]] * 2))
    x = torch.zeros(2, 3, 8, 4)
    with pytest.raises(ValueError, match="bias must be"):
        TF.flash_attention(x, x, x, bias=torch.zeros(3, 3, 8, 8))


def test_no_lse_without_a_backward(monkeypatch):
    """Under no_grad (or with no input requiring a gradient) the forward
    writes no lse: the reference's with_lse=False inference path."""
    seen = []
    real = TF.flash_attention_fwd

    def spy(*a, **kw):
        o, lse = real(*a, **kw)
        seen.append(lse)
        return o, lse

    monkeypatch.setattr(TF, "flash_attention_fwd", spy)
    x = torch.randn(1, 2, 8, 4)
    TF.flash_attention(x, x, x)
    with torch.no_grad():
        TF.flash_attention(x.requires_grad_(), x, x)
    assert seen == [None, None]
    TF.flash_attention(x, x, x)
    assert seen[-1] is not None and tuple(seen[-1].shape) == (1, 2, 8)


def _op_program(pkg, unique, layer, mask_type):
    B, S, H, D = 2, 24, 2, 8
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), unique.guard():
        q, k, v = (pkg.layers.data(n, [S, H * D], stop_gradient=False)
                   for n in ("q", "k", "v"))
        m = pkg.layers.data("m", [S])
        out = layer(q, k, v, H, causal=False, mask_var=m,
                    mask_type=mask_type)
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(out, out))
        pkg.append_backward(loss)
    return main, out, loss


@pytest.mark.parametrize("mask_type", ["binary", "additive"])
def test_flash_op_through_executor_matches_jax(interpret, mask_type):
    """The flash_attention op ([B, S, H*D] in and out) and its automatic
    gradient through the port's Executor, against the JAX Executor."""
    rng = np.random.RandomState(4)
    feed = {n: rng.randn(2, 24, 16).astype("float32") for n in "qkv"}
    keep = rng.rand(2, 24) > 0.3
    keep[:, 0] = True
    feed["m"] = (keep.astype("float32") if mask_type == "binary"
                 else np.where(keep, 0.0, -1e30).astype("float32"))
    fetch = lambda out, loss: [out, loss, "q@GRAD", "k@GRAD", "v@GRAD"]  # noqa: E731
    jmain, jout, jloss = _op_program(jfluid, jax_unique_name,
                                     jax_flash_layer, mask_type)
    jres = jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed=feed, fetch_list=fetch(jout, jloss))
    tmain, tout, tloss = _op_program(fluid, fluid.unique_name,
                                     flash_attention_layer, mask_type)
    assert tmain.to_dict() == jmain.to_dict()
    tres = fluid.Executor(fluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=fetch(tout, tloss), scope=fluid.Scope())
    np.testing.assert_allclose(tres[0], np.asarray(jres[0]), **FWD)
    np.testing.assert_allclose(tres[1], np.asarray(jres[1]), **FWD)
    for a, b in zip(tres[2:], jres[2:]):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD)
