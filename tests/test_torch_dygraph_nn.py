"""Every ``dygraph.nn`` class of the port against the JAX package's, on
the CPU: forward and backward on the same inputs, the port's layer
holding the JAX layer's values (``set_dict(jax_layer.state_dict())``).

The loss is the sum of every float output times a fixed random weight
of its shape (``_loss``), so each element carries its own cotangent.
Forward outputs within rtol 1e-5 / atol 1e-6, gradients (of the
parameters and the float inputs) within rtol 1e-4 / atol 1e-5; integer
outputs exactly.

* the 12 cases of tests/test_dygraph_nn2.py, under their names, held
  to JAX;
* ``test_every_class_forward_and_backward``: all 19 classes. ``Dropout``
  is held at p = 0 and in eval mode (its mask draws differ between the
  packages); ``BatchNorm`` in train and eval mode.
* ``NCE`` draws its negatives from its own generator (JAX from its own
  key, ``paddle_tpu/ops/nn.py:1044-1046``): its cost and gradients are
  recomputed in numpy from the port's own SampleLabels by JAX's formula,
  and the draws must fall in range.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.dygraph as jdg
from paddle_tpu.dygraph.base import _trace as jtrace

import paddle_tpu_torch as fluid
import paddle_tpu_torch.dygraph as dg
from paddle_tpu_torch.dygraph.base import _trace

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5

SIDES = {"jax": (jdg, jtrace, lambda: jfluid.core.dygraph.dygraph_guard()),
         "torch": (dg, _trace, lambda: dg.guard(fluid.CPUPlace()))}


def f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _loss(dgm, trace, outs):
    total = None
    for k, o in enumerate(outs):
        if o.dtype not in ("float32", "float64"):
            continue
        w = dgm.to_variable(f32(*o.shape, seed=100 + k))
        w.stop_gradient = True
        s = trace("reduce_sum", {"X": [o * w]}, ["Out"],
                  {"reduce_all": True})[0]
        total = s if total is None else total + s
    return total


def run(side, build, inputs, state=None, mode="train", grads=True):
    """(outputs, {name: gradient}, the layer's initial state_dict)."""
    dgm, trace, guard = SIDES[side]
    with guard():
        layer = build(dgm)
        if state is not None:
            layer.set_dict(state)
        init = layer.state_dict()
        getattr(layer, mode)()
        xs = [dgm.to_variable(a) for a in inputs]
        for x in xs:
            if np.asarray(x.numpy()).dtype.kind == "f":
                x.stop_gradient = False
        out = layer(*xs)
        outs = list(out) if isinstance(out, tuple) else [out]
        got = {}
        if grads:
            _loss(dgm, trace, outs).backward()
            got = {k: p.gradient for k, p in layer.named_parameters()
                   if p.gradient is not None}
            got.update({f"x{i}": x.gradient for i, x in enumerate(xs)
                        if x.gradient is not None})
        return [o.numpy() for o in outs], got, init


def held(build, inputs, mode="train", grads=True):
    """Run both packages from JAX's initial values and compare."""
    j_outs, j_grads, init = run("jax", build, inputs, mode=mode, grads=grads)
    t_outs, t_grads, _ = run("torch", build, inputs, state=init, mode=mode,
                             grads=grads)
    assert len(t_outs) == len(j_outs)
    for k, (a, b) in enumerate(zip(t_outs, j_outs)):
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"output {k}")
    assert sorted(t_grads) == sorted(j_grads)
    for k in j_grads:
        np.testing.assert_allclose(t_grads[k], j_grads[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    return t_outs, t_grads


rng = np.random.RandomState(4)


# -- the 12 cases of tests/test_dygraph_nn2.py -------------------------------


def test_conv2d_transpose_forward_backward():
    outs, grads = held(lambda m: m.nn.Conv2DTranspose(3, 5, 3),
                       [f32(2, 3, 6, 6)])
    assert outs[0].shape[1] == 5 and "weight" in grads


def test_conv3d_forward_backward():
    outs, grads = held(lambda m: m.nn.Conv3D(2, 4, 3, padding=1),
                       [f32(1, 2, 5, 5, 5)])
    assert outs[0].shape == (1, 4, 5, 5, 5) and "weight" in grads


def test_conv3d_transpose_forward():
    outs, _ = held(lambda m: m.nn.Conv3DTranspose(2, 3, 1),
                   [f32(1, 2, 4, 4, 4)])
    assert outs[0].shape[1] == 3


def test_gru_unit_step():
    outs, _ = held(lambda m: m.nn.GRUUnit(12), [f32(2, 12),
                                               np.zeros((2, 4), "float32")])
    assert outs[0].shape == (2, 4)


def test_prelu_modes():
    for mode, kw in (("all", {}), ("channel", {"channel": 3})):
        outs, _ = held(lambda m: m.nn.PRelu(mode=mode, **kw),
                       [f32(2, 3, 4, 4)])
        assert outs[0].shape == (2, 3, 4, 4)


def test_bilinear_tensor_product():
    outs, grads = held(lambda m: m.nn.BilinearTensorProduct(3, 4, 5),
                       [f32(2, 3), f32(2, 4, seed=1)])
    assert outs[0].shape == (2, 5) and "weight" in grads


def test_sequence_conv():
    outs, _ = held(lambda m: m.nn.SequenceConv(num_filters=6, filter_size=3,
                                               input_dim=4), [f32(2, 5, 4)])
    assert outs[0].shape == (2, 5, 6)


def test_row_conv():
    outs, _ = held(lambda m: m.nn.RowConv(4, future_context_size=2),
                   [f32(2, 6, 4)])
    assert outs[0].shape == (2, 6, 4)


def test_group_norm():
    outs, _ = held(lambda m: m.nn.GroupNorm(4, groups=2), [f32(2, 4, 3, 3)])
    assert outs[0].shape == (2, 4, 3, 3)
    assert abs(float(outs[0].mean())) < 0.2


def test_spectral_norm():
    outs, _ = held(lambda m: m.nn.SpectralNorm([6, 4], power_iters=2),
                   [f32(6, 4)])
    assert np.linalg.svd(outs[0], compute_uv=False)[0] < 2.0


def test_tree_conv():
    outs, _ = held(lambda m: m.nn.TreeConv(4, 5),
                   [f32(1, 3, 4), np.array([[[0, 1], [0, 2]]], "int32")])
    assert outs[0].shape == (1, 3, 5)


def _nce_oracle(x, w, b, cls):
    """JAX's ``nce`` formula on given sampled classes: the cost and the
    gradients of its sum."""
    logits = np.einsum("bd,bkd->bk", x, w[cls]) + b.reshape(-1)[cls]
    labels = np.zeros_like(logits)
    labels[:, 0] = 1
    cost = (np.logaddexp(logits, 0) - labels * logits).sum(1, keepdims=True)
    dl = 1 / (1 + np.exp(-logits)) - labels
    dx = np.einsum("bk,bkd->bd", dl, w[cls])
    dw = np.zeros_like(w)
    np.add.at(dw, cls, dl[..., None] * x[:, None, :])
    db = np.zeros(w.shape[0], np.float32)
    np.add.at(db, cls, dl)
    return cost, dx, dw, db


def test_nce_loss():
    x0 = f32(3, 6)
    lbl = rng.randint(0, 20, (3, 1)).astype("int64")
    with jfluid.core.dygraph.dygraph_guard():
        jl = jdg.nn.NCE(num_total_classes=20, dim=6, num_neg_samples=4)
        jcost = jl(jdg.to_variable(x0), jdg.to_variable(lbl))
        assert np.all(np.isfinite(jcost.numpy()))
        init = jl.state_dict()
    with dg.guard(fluid.CPUPlace()):
        layer = dg.nn.NCE(num_total_classes=20, dim=6, num_neg_samples=4)
        layer.set_dict(init)
        x = dg.to_variable(x0)
        x.stop_gradient = False
        # the layer's own op, with the sampled classes kept
        cost, _, cls = _trace(
            "nce", {"Input": [x], "Label": [dg.to_variable(lbl)],
                    "Weight": [layer.weight], "Bias": [layer.bias]},
            ["Cost", "SampleLogits", "SampleLabels"], dict(layer._attrs))
        _trace("reduce_sum", {"X": [cost]}, ["Out"],
               {"reduce_all": True})[0].backward()
        c = cls.numpy()
        assert c.dtype == np.int64 and c.shape == (3, 5)
        assert c.min() >= 0 and c.max() < 20
        np.testing.assert_array_equal(c[:, 0], lbl.reshape(-1))
        want = _nce_oracle(x0, init["weight"], init["bias"], c)
        for got, w, tol in ((cost.numpy(), want[0], (RTOL, ATOL)),
                            (x.gradient, want[1], (GRAD_RTOL, GRAD_ATOL)),
                            (layer.weight.gradient, want[2],
                             (GRAD_RTOL, GRAD_ATOL)),
                            (layer.bias.gradient.reshape(-1), want[3],
                             (GRAD_RTOL, GRAD_ATOL))):
            np.testing.assert_allclose(got, w, rtol=tol[0], atol=tol[1])
        # the layer's forward returns that op's cost
        assert layer(x, dg.to_variable(lbl)).shape == (3, 1)


# -- every class ---------------------------------------------------------------


CLASSES = {
    "Linear": (lambda m: m.Linear(3, 2, act="relu"), [f32(4, 3)], "train"),
    "Linear_3d": (lambda m: m.Linear(3, 2), [f32(2, 4, 3)], "train"),
    "Conv2D": (lambda m: m.Conv2D(3, 4, 3, stride=2, padding=1, act="relu"),
               [f32(2, 3, 7, 7)], "train"),
    "Conv2D_groups": (lambda m: m.Conv2D(4, 6, 3, groups=2, dilation=2,
                                         bias_attr=False), [f32(1, 4, 8, 8)],
                      "train"),
    "Pool2D_max": (lambda m: m.Pool2D(3, "max", 2, 1), [f32(2, 3, 7, 7)],
                   "train"),
    "Pool2D_avg_global": (lambda m: m.Pool2D(2, "avg", global_pooling=True),
                          [f32(2, 3, 5, 4)], "train"),
    "BatchNorm_train": (lambda m: m.BatchNorm(3, act="relu"),
                        [f32(4, 3, 5, 5)], "train"),
    "BatchNorm_eval": (lambda m: m.BatchNorm(3), [f32(4, 3, 5, 5)], "eval"),
    "Embedding": (lambda m: m.Embedding([10, 4], padding_idx=2),
                  [np.array([[1, 2, 3], [9, 0, 2]], "int64")], "train"),
    "LayerNorm": (lambda m: m.LayerNorm([3, 4], act="tanh"),
                  [f32(2, 3, 4)], "train"),
    "Dropout_p0": (lambda m: m.Dropout(p=0.0), [f32(2, 5)], "train"),
    "Dropout_eval": (lambda m: m.Dropout(p=0.3), [f32(2, 5)], "eval"),
    "Dropout_eval_upscale": (lambda m: m.Dropout(
        p=0.3, dropout_implementation="upscale_in_train"), [f32(2, 5)],
        "eval"),
    "Conv2DTranspose": (lambda m: m.nn.Conv2DTranspose(3, 4, 3, stride=2,
                                                       padding=1),
                        [f32(2, 3, 4, 4)], "train"),
    "Conv3D": (lambda m: m.nn.Conv3D(2, 3, 2, stride=2, act="relu"),
               [f32(1, 2, 4, 4, 4)], "train"),
    "Conv3DTranspose": (lambda m: m.nn.Conv3DTranspose(2, 3, 2, stride=2),
                        [f32(1, 2, 3, 3, 3)], "train"),
    "GRUUnit": (lambda m: m.nn.GRUUnit(12), [f32(3, 12), f32(3, 4, seed=1)],
                "train"),
    "PRelu_element": (lambda m: m.nn.PRelu(mode="element",
                                           input_shape=[2, 3, 4]),
                      [f32(2, 3, 4)], "train"),
    "BilinearTensorProduct": (lambda m: m.nn.BilinearTensorProduct(
        3, 4, 5, act="sigmoid"), [f32(2, 3), f32(2, 4, seed=1)], "train"),
    "SequenceConv": (lambda m: m.nn.SequenceConv(
        num_filters=3, filter_size=2, context_start=0, input_dim=4,
        act="tanh"), [f32(2, 5, 4)], "train"),
    "RowConv": (lambda m: m.nn.RowConv(4, future_context_size=1, act="relu"),
                [f32(2, 6, 4)], "train"),
    "GroupNorm": (lambda m: m.nn.GroupNorm(6, groups=3, act="relu"),
                  [f32(2, 6, 2, 3)], "train"),
    "SpectralNorm": (lambda m: m.nn.SpectralNorm([3, 4, 2], dim=1),
                     [f32(3, 4, 2)], "train"),
    "TreeConv": (lambda m: m.nn.TreeConv(4, 5, act="relu"),
                 [f32(2, 5, 4), np.array([[[0, 1], [0, 2], [1, 3], [1, 4]],
                                          [[0, 1], [1, 2], [2, 3], [0, 4]]],
                                         "int32")], "train"),
}


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_every_class_forward_and_backward(name):
    build, inputs, mode = CLASSES[name]
    outs, grads = held(build, inputs, mode)
    assert grads, name


def test_every_class_has_a_case():
    """The 19 classes of JAX's dygraph/nn.py: each has a case here (NCE
    in ``test_nce_loss``)."""
    covered = {n.split("_")[0] for n in CLASSES} | {"NCE"}
    classes = {n for n in dir(jdg.nn) if isinstance(getattr(jdg.nn, n), type)
               and issubclass(getattr(jdg.nn, n), jdg.Layer)
               and n not in ("Layer", "FC")}
    assert len(classes) == 19
    assert classes <= covered, sorted(classes - covered)
