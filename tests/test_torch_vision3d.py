"""The ops of the imperative slice against the JAX package, on the CPU:
the 8 lowerings of ``ops/vision3d.py`` and ``prelu``, ``group_norm``,
``spectral_norm``, ``bilinear_tensor_product``, ``nce`` and
``tree_conv``, with their layer functions.

Each case is a one-op Program in both packages
(``test_torch_activations.both``), run through the Executors: forward
outputs within rtol 1e-5 / atol 1e-6, integer outputs exactly, and the
input gradients (of a weighted sum of every float output, through
``append_backward``) within rtol 1e-4 / atol 1e-5
(``test_torch_rnn.check_split``).

* ``test_op_sweep_rows``: the rows of tests/test_op_sweep.py's
  ``SPECS`` for these ops, imported from that file, with the row's
  inputs, attrs and gradient slots (``nce`` draws its negatives, so it
  has its own case).
* ``test_cases``: the vision3d ops and ``tree_conv``, which have no
  row there, at several strides, paddings and layouts.
* ``test_nce_from_its_own_samples``: JAX draws ``nce``'s negatives from
  its key and the port from its generator, so the port's cost and
  gradients are recomputed in numpy from the port's own SampleLabels by
  JAX's formula, and the draws must fall in range.
* ``test_adaptive_pool3d_is_adaptive``: a fault of the reference, not
  copied: JAX's ``pool3d`` ignores ``adaptive``.
* the layer functions (``layers.prelu``, ``layers.group_norm`` and the
  ``layers/auto.py`` rows over these ops) build the same Program as
  JAX's.
* ``test_every_imperative_op_has_a_parity_case``: a ratchet. Every op
  that ``ops/vision3d.py`` registers, and the six ops above, must have
  a case here.
"""

import numpy as np
import pytest

from test_op_sweep import SPECS
from test_torch_activations import both, run_op
from test_torch_rnn import check_split, f32

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
import paddle_tpu_torch.ops  # noqa: F401 (registers the lowerings)
from paddle_tpu.core.framework import unique_name as jax_unique_name
from paddle_tpu_torch.core.registry import _OP_REGISTRY, get_op_def

SIX = ["prelu", "group_norm", "spectral_norm", "bilinear_tensor_product",
       "nce", "tree_conv"]


def family_ops():
    mine = sorted(n for n, d in _OP_REGISTRY.items()
                  if not d.auto_grad
                  and d.lower.__module__ == "paddle_tpu_torch.ops.vision3d")
    return mine + SIX


SWEEP = sorted(n for n in family_ops() if n in SPECS and n != "nce")


def _outs(op_type, n_out=None):
    outs = {s: 1 for s in get_op_def(op_type).output_slots}
    outs.update(n_out or {})
    return outs


@pytest.mark.parametrize("name", SWEEP)
def test_op_sweep_rows(name):
    row = SPECS[name]
    j, t = both(name, row["inputs"], row["attrs"],
                _outs(name, row["n_out"]), grads=tuple(row["grads"]))
    check_split(j, t)


EDGES = np.array([[[0, 1], [0, 2], [0, 3], [2, 4], [0, 0]],
                  [[0, 1], [1, 2], [1, 3], [3, 4], [3, 5]]], np.int32)

CASES = {
    "conv3d": ("conv3d", {"Input": f32(2, 3, 5, 5, 5), "Filter":
                          f32(4, 3, 3, 3, 3, seed=1)},
               {"strides": [1, 1, 1], "paddings": [1, 1, 1]},
               ("Input", "Filter")),
    "conv3d_strided_groups_bias": (
        "conv3d", {"Input": f32(1, 4, 6, 5, 7), "Filter":
                   f32(6, 2, 3, 2, 3, seed=1), "Bias": f32(6, seed=2)},
        {"strides": [2, 1, 2], "paddings": [1, 0, 1],
         "dilations": [1, 2, 1], "groups": 2}, ("Input", "Filter", "Bias")),
    "conv3d_ndhwc": ("conv3d", {"Input": f32(1, 4, 4, 4, 3), "Filter":
                                f32(2, 3, 2, 2, 2, seed=1)},
                     {"data_format": "NDHWC", "paddings": [1, 1, 1]},
                     ("Input", "Filter")),
    "conv3d_transpose": ("conv3d_transpose",
                         {"Input": f32(1, 2, 3, 3, 3),
                          "Filter": f32(2, 3, 3, 3, 3, seed=1),
                          "Bias": f32(3, seed=2)},
                         {"strides": [2, 2, 2], "paddings": [1, 1, 1]},
                         ("Input", "Filter", "Bias")),
    "conv3d_transpose_dilated": ("conv3d_transpose",
                                 {"Input": f32(1, 2, 3, 4, 3),
                                  "Filter": f32(2, 2, 2, 3, 2, seed=1)},
                                 {"strides": [1, 2, 1],
                                  "dilations": [2, 1, 2]},
                                 ("Input", "Filter")),
    "depthwise_conv2d_transpose": ("depthwise_conv2d_transpose",
                                   {"Input": f32(2, 3, 4, 5),
                                    "Filter": f32(3, 1, 3, 3, seed=1),
                                    "Bias": f32(3, seed=2)},
                                   {"strides": [2, 2], "paddings": [1, 1]},
                                   ("Input", "Filter", "Bias")),
    "pool3d_avg": ("pool3d", {"X": f32(2, 3, 4, 4, 4)},
                   {"pooling_type": "avg", "ksize": [2, 2, 2],
                    "strides": [2, 2, 2]}, ("X",)),
    "pool3d_avg_padded_exclusive": ("pool3d", {"X": f32(1, 2, 5, 4, 5)},
                                    {"pooling_type": "avg",
                                     "ksize": [3, 3, 3],
                                     "strides": [2, 1, 2],
                                     "paddings": [1, 1, 1]}, ("X",)),
    "pool3d_avg_padded_inclusive": ("pool3d", {"X": f32(1, 2, 5, 4, 5)},
                                    {"pooling_type": "avg",
                                     "ksize": [3, 3, 3],
                                     "strides": [2, 1, 2],
                                     "paddings": [1, 1, 1],
                                     "exclusive": False}, ("X",)),
    "pool3d_max_padded": ("pool3d", {"X": f32(1, 2, 5, 4, 5)},
                          {"pooling_type": "max", "ksize": [3, 2, 3],
                           "strides": [2, 2, 1], "paddings": [1, 1, 1]},
                          ("X",)),
    "pool3d_global_ndhwc": ("pool3d", {"X": f32(2, 3, 4, 2, 5)},
                            {"pooling_type": "avg", "global_pooling": True,
                             "data_format": "NDHWC"}, ("X",)),
    "max_pool2d_with_index": ("max_pool2d_with_index", {"X": f32(2, 3, 6, 5)},
                              {"ksize": [2, 2], "strides": [2, 2]}, ("X",)),
    "max_pool2d_with_index_padded": ("max_pool2d_with_index",
                                     {"X": f32(1, 2, 5, 5)},
                                     {"ksize": [3, 3], "strides": [2, 2],
                                      "paddings": [1, 1]}, ("X",)),
    "max_pool2d_with_index_global": ("max_pool2d_with_index",
                                     {"X": f32(1, 2, 3, 4)},
                                     {"global_pooling": True}, ("X",)),
    "max_pool3d_with_index": ("max_pool3d_with_index",
                              {"X": f32(1, 2, 4, 4, 4)},
                              {"ksize": [2, 2, 2], "strides": [2, 2, 2]},
                              ("X",)),
    "max_pool3d_with_index_padded": ("max_pool3d_with_index",
                                     {"X": f32(1, 2, 5, 3, 4)},
                                     {"ksize": [3, 2, 3],
                                      "strides": [2, 1, 2],
                                      "paddings": [1, 1, 1]}, ("X",)),
    "unpool": ("unpool", {"X": f32(1, 2, 2, 3),
                          "Indices": np.array([[[[0, 3, 5], [13, 14, 23]],
                                                [[1, 2, 10], [12, 20, 22]]]],
                                              np.int32)},
               {"ksize": [2, 2], "strides": [2, 2]}, ("X",)),
    "unpool_repeated_index": ("unpool",
                              {"X": f32(1, 1, 2, 2),
                               "Indices": np.array([[[[5, 5], [0, 15]]]],
                                                   np.int32)},
                              {"ksize": [2, 2], "strides": [2, 2]}, ("X",)),
    "trilinear_interp": ("trilinear_interp", {"X": f32(1, 2, 2, 3, 2)},
                         {"out_d": 4, "out_h": 5, "out_w": 3}, ("X",)),
    "trilinear_interp_half_pixel": ("trilinear_interp",
                                    {"X": f32(2, 1, 3, 4, 2)},
                                    {"out_d": 5, "out_h": 3, "out_w": 4,
                                     "align_corners": False}, ("X",)),
    "prelu_channel": ("prelu", {"X": f32(2, 3, 4, 4),
                                "Alpha": f32(3, seed=1)},
                      {"mode": "channel"}, ("X", "Alpha")),
    "prelu_element": ("prelu", {"X": f32(2, 3, 4),
                                "Alpha": f32(1, 3, 4, seed=1)},
                      {"mode": "element"}, ("X", "Alpha")),
    "group_norm_nhwc_scale_bias": ("group_norm",
                                   {"X": f32(2, 3, 3, 6),
                                    "Scale": f32(6, seed=1),
                                    "Bias": f32(6, seed=2)},
                                   {"groups": 3, "data_layout": "NHWC"},
                                   ("X", "Scale", "Bias")),
    "spectral_norm_dim1_grad": ("spectral_norm",
                                {"Weight": f32(3, 4, 2), "U": f32(4, seed=1),
                                 "V": f32(6, seed=2)},
                                {"dim": 1, "power_iters": 3}, ("Weight",)),
    "tree_conv": ("tree_conv", {"NodesVector": f32(2, 6, 4),
                                "EdgeSet": EDGES,
                                "Filter": f32(4, 5, 3, seed=1)},
                  {}, ("NodesVector", "Filter")),
    "tree_conv_relu": ("tree_conv", {"NodesVector": f32(2, 6, 4),
                                     "EdgeSet": EDGES,
                                     "Filter": f32(4, 5, 3, seed=1)},
                       {"act": "relu"}, ("NodesVector", "Filter")),
}


INDEX_POOLS = {"max_pool2d_with_index": "pool2d",
               "max_pool3d_with_index": "pool3d"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cases(case):
    op_type, inputs, attrs, grads = CASES[case]
    if op_type not in INDEX_POOLS:
        j, t = both(op_type, inputs, attrs, _outs(op_type), grads=grads)
        check_split(j, t)
        return
    # JAX cannot differentiate its index pools (a reduce_window over a
    # (value, index) pair has no JVP): their forward is held to JAX's,
    # their X@GRAD to the gradient of JAX's max pool over the same
    # windows, whose output they share
    j, t = both(op_type, inputs, attrs, _outs(op_type))
    check_split(j, t)
    jp = run_op(jfluid, INDEX_POOLS[op_type], inputs,
                dict(attrs, pooling_type="max"), {"Out": 1}, grads=grads)
    np.testing.assert_array_equal(jp["o_Out_0"], j["o_Out_0"])
    tg = run_op(fluid, op_type, inputs, attrs, _outs(op_type), grads=grads,
                out_arrays={n: j[n] for n in j})
    np.testing.assert_allclose(tg["X_0@GRAD"], jp["X_0@GRAD"], rtol=1e-4,
                               atol=1e-5)


def _nce_oracle(x, w, b, cls, seed=0):
    """JAX's ``nce`` formula (``paddle_tpu/ops/nn.py:1036-1067``) on given
    sampled classes: the logits, the cost, and the gradients of
    ``run_op``'s loss, sum(wc * cost) + sum(wl * logits), whose weights
    wc, wl are its draws from ``RandomState(seed)`` in fetch order."""
    logits = np.einsum("bd,bkd->bk", x, w[cls]) + b.reshape(-1)[cls]
    labels = np.zeros_like(logits)
    labels[:, 0] = 1
    cost = (np.logaddexp(logits, 0) - labels * logits).sum(1, keepdims=True)
    rng = np.random.RandomState(seed)
    wc = rng.randn(*cost.shape).astype(np.float32)
    wl = rng.randn(*logits.shape).astype(np.float32)
    dl = wc * (1 / (1 + np.exp(-logits)) - labels) + wl
    dx = np.einsum("bk,bkd->bd", dl, w[cls])
    dw = np.zeros_like(w)
    np.add.at(dw, cls, dl[..., None] * x[:, None, :])
    return logits, cost, dx, dw


def test_nce_from_its_own_samples():
    C, neg = 10, 3
    inputs = dict(SPECS["nce"]["inputs"])
    x, w, b = inputs["Input"], inputs["Weight"], inputs["Bias"]
    outs = _outs("nce")
    t = run_op(fluid, "nce", inputs, {"num_neg_samples": neg}, outs,
               grads=("Input", "Weight"))
    cls = t["o_SampleLabels_0"]
    assert cls.dtype == np.int64 and cls.shape == (4, 1 + neg)
    assert cls.min() >= 0 and cls.max() < C
    np.testing.assert_array_equal(cls[:, 0], inputs["Label"].reshape(-1))
    logits, cost, dx, dw = _nce_oracle(x, w, b, cls)
    np.testing.assert_allclose(t["o_SampleLogits_0"], logits, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t["o_Cost_0"], cost, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t["Input_0@GRAD"], dx, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t["Weight_0@GRAD"], dw, rtol=1e-4, atol=1e-5)
    # JAX's own run, held to the same formula on its own samples
    j = run_op(jfluid, "nce", inputs, {"num_neg_samples": neg}, outs,
               grads=("Input", "Weight"))
    jl, jc, jdx, jdw = _nce_oracle(x, w, b, j["o_SampleLabels_0"])
    np.testing.assert_allclose(j["o_Cost_0"], jc, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(j["Input_0@GRAD"], jdx, rtol=1e-4, atol=1e-5)


def test_adaptive_pool3d_is_adaptive():
    """A fault of the reference, not copied: JAX's pool3d ignores
    ``adaptive``, so ``adaptive_pool3d(x, ksize=[1, 2, 1])`` pools 1x2x1
    windows at stride 2 there; the port gives the [1, 2, 1] output."""
    x = f32(1, 2, 4, 4, 6)
    attrs = {"pooling_type": "avg", "ksize": [1, 2, 1], "adaptive": True}
    j = run_op(jfluid, "pool3d", {"X": x}, attrs)["o_Out_0"]
    t = run_op(fluid, "pool3d", {"X": x}, attrs)["o_Out_0"]
    np.testing.assert_allclose(j, x[:, :, ::2, 0:4:2, ::2] * 0.5
                               + x[:, :, ::2, 1:4:2, ::2] * 0.5, rtol=1e-6)
    want = x.reshape(1, 2, 1, 4, 2, 2, 1, 6).mean(axis=(3, 5, 7))
    np.testing.assert_allclose(t, want, rtol=1e-5, atol=1e-6)
    assert t.shape == (1, 2, 1, 2, 1) and j.shape != t.shape


def _layer_program(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    names = jax_unique_name if pkg is jfluid else fluid.unique_name
    with pkg.program_guard(main, startup), names.guard():
        build(pkg)
    return main


LAYERS = {
    "prelu_all": lambda L: L.prelu(L.data("x", [3, 4, 4]), mode="all"),
    "prelu_channel": lambda L: L.prelu(L.data("x", [3, 4, 4]),
                                       mode="channel"),
    "prelu_element": lambda L: L.prelu(L.data("x", [3, 4]), mode="element"),
    "group_norm": lambda L: L.group_norm(L.data("x", [4, 3, 3]), 2,
                                         act="relu"),
    "conv3d": lambda L: L.conv3d(L.data("x", [2, 4, 4, 4]),
                                 L.data("w", [3, 2, 3, 3, 3],
                                        append_batch_size=False),
                                 paddings=[1, 1, 1]),
    "conv3d_transpose": lambda L: L.conv3d_transpose(
        L.data("x", [2, 3, 3, 3]),
        L.data("w", [2, 3, 2, 2, 2], append_batch_size=False),
        strides=[2, 2, 2]),
    "pool3d": lambda L: L.pool3d(L.data("x", [2, 4, 4, 4]),
                                 pooling_type="avg"),
    "adaptive_pool3d": lambda L: L.adaptive_pool3d(L.data("x", [2, 4, 4, 4]),
                                                   ksize=[2, 2, 2]),
    "resize_trilinear": lambda L: L.resize_trilinear(
        L.data("x", [2, 2, 3, 2]), out_d=4, out_h=6, out_w=4),
    "spectral_norm": lambda L: L.spectral_norm(
        L.data("w", [4, 6], append_batch_size=False),
        L.data("u", [4], append_batch_size=False),
        L.data("v", [6], append_batch_size=False), power_iters=2),
    "bilinear_tensor_product": lambda L: L.bilinear_tensor_product(
        L.data("x", [3]), L.data("y", [4]),
        L.data("w", [2, 3, 4], append_batch_size=False)),
    "nce": lambda L: L.nce(L.data("x", [6]), L.data("l", [1], dtype="int64"),
                           L.data("w", [10, 6], append_batch_size=False),
                           num_total_classes=10, num_neg_samples=3),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_functions_build_jax_programs(name):
    build = LAYERS[name]
    j = _layer_program(jfluid, lambda pkg: build(pkg.layers))
    t = _layer_program(fluid, lambda pkg: build(pkg.layers))
    jd, td = j.to_dict(), t.to_dict()
    for b in jd["blocks"] + td["blocks"]:
        for op in b["ops"]:
            op["attrs"].pop("op_ident", None)
            op["attrs"].pop("op_callstack", None)
    assert td["blocks"][0]["ops"] == jd["blocks"][0]["ops"]
    # JAX runs without x64: the int64 it infers (nce's SampleLabels)
    # arrives as int32
    for v in td["blocks"][0]["vars"]:
        if v["dtype"] == "int64" and v["name"] == "nce_0.tmp_2":
            v["dtype"] = "int32"
    assert td["blocks"][0]["vars"] == jd["blocks"][0]["vars"]


def test_every_imperative_op_has_a_parity_case():
    covered = set(SWEEP) | {c[0] for c in CASES.values()} | {"nce"}
    missing = sorted(set(family_ops()) - covered)
    assert not missing, f"registered without a parity case: {missing}"
    assert len(family_ops()) == 14
