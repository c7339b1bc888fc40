"""The inference fusions of ``ops/fused.py`` and ``contrib.layers``
against the JAX package, on the CPU.

Each of the 10 lowerings runs as a one-op Program in both packages on
the same seeded inputs (``test_torch_activations.both``): outputs
within rtol 1e-5 / atol 1e-6, the gradients of a seeded weighted sum of
the outputs within rtol 2e-4 / atol 2e-5 (float32 reductions in another
order). The 11 ``contrib.layers`` functions and ``ctr_metric_bundle``
build JAX's Programs, and the ones over deterministic ops run to JAX's
values.
"""

import numpy as np
import pytest

from test_torch_activations import (ATOL, RTOL, TRAIN_ATOL, TRAIN_RTOL,
                                    both, check)
from test_torch_layer_surface import _build, _d, _norm

import paddle_tpu as jfluid
import paddle_tpu.contrib.layers as jax_contrib_layers
import paddle_tpu_torch as fluid
import paddle_tpu_torch.contrib.layers as port_contrib_layers


def _f(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _check_both(op, inputs, attrs, outs, grads=()):
    j, t = both(op, inputs, attrs, outs, grads)
    fwd = {n for n in j if not n.endswith("@GRAD")}
    check({n: j[n] for n in fwd}, {n: t[n] for n in fwd}, RTOL, ATOL)
    if grads:
        g = set(j) - fwd
        check({n: j[n] for n in g}, {n: t[n] for n in g}, TRAIN_RTOL,
              TRAIN_ATOL)


FC = {
    "relu": ({"Input": _f(4, 6), "W": _f(6, 5, seed=1), "Bias": _f(5, seed=2)},
             {"in_num_col_dims": 1, "activation_type": "relu"}),
    "gelu_tanh": ({"Input": _f(4, 6), "W": _f(6, 5, seed=1),
                   "Bias": _f(5, seed=2)},
                  {"in_num_col_dims": 1, "activation_type": "gelu"}),
    "high_rank": ({"Input": _f(2, 3, 6), "W": _f(6, 5, seed=1)},
                  {"in_num_col_dims": 2}),
}


@pytest.mark.parametrize("case", sorted(FC))
def test_fc(case):
    ins, attrs = FC[case]
    _check_both("fc", ins, attrs, {"Out": 1}, grads=tuple(ins))


ELEMWISE = {
    "relu_add": {"functor_list": ["relu", "elementwise_add"]},
    "mul_tanh": {"functor_list": ["elementwise_mul", "tanh"]},
    "add_scale_zero": {"functor_list": ["elementwise_add", "scale"],
                       "scale": 0.0},
    "scale_sub_default": {"functor_list": ["scale", "elementwise_sub"]},
    "gelu_add": {"functor_list": ["gelu", "elementwise_add"]},
    "add_sigmoid": {"functor_list": ["elementwise_add", "sigmoid"]},
}


@pytest.mark.parametrize("case", sorted(ELEMWISE))
def test_fused_elemwise_activation(case):
    _check_both("fused_elemwise_activation",
                {"X": _f(3, 4), "Y": _f(3, 4, seed=1)}, ELEMWISE[case],
                {"Out": 1, "IntermediateOut": 1}, grads=("X", "Y"))


@pytest.mark.parametrize("act", ["", "relu"])
def test_fused_fc_elementwise_layernorm(act):
    ins = {"X": _f(6, 8), "W": _f(8, 5, seed=1), "Bias0": _f(5, seed=2),
           "Y": _f(6, 5, seed=3), "Scale": _f(5, seed=4),
           "Bias1": _f(5, seed=5)}
    _check_both("fused_fc_elementwise_layernorm", ins,
                {"begin_norm_axis": 1, "epsilon": 1e-5,
                 "activation_type": act},
                {"Out": 1, "Mean": 1, "Variance": 1},
                grads=("X", "W", "Bias0", "Y", "Scale", "Bias1"))


@pytest.mark.parametrize("is_test", [False, True])
def test_fused_batch_norm_act(is_test):
    ins = {"X": _f(4, 3, 5, 5), "Scale": _f(3, seed=1),
           "Bias": _f(3, seed=2), "Mean": _f(3, seed=3),
           "Variance": np.abs(_f(3, seed=4)) + 0.5}
    attrs = {"epsilon": 1e-5, "momentum": 0.9, "is_test": is_test,
             "act_type": "relu"}
    outs = {"Y": 1, "MeanOut": 1, "VarianceOut": 1, "SavedMean": 1,
            "SavedVariance": 1}
    _check_both("fused_batch_norm_act", ins, attrs, outs)
    if not is_test:
        # the gradients through Y (nothing differentiates the running
        # statistics: the port computes them without a graph)
        _check_both("fused_batch_norm_act", ins, attrs, {"Y": 1},
                    grads=("X", "Scale", "Bias"))
    j, t = both("fused_batch_norm_act", ins, attrs,
                dict(outs, ReserveSpace=1))
    assert t["o_ReserveSpace_0"].shape == j["o_ReserveSpace_0"].shape == (0,)


def test_fusion_repeated_fc_relu():
    ins = {"X": _f(4, 6), "W": [_f(6, 5, seed=1), _f(5, 3, seed=2)],
           "Bias": [_f(5, seed=3), _f(3, seed=4)]}
    _check_both("fusion_repeated_fc_relu", ins, {},
                {"ReluOut": 1, "Out": 1}, grads=("X", "W", "Bias"))


def test_fusion_squared_mat_sub():
    _check_both("fusion_squared_mat_sub",
                {"X": _f(3, 4), "Y": _f(4, 5, seed=1)}, {"scalar": 0.5},
                {"SquaredX": 1, "SquaredY": 1, "SquaredXY": 1, "Out": 1},
                grads=("X", "Y"))


@pytest.mark.parametrize("concat_axis", [1, 2])
def test_fusion_transpose_flatten_concat(concat_axis):
    ins = {"X": [_f(2, 3, 4, 5), _f(2, 3, 4, 5, seed=1)]}
    _check_both("fusion_transpose_flatten_concat", ins,
                {"trans_axis": [0, 2, 3, 1], "flatten_axis": 1,
                 "concat_axis": concat_axis}, {"Out": 1}, grads=("X",))


@pytest.mark.parametrize("mask", ["none", "key_mask", "full"])
def test_multihead_matmul(mask):
    B, S, N, H = 2, 5, 2, 3
    ins = {"Input": _f(B, S, N * H * 2), "W": _f(N * H * 2, 3, N, H, seed=1,
                                                 scale=0.3),
           "Bias": _f(3, N, H, seed=2)}
    if mask == "key_mask":
        m = np.zeros((B, 1, 1, S), np.float32)
        m[1, ..., 3:] = -1e4
        ins["BiasQK"] = m
    elif mask == "full":
        ins["BiasQK"] = _f(B, N, S, S, seed=3)
    _check_both("multihead_matmul", ins, {"alpha": 1.0 / np.sqrt(H)},
                {"Out": 1}, grads=("Input", "W", "Bias"))


@pytest.mark.parametrize("act,residual", [("relu", True), ("identity", False)])
def test_conv2d_fusion(act, residual):
    ins = {"Input": _f(2, 3, 6, 6), "Filter": _f(4, 3, 3, 3, seed=1),
           "Bias": _f(4, seed=2)}
    if residual:
        ins["ResidualData"] = _f(2, 4, 6, 6, seed=3)
    _check_both("conv2d_fusion", ins,
                {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
                 "groups": 1, "activation": act}, {"Output": 1},
                grads=tuple(ins))


def test_conv2d_inception_fusion():
    ins = {"Input": _f(1, 3, 5, 5),
           "Filter": [_f(2, 3, 1, 1, seed=1), _f(3, 3, 3, 3, seed=2)],
           "Bias": [_f(2, seed=3), _f(3, seed=4)]}
    _check_both("conv2d_inception_fusion", ins, {}, {"Output": 1})
    j, t = both("conv2d_inception_fusion", ins, {},
                {"Output": 1, "TempOutput": 1})
    assert t["o_TempOutput_0"].shape == (0,)


# -- tests/test_op_sweep.py's rows of these ops ----------------------------------

FUSED_ROWS = ["fused_batch_norm_act", "fusion_transpose_flatten_concat",
              "conv2d_inception_fusion"]


@pytest.mark.parametrize("name", FUSED_ROWS)
def test_op_sweep_rows(name):
    """The sweep's row of each fusion that has one, with its inputs,
    attrs and gradient slots: every output forward; the gradients of a
    weighted sum of the outputs, where for ``fused_batch_norm_act`` the
    sum is over Y alone: the port computes batch_norm's running and
    saved statistics without a graph, where JAX's vjp also
    differentiates them (ROADMAP §C; no Program reads those
    gradients)."""
    from test_op_sweep import SPECS
    from paddle_tpu_torch.core.registry import get_op_def

    row = SPECS[name]
    outs = {s: 1 for s in get_op_def(name).output_slots}
    outs.update(row["n_out"] or {})
    _check_both(name, row["inputs"], row["attrs"], outs)
    if row["grads"]:
        _check_both(name, row["inputs"], row["attrs"],
                    {"Y": 1} if name == "fused_batch_norm_act" else outs,
                    grads=tuple(row["grads"]))


# -- contrib.layers ------------------------------------------------------------

CONTRIB = {
    "fused_elemwise_activation": lambda L, C: C.fused_elemwise_activation(
        _d(L, "x", [3, 4]), _d(L, "y", [3, 4]), ["relu", "elementwise_add"]),
    "var_conv_2d": lambda L, C: C.var_conv_2d(
        _d(L, "x", [2, 3, 6, 6]), _d(L, "r", [2], "int64"),
        _d(L, "c", [2], "int64"), 3, 4, 3),
    "match_matrix_tensor": lambda L, C: C.match_matrix_tensor(
        _d(L, "x", [2, 4, 5]), _d(L, "y", [2, 3, 6]), 2)[0],
    "sequence_topk_avg_pooling": lambda L, C: C.sequence_topk_avg_pooling(
        _d(L, "x", [2, 3, 6]), _d(L, "r", [2], "int64"),
        _d(L, "c", [2], "int64"), [1, 2], 3),
    "tree_conv": lambda L, C: C.tree_conv(
        _d(L, "n", [2, 5, 4]), _d(L, "e", [2, 4, 2], "int32"), 3,
        num_filters=2),
    "fused_embedding_seq_pool": lambda L, C: C.fused_embedding_seq_pool(
        _d(L, "i", [3, 5, 1], "int64"), [10, 4]),
    "multiclass_nms2": lambda L, C: C.multiclass_nms2(
        _d(L, "b", [1, 6, 4]), _d(L, "s", [1, 3, 6]), 0.1, 10, 5),
    "search_pyramid_hash": lambda L, C: C.search_pyramid_hash(
        _d(L, "t", [4, 1], "int32"), 8, 100, 2, 8, 0.0, False, False, 0, 0,
        1, 0.1),
    "shuffle_batch": lambda L, C: C.shuffle_batch(_d(L, "x", [6, 3]), seed=1),
    "partial_concat": lambda L, C: C.partial_concat(
        [_d(L, "x", [3, 5]), _d(L, "y", [3, 5])], 1, 2),
    "partial_sum": lambda L, C: C.partial_sum(
        [_d(L, "x", [3, 5]), _d(L, "y", [3, 5])], -3, -1),
    "ctr_metric_bundle": lambda L, C: C.ctr_metric_bundle(
        _d(L, "p", [4, 1]), _d(L, "l", [4, 1]))[0],
}


def _contrib(pkg):
    return jax_contrib_layers if pkg is jfluid else port_contrib_layers


@pytest.mark.parametrize("name", sorted(CONTRIB))
def test_contrib_layers_build_jax_programs(name):
    jm, js = _build(jfluid, lambda L, p: CONTRIB[name](L, _contrib(p)))
    tm, ts = _build(fluid, lambda L, p: CONTRIB[name](L, _contrib(p)))
    jd, td = _norm(jm.to_dict()), _norm(tm.to_dict())
    assert td["blocks"] == jd["blocks"]
    assert _norm(ts.to_dict()) == _norm(js.to_dict())


def test_contrib_exports_match_jax():
    assert sorted(port_contrib_layers.__all__) == sorted(
        jax_contrib_layers.__all__)


RUNS = {
    "fused_elemwise_activation": {"x": _f(3, 4), "y": _f(3, 4, seed=1)},
    "partial_concat": {"x": _f(3, 5), "y": _f(3, 5, seed=1)},
    "partial_sum": {"x": _f(3, 5), "y": _f(3, 5, seed=1)},
    "match_matrix_tensor": {"x": _f(2, 4, 5), "y": _f(2, 3, 6, seed=1)},
    "fused_embedding_seq_pool": {
        "i": np.random.RandomState(2).randint(0, 10, (3, 5, 1))},
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_contrib_layers_run_to_jax_values(name):
    """The layers over deterministic ops, JAX's initial weights carried
    into the port's scope: the fetched outputs within 1e-5."""
    res, init = [], None
    for pkg in (jfluid, fluid):
        main, startup = _build(pkg, lambda L, p: None)
        with pkg.program_guard(main, startup):
            from test_torch_layer_surface import _names

            with _names(pkg).guard():
                out = CONTRIB[name](pkg.layers, _contrib(pkg))
        scope, exe = pkg.Scope(), pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        params = [p.name for p in main.all_parameters()]
        if init is None:
            init = {n: np.asarray(scope.find_var(n)) for n in params}
        else:
            from paddle_tpu_torch.io import load_scope_arrays

            load_scope_arrays(scope, init, main, "cpu")
        (v,) = exe.run(main, feed=RUNS[name], fetch_list=[out], scope=scope)
        res.append(np.asarray(v))
    np.testing.assert_allclose(res[1], res[0], rtol=1e-5, atol=1e-6)


def test_ctr_metric_bundle_accumulates_as_jax():
    """Two batches through ``ctr_metric_bundle``: the six running sums
    equal JAX's after each."""
    rng = np.random.RandomState(5)
    feeds = [{"p": rng.rand(4, 1).astype(np.float32),
              "l": (rng.rand(4, 1) > 0.5).astype(np.float32)}
             for _ in range(2)]
    res = []
    for pkg in (jfluid, fluid):
        box = {}
        main, startup = _build(pkg, lambda L, p: box.setdefault(
            "outs", _contrib(p).ctr_metric_bundle(_d(L, "p", [4, 1]),
                                                  _d(L, "l", [4, 1]))))
        scope, exe = pkg.Scope(), pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        res.append([[np.asarray(v) for v in exe.run(
            main, feed=f, fetch_list=list(box["outs"]), scope=scope)]
            for f in feeds])
    for jstep, tstep in zip(*res):
        for a, b in zip(jstep, tstep):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
