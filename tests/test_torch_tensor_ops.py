"""The tensor ops, ``flatten``, the convolutions (SAME / VALID padding,
depthwise, transpose), adaptive pooling and soft-label cross-entropy of
the port against the JAX package, on the CPU; the layers over them, the
elementwise layers with a scalar operand; and the repairs of
``fused_adamw`` over a SelectedRows gradient and of
``build_lm_program``'s refusal.

One-op cases go through ``test_torch_activations.both`` (the same
Program in both packages, every float output weighted by a fed random
array, ``append_backward`` for the gradients): outputs and gradients
within rtol 1e-5 / atol 1e-6, integer outputs exactly. Convolutions sum
over channels and windows in another order: rtol 1e-4 / atol 1e-5, as
``test_torch_resnet.py``. Training: rtol 2e-4 / atol 2e-5.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid

import paddle_tpu_torch as fluid
from paddle_tpu_torch.io import load_scope_arrays
from test_torch_activations import _f, _names, both, check, run_op

CONV_RTOL, CONV_ATOL = 1e-4, 1e-5
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5


def _i(*shape, hi=4, seed=0, dtype="int64"):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(dtype)


# -- ops/tensor.py ---------------------------------------------------------------

TENSOR_CASES = {
    "fill_constant_batch_size_like": (
        {"Input": _f(5, 3)}, {"shape": [-1, 4], "value": 2.5,
                              "dtype": "float32"}, (), {}),
    "fill_constant_batch_size_like_idx": (
        {"Input": _f(5, 3)}, {"shape": [2, -1, 3], "value": 1.0,
                              "input_dim_idx": 1, "output_dim_idx": 1,
                              "dtype": "int64"}, (), {}),
    "shape": ({"Input": _f(2, 3, 4)}, {}, (), {}),
    "flatten2": ({"X": _f(2, 3, 4)}, {"axis": 2}, ("X",),
                 {"Out": 1, "XShape": 1}),
    "flatten": ({"X": _f(2, 3, 4)}, {"axis": 1}, ("X",), {}),
    "slice": ({"Input": _f(4, 6, 3)}, {"axes": [0, 1], "starts": [1, -4],
                                       "ends": [3, 100]}, ("Input",), {}),
    "slice_decrease": ({"Input": _f(4, 6)}, {"axes": [0], "starts": [2],
                                             "ends": [3],
                                             "decrease_axis": [0]},
                       ("Input",), {}),
    "strided_slice": ({"Input": _f(4, 6)}, {"axes": [0, 1],
                                            "starts": [0, 1], "ends": [4, 5],
                                            "strides": [2, 2]},
                      ("Input",), {}),
    "strided_slice_neg": ({"Input": _f(5, 6)}, {"axes": [1], "starts": [5],
                                                "ends": [0], "strides": [-2]},
                          ("Input",), {}),
    "stack": ({"X": [_f(2, 3, seed=1), _f(2, 3, seed=2)]}, {"axis": 1},
              ("X",), {"Y": 1}),
    "unstack": ({"X": _f(2, 3)}, {"axis": 1, "num": 3}, ("X",), {"Y": 3}),
    "expand": ({"X": _f(2, 3)}, {"expand_times": [2, 3]}, ("X",), {}),
    "expand_as": ({"X": _f(1, 3), "target_tensor": _f(4, 3)}, {}, ("X",),
                  {}),
    "gather": ({"X": _f(5, 3), "Index": np.array([4, 0, 4, 2], "int32")},
               {}, ("X",), {}),
    "gather_nd": ({"X": _f(4, 3, 2), "Index": _i(5, 2, hi=3)}, {}, ("X",),
                  {}),
    "scatter_add": ({"X": _f(5, 3), "Ids": np.array([1, 3, 1], "int64"),
                     "Updates": _f(3, 3, seed=4)}, {"overwrite": False},
                    ("X", "Updates"), {}),
    "scatter": ({"X": _f(5, 3), "Ids": np.array([1, 3], "int32"),
                 "Updates": _f(2, 3, seed=4)}, {"overwrite": True},
                ("X", "Updates"), {}),
    "one_hot": ({"X": np.array([[0], [3], [7], [-1]], "int64")},
                {"depth": 5}, (), {}),
    "one_hot_v2": ({"X": np.array([0, 4, 2], "int64")}, {"depth": 5}, (),
                   {}),
    "arg_max": ({"X": np.array([[1, 3, 3, 0], [2, 2, 1, 2]], "float32")},
                {"axis": 1}, (), {}),
    "arg_max_keep": ({"X": _f(3, 4)}, {"axis": 0, "keepdims": True}, (), {}),
    "arg_min": ({"X": np.array([[1, 0, 0, 2], [5, 4, 4, 4]], "float32")},
                {"axis": -1}, (), {}),
    "argsort": ({"X": _f(3, 5)}, {"axis": 1}, ("X",),
                {"Out": 1, "Indices": 1}),
    "argsort_desc": ({"X": _f(3, 5)}, {"axis": 0, "descending": True},
                     ("X",), {"Out": 1, "Indices": 1}),
    "range": ({"Start": np.float32(0), "End": np.float32(5),
               "Step": np.float32(1)},
              {"start": 0.0, "end": 5.0, "step": 1.0}, (), {}),
    "range_frac": ({"Start": np.float32(1), "End": np.float32(2),
                    "Step": np.float32(0.3)},
                   {"start": 1.0, "end": 2.0, "step": 0.3}, (), {}),
    "pad": ({"X": _f(2, 3)}, {"paddings": [1, 2, 0, 3], "pad_value": 0.5},
            ("X",), {}),
    "cumsum": ({"X": _f(2, 5)}, {"axis": 1}, ("X",), {}),
    "cumsum_rev_excl": ({"X": _f(3, 4)}, {"axis": 0, "reverse": True,
                                          "exclusive": True}, ("X",), {}),
}


@pytest.mark.parametrize("case", sorted(TENSOR_CASES))
def test_tensor_op_matches_jax(case):
    inputs, attrs, grads, outs = TENSOR_CASES[case]
    op = {"fill_constant_batch_size_like_idx":
          "fill_constant_batch_size_like", "scatter_add": "scatter",
          "slice_decrease": "slice", "strided_slice_neg": "strided_slice",
          "arg_max_keep": "arg_max", "argsort_desc": "argsort",
          "range_frac": "range",
          "cumsum_rev_excl": "cumsum"}.get(case, case)
    j, t = both(op, inputs, attrs, outs or None, grads)
    if op == "flatten2":
        j = {n: v for n, v in j.items() if "XShape" not in n}
        t = {n: v for n, v in t.items() if "XShape" not in n}
    check(j, t)


ARGSORT_ROWS = {
    # NaN last in both directions, ties in their order
    "nan_ties": np.array([[1.0, 2.0, 2.0, np.nan, 1.0],
                          [np.nan, 0.0, np.nan, -1.0, 0.0]], np.float32),
    "all_equal": np.zeros((2, 4), np.float32),
    "levels": np.round(np.random.RandomState(3).rand(4, 9) * 2).astype(
        np.float32),
}


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("row", sorted(ARGSORT_ROWS))
def test_argsort_nan_and_ties_match_jax(row, desc):
    j, t = both("argsort", {"X": ARGSORT_ROWS[row]},
                {"axis": -1, "descending": desc},
                {"Out": 1, "Indices": 1})
    np.testing.assert_array_equal(t["o_Indices_0"], j["o_Indices_0"])
    np.testing.assert_array_equal(t["o_Out_0"], j["o_Out_0"])
    if row == "nan_ties" and desc:
        # JAX sorts -x: NaN last; torch.argsort(descending=True) would
        # put it first
        np.testing.assert_array_equal(t["o_Indices_0"][0], [1, 2, 0, 4, 3])


def test_scatter_overwrite_with_repeated_ids_takes_the_last_update():
    """The port defines a repeated id under ``overwrite``: its last
    update wins, on every device; the overwritten updates get no
    gradient. XLA:CPU writes in order, so JAX agrees here."""
    x = _f(5, 3)
    upd = _f(4, 3, seed=9)
    ids = np.array([3, 1, 3, 3], np.int64)
    j, t = both("scatter", {"X": x, "Ids": ids, "Updates": upd},
                {"overwrite": True}, grads=("X", "Updates"))
    check(j, t)
    out = t["o_Out_0"]
    np.testing.assert_array_equal(out[3], upd[3])
    np.testing.assert_array_equal(out[1], upd[1])
    assert not t["Updates_0@GRAD"][[0, 2]].any()


# -- ops/nn.py: convolutions, pools, cross-entropy ----------------------------------

def _nhwc(a):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1))


CONV_CASES = {
    "same_stride2": ("conv2d", {"Input": _f(2, 3, 7, 6),
                                "Filter": _f(4, 3, 3, 3, seed=1)},
                     {"strides": [2, 2], "padding_algorithm": "SAME"}),
    "same_even_kernel": ("conv2d", {"Input": _f(1, 2, 6, 6),
                                    "Filter": _f(3, 2, 4, 2, seed=1)},
                         {"strides": [1, 2], "padding_algorithm": "SAME",
                          "dilations": [1, 2]}),
    "valid": ("conv2d", {"Input": _f(2, 3, 7, 6),
                         "Filter": _f(4, 3, 3, 2, seed=1)},
              {"strides": [2, 1], "paddings": [5, 5],
               "padding_algorithm": "VALID"}),
    "depthwise": ("depthwise_conv2d", {"Input": _f(2, 4, 6, 6),
                                       "Filter": _f(4, 1, 3, 3, seed=1)},
                  {"strides": [1, 1], "paddings": [1, 1], "groups": 4}),
    "depthwise_mult": ("depthwise_conv2d", {"Input": _f(1, 3, 5, 5),
                                            "Filter": _f(6, 1, 3, 3, seed=1)},
                       {"strides": [2, 2], "paddings": [1, 1], "groups": 3}),
    "transpose": ("conv2d_transpose", {"Input": _f(1, 2, 4, 4),
                                       "Filter": _f(2, 3, 3, 3, seed=1)},
                  {"strides": [2, 2], "paddings": [1, 1]}),
    "transpose_out_size": ("conv2d_transpose",
                           {"Input": _f(2, 3, 3, 4),
                            "Filter": _f(3, 2, 3, 2, seed=1)},
                           {"strides": [2, 3], "paddings": [0, 1],
                            "dilations": [2, 1], "output_size": [10, 9]}),
    "transpose_groups": ("conv2d_transpose",
                         {"Input": _f(1, 4, 3, 3),
                          "Filter": _f(4, 3, 2, 2, seed=1)},
                         {"strides": [1, 1], "paddings": [0, 0],
                          "groups": 2}),
}


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_matches_jax(case, fmt):
    op, inputs, attrs = CONV_CASES[case]
    inputs = dict(inputs)
    if fmt == "NHWC":
        inputs["Input"] = _nhwc(inputs["Input"])
    j, t = both(op, inputs, dict(attrs, data_format=fmt),
                {"Output": 1}, ("Input", "Filter"))
    check(j, t, rtol=CONV_RTOL, atol=CONV_ATOL)


POOL_CASES = {
    "adaptive_avg": ({"pooling_type": "avg", "ksize": [2, 3],
                      "adaptive": True}, (2, 3, 4, 6)),
    "adaptive_max": ({"pooling_type": "max", "ksize": [1, 2],
                      "adaptive": True}, (2, 3, 4, 6)),
    "adaptive_max_ties": ({"pooling_type": "max", "ksize": [2, 2],
                           "adaptive": True}, None),
    "global_avg": ({"pooling_type": "avg", "global_pooling": True},
                   (2, 3, 5, 5)),
}


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_matches_jax(case, fmt):
    attrs, shape = POOL_CASES[case]
    x = (_f(*shape) if shape else
         np.round(np.random.RandomState(2).rand(1, 2, 4, 4) * 2).astype(
             np.float32))
    if fmt == "NHWC":
        x = _nhwc(x)
    j, t = both("pool2d", {"X": x}, dict(attrs, data_format=fmt),
                grads=("X",))
    check(j, t, rtol=CONV_RTOL, atol=CONV_ATOL)


def test_adaptive_pool_refuses_sizes_that_do_not_divide():
    x = _f(1, 2, 5, 6)
    attrs = {"pooling_type": "avg", "ksize": [2, 3], "adaptive": True}
    with pytest.raises(Exception, match="adaptive pool needs divisible"):
        run_op(jfluid, "pool2d", {"X": x}, attrs)
    with pytest.raises(ValueError, match="adaptive pool needs divisible"):
        run_op(fluid, "pool2d", {"X": x}, attrs)


def _soft(*shape, seed=0):
    p = np.random.RandomState(seed).rand(*shape).astype(np.float32) + 0.05
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


XENT_CASES = {
    "soft": ({"Logits": _f(4, 5), "Label": _soft(4, 5)},
             {"soft_label": True}),
    "soft_3d": ({"Logits": _f(2, 3, 5), "Label": _soft(2, 3, 5)},
                {"soft_label": True}),
    "axis1_hard": ({"Logits": _f(2, 5, 3),
                    "Label": _i(2, 1, 3, hi=5)}, {"axis": 1}),
    "axis1_ignore": ({"Logits": _f(2, 5, 3),
                      "Label": np.array([[[0, -100, 4]], [[-100, 2, 2]]],
                                        "int64")}, {"axis": 1}),
    "axis0_soft": ({"Logits": _f(5, 3),
                    "Label": np.ascontiguousarray(_soft(3, 5).T)},
                   {"axis": 0, "soft_label": True}),
}


@pytest.mark.parametrize("case", sorted(XENT_CASES))
def test_softmax_cross_entropy_plain_path_matches_jax(case):
    inputs, attrs = XENT_CASES[case]
    j, t = both("softmax_with_cross_entropy", inputs, attrs,
                {"Softmax": 1, "Loss": 1}, ("Logits",))
    check(j, t)


# -- layers ---------------------------------------------------------------------------


def _layers_program(pkg):
    """Most of the new layers in one Program over a dynamic batch, with
    the scalar-operand elementwise layers."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), _names(pkg).guard():
        x = L.data("x", [4, 6], stop_gradient=False)
        ids = L.data("ids", [3], dtype="int64")
        outs = {}
        h = L.fc(L.flatten(x, axis=1), 12, act="tanh")
        outs["rdiv"] = L._elementwise_binary(h, 2.0, "elementwise_div",
                                             reverse=True)
        outs["rmax"] = L.elementwise_max(h, 0.25)
        outs["rmin"] = L.elementwise_min(h, -0.25)
        outs["rpow"] = L.elementwise_pow(L.abs(h), 2.0)
        outs["radd"] = L._elementwise_binary(h, 1.5, "elementwise_mul",
                                             reverse=True)
        hx = L.reshape(h, [-1, 3, 4])
        outs["rmean"] = L.reduce_mean(hx, dim=[1, 2])
        outs["rmax_all"] = L.reduce_max(hx, dim=1, keep_dim=True)
        outs["rmin_all"] = L.reduce_min(hx)
        outs["rprod"] = L.reduce_prod(L.scale(hx, bias=2.0), dim=2)
        outs["slice"] = L.slice(hx, axes=[1, 2], starts=[1, 0], ends=[3, -1])
        outs["sslice"] = L.strided_slice(hx, axes=[2], starts=[3], ends=[0],
                                         strides=[-1])
        outs["stack"] = L.stack([h, L.sin(h)], axis=1)
        a, b, c = L.unstack(hx, axis=1)
        outs["unstack"] = L.sums([a, L.erf(b), c])
        outs["expand"] = L.expand(L.reshape(h, [-1, 1, 12]), [1, 2, 1])
        outs["expand_as"] = L.expand_as(L.reshape(h, [-1, 1, 12]),
                                        L.stack([h, h], axis=1))
        outs["pad"] = L.pad(hx, [0, 0, 1, 1, 2, 0], pad_value=0.5)
        outs["cumsum"] = L.cumsum(hx, axis=2, exclusive=True)
        outs["gather"] = L.gather(L.transpose(h, [1, 0]), ids)
        outs["sort"], outs["sort_idx"] = L.argsort(h, axis=1,
                                                   descending=True)
        outs["argmax"] = L.argmax(h, axis=1)
        outs["argmin"] = L.argmin(h, axis=1)
        outs["one_hot"] = L.one_hot(ids, 12)
        outs["shape"] = L.shape(hx)
        outs["sign"] = L.sign(h)
        outs["mul"] = L.mul(h, L.fill_constant([12, 2], "float32", 0.5))
        outs["glu"] = pkg.nets.glu(h, dim=1)
        outs["ones_like"] = L.ones_like(h)
        outs["zeros_like"] = L.zeros_like(h)
        outs["any"] = L.reduce_any(L.greater_than(h, L.zeros_like(h)))
        outs["all"] = L.reduce_all(L.logical_not(L.less_than(
            h, L.scale(L.zeros_like(h), bias=-2.0))), dim=1)
        outs["logic"] = L.logical_xor(
            L.logical_and(L.greater_than(h, L.zeros_like(h)),
                          L.less_than(h, L.ones_like(h))),
            L.logical_or(L.greater_than(h, L.zeros_like(h)),
                         L.less_than(h, L.zeros_like(h))))
        loss = L.sums([L.reduce_sum(v) for k, v in sorted(outs.items())
                       if k not in ("sort_idx", "argmax", "argmin", "shape",
                                    "one_hot", "any", "all", "logic")])
        pkg.append_backward(loss)
    fetch = [outs[k] for k in sorted(outs)] + [loss, "x@GRAD"]
    return main, startup, fetch, sorted(outs) + ["loss", "x@GRAD"]


def test_layers_over_the_new_ops_match_jax():
    feed = {"x": _f(5, 4, 6, seed=3), "ids": _i(5, 3, hi=12, seed=4)}
    jmain, jstart, jfetch, keys = _layers_program(jfluid)
    tmain, _, tfetch, _ = _layers_program(fluid)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        params = {p.name: np.asarray(scope.find_var(p.name))
                  for p in jmain.all_parameters()}
        jout = exe.run(jmain, feed=feed, fetch_list=jfetch)
    tscope = fluid.Scope()
    load_scope_arrays(tscope, params, tmain, "cpu")
    tout = fluid.Executor(fluid.CPUPlace()).run(tmain, feed=feed,
                                                fetch_list=tfetch,
                                                scope=tscope)
    for k, j, t in zip(keys, jout, tout):
        j, t = np.asarray(j), np.asarray(t)
        assert j.shape == t.shape, (k, j.shape, t.shape)
        if j.dtype.kind in "biu":
            np.testing.assert_array_equal(t, j, err_msg=k)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_scalar_operand_layers_build_the_reference_program():
    """An elementwise layer with a Python number on either side takes a
    constant of the other operand's shape (batch-size-like for a
    dynamic batch), as the JAX package's does."""
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), _names(pkg).guard():
            x = pkg.layers.data("x", [3])
            y = pkg.layers.data("y", [3], append_batch_size=False)
            pkg.layers.elementwise_max(x, 0.5)
            pkg.layers.elementwise_mod(y, 2.0)
            pkg.layers._elementwise_binary(x, 3.0, "elementwise_div",
                                           reverse=True)
            pkg.layers._elementwise_binary(y, 1.0, "elementwise_max",
                                           reverse=True)
        return main

    tmain, jmain = build(fluid), build(jfluid)
    assert tmain.to_dict() == jmain.to_dict()
    types = [op.type for op in tmain.global_block().ops]
    assert types.count("fill_constant_batch_size_like") == 2
    assert types.count("fill_constant") == 2


# -- C4: fused_adamw with a SelectedRows gradient -------------------------------------


def _sparse_adamw(pkg, coeff):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), _names(pkg).guard():
        ids = pkg.layers.data("ids", [1], dtype="int64")
        emb = pkg.layers.embedding(ids, [10, 4], is_sparse=True,
                                   param_attr=pkg.ParamAttr(name="emb"))
        loss = pkg.layers.mean(pkg.layers.square(emb))
        pkg.append_backward(loss)
        block = main.global_block()

        def state(name, shape, value):
            v = pkg.layers.create_global_var(shape, value, "float32",
                                             persistable=True, name=name)
            return v.name

        attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
        if coeff is not None:
            attrs["coeff"] = coeff
        block.append_op(
            type="fused_adamw",
            inputs={"Param": ["emb"], "Grad": ["emb@GRAD"],
                    "LearningRate": [state("lr", [1], 0.1)],
                    "Moment1": [state("m1", [10, 4], 0.0)],
                    "Moment2": [state("m2", [10, 4], 0.0)],
                    "Beta1Pow": [state("b1p", [1], 0.9)],
                    "Beta2Pow": [state("b2p", [1], 0.999)]},
            outputs={"ParamOut": ["emb"], "Moment1Out": ["m1"],
                     "Moment2Out": ["m2"], "Beta1PowOut": ["b1p"],
                     "Beta2PowOut": ["b2p"]},
            attrs=attrs)
    return main, startup, loss


@pytest.mark.parametrize("coeff", [None, 0.01, 0.0])
def test_fused_adamw_with_sparse_gradient_decays_as_jax(coeff):
    """The sparse adam on the looked-up rows, then ``ParamOut - lr *
    coeff * Param`` on every row (the op's default coeff is 0.01)."""
    feed = {"ids": np.array([[1], [4], [1], [7]], np.int64)}
    jmain, jstart, jloss = _sparse_adamw(jfluid, coeff)
    tmain, _, tloss = _sparse_adamw(fluid, coeff)
    names = ["emb", "m1", "m2", "b1p", "b2p"]
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        init = {n: np.asarray(scope.find_var(n)) for n in names + ["lr"]}
        for _ in range(3):
            exe.run(jmain, feed=feed, fetch_list=[jloss])
        jstate = {n: np.asarray(scope.find_var(n)) for n in names}
    tscope = fluid.Scope()
    load_scope_arrays(tscope, init, tmain, "cpu")
    texe = fluid.Executor(fluid.CPUPlace())
    for _ in range(3):
        texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)
    for n in names:
        np.testing.assert_allclose(tscope.get_numpy(n), jstate[n],
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                   err_msg=n)
    untouched = [0, 2, 3, 5, 6, 8, 9]
    moved = not np.allclose(jstate["emb"][untouched], init["emb"][untouched])
    assert moved == (coeff != 0.0)


# -- C3: build_lm_program with moe_every -------------------------------------------------


def test_build_lm_program_refuses_moe_pointing_to_the_predictor():
    from paddle_tpu_torch.generation.model import build_lm_program
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig.tiny()
    cfg.moe_every = 1
    with pytest.raises(NotImplementedError) as e:
        build_lm_program(cfg, 8)
    msg = str(e.value)
    assert "create_predictor" in msg and "dense FFNs only" in msg
    assert "A1" not in msg and "not ported" not in msg
