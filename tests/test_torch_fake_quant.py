"""The fake-quantize family (``ops/quant.py``), ``quantize.calibrate``
and the quantization-aware training passes of ``contrib.slim`` in the
port, against the JAX package, on the CPU.

One-op cases go through ``test_torch_activations.both``: outputs and X's
gradient (which flows through the straight-through round and through
the abs-max that made the scale, as in JAX) within rtol 1e-5 / atol
1e-6; the rounding cases at k + 0.5 exactly. QAT training, from the JAX
startup's parameters: losses and every persistable within rtol 2e-4 /
atol 2e-5, as the other training parity tests. The twins of
``tests/test_slim.py`` and ``tests/test_quantize.py`` run the same
checks on the port.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import quantize as jquantize

import paddle_tpu_torch as fluid
from paddle_tpu_torch import quantize as tquantize
from paddle_tpu_torch.io import load_scope_arrays
from test_torch_activations import (  # noqa: F401 (unfused: a fixture)
    _f, _names, _persistables, both, check, run_op, unfused)

TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5


def _pos(*shape, seed=0):
    return (np.abs(_f(*shape, seed=seed)) + 0.5).astype(np.float32)


_MOVING = {"Out": 1, "OutScale": 1, "OutAccum": 1, "OutState": 1}

QUANT_CASES = {
    "fake_quantize_abs_max": ({"X": _f(3, 4)}, {"bit_length": 8},
                              {"Out": 1, "OutScale": 1}, ("X",)),
    "fake_quantize_abs_max_4bit": ({"X": _f(5, 2, seed=2)},
                                   {"bit_length": 4},
                                   {"Out": 1, "OutScale": 1}, ("X",)),
    "fake_quantize_dequantize_moving_average_abs_max": (
        {"X": _f(3, 4), "InScale": _pos(1), "InAccum": _pos(1, seed=1),
         "InState": _pos(1, seed=2)}, {"bit_length": 8, "moving_rate": 0.8},
        _MOVING, ("X",)),
    "fake_qdq_moving_is_test": (
        {"X": _f(3, 4), "InScale": _pos(1), "InAccum": _pos(1, seed=1),
         "InState": _pos(1, seed=2)}, {"bit_length": 8, "is_test": True},
        _MOVING, ("X",)),
    "fake_quantize_moving_average_abs_max": (
        {"X": _f(3, 4), "InScale": _pos(1), "InAccum": _pos(1, seed=1),
         "InState": _pos(1, seed=2)}, {"bit_length": 8}, _MOVING, ("X",)),
    "fake_quantize_moving_no_state": (
        {"X": _f(3, 4), "InScale": _pos(1)}, {"bit_length": 8}, _MOVING,
        ("X",)),
    "fake_channel_wise_quantize_abs_max": (
        {"X": _f(4, 3, 2, 2)}, {"bit_length": 8},
        {"Out": 1, "OutScale": 1}, ("X",)),
    "fake_dequantize_max_abs": ({"X": _f(4, 8), "Scale": _pos(1)},
                                {"max_range": 127.0}, None, ("X",)),
    "fake_quantize_range_abs_max": (
        {"X": _f(3, 4), "InScale": _pos(1)}, {"bit_length": 8},
        {"Out": 1, "OutScale": 1, "OutScales": 1}, ("X",)),
    "fake_quantize_range_window": (
        {"X": _f(3, 4), "InScale": np.array([5.0], np.float32),
         "Iter": np.array([2.0], np.float32),
         "InScales": np.array([1.0, 5.0, 2.0, 0.5], np.float32)},
        {"bit_length": 8}, {"Out": 1, "OutScale": 1, "OutScales": 1},
        ("X",)),
    "fake_quantize_range_is_test": (
        {"X": _f(3, 4), "InScale": np.array([0.7], np.float32),
         "Iter": np.array([1.0], np.float32),
         "InScales": np.array([1.0, 0.7], np.float32)},
        {"bit_length": 8, "is_test": True},
        {"Out": 1, "OutScale": 1, "OutScales": 1}, ("X",)),
    "moving_average_abs_max_scale": (
        {"X": _f(3, 4), "InAccum": _pos(1), "InState": _pos(1, seed=1)},
        {"moving_rate": 0.9}, _MOVING, ("X",)),
    "moving_average_abs_max_scale_fresh": ({"X": _f(3, 4)}, {}, _MOVING,
                                           ("X",)),
    "fake_channel_wise_dequantize_max_abs": (
        {"X": _f(3, 4), "Scales": [_pos(3)]}, {"quant_bits": [8]}, None,
        ("X",)),
    "fake_channel_wise_dequantize_two": (
        {"X": _f(3, 4), "Scales": [_pos(3), _pos(1, seed=3)]},
        {"quant_bits": [8, 4]}, None, ("X",)),
    "dequantize_abs_max": (
        {"X": np.random.RandomState(1).randint(-100, 100, (3, 4)).astype(
            np.int8), "Scale": _pos(1)}, {"max_range": 127.0}, None, ()),
    "quantize": ({"Input": _f(3, 4) * 3}, {"Scale": 50.0, "Shift": 2.0},
                 {"Output": 1}, ()),
    "quantize_signed": ({"Input": _f(3, 4) * 3},
                        {"Scale": 50.0, "is_negative_input": True},
                        {"Output": 1}, ()),
    "dequantize": ({"Input": np.random.RandomState(2).randint(
        0, 255, (3, 4)).astype(np.uint8)}, {"Scale": 50.0, "Shift": 3.0},
                   {"Output": 1}, ()),
    "requantize": ({"Input": np.random.RandomState(3).randint(
        -100, 100, (3, 4)).astype(np.int8)},
                   {"Scale_in": 2.0, "Scale_out": 3.0}, {"Output": 1}, ()),
    "lookup_table_dequant": (
        {"W": np.concatenate([_f(5, 1), _pos(5, 1),
                              np.random.RandomState(4).randint(
                                  0, 255, (5, 4)).astype(np.float32)], 1),
         "Ids": np.array([4, 0, 4], np.int64)}, {}, None, ()),
}

_OP = {"fake_quantize_abs_max_4bit": "fake_quantize_abs_max",
       "fake_qdq_moving_is_test":
       "fake_quantize_dequantize_moving_average_abs_max",
       "fake_quantize_moving_no_state":
       "fake_quantize_moving_average_abs_max",
       "fake_quantize_range_window": "fake_quantize_range_abs_max",
       "fake_quantize_range_is_test": "fake_quantize_range_abs_max",
       "moving_average_abs_max_scale_fresh": "moving_average_abs_max_scale",
       "fake_channel_wise_dequantize_two":
       "fake_channel_wise_dequantize_max_abs",
       "quantize_signed": "quantize"}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quant_op_matches_jax(case):
    inputs, attrs, outs, grads = QUANT_CASES[case]
    check(*both(_OP.get(case, case), inputs, attrs, outs, grads))


def test_the_port_registers_the_thirteen_quant_lowerings():
    from paddle_tpu_torch.core.registry import has_op

    ops = {_OP.get(c, c) for c in QUANT_CASES}
    assert len(ops) == 13 and all(has_op(o) for o in ops)


def test_round_half_to_even_at_k_plus_half():
    """x / s * 127 lands on k + 0.5 exactly (s = 127 makes it x): both
    round half to even, forward and the straight-through gradient."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 100.5]],
                 np.float32)
    j, t = both("fake_quantize_abs_max", {"X": x}, {"bit_length": 8},
                {"Out": 1, "OutScale": 1}, ("X",))
    check(j, t, exact=True)
    np.testing.assert_array_equal(
        t["o_Out_0"], [[127.0, 0.0, 2.0, 2.0, -0.0, -2.0, -2.0, 4.0, 100.0]])


@pytest.mark.parametrize("op", ["fake_quantize_abs_max",
                                "fake_channel_wise_quantize_abs_max"])
def test_all_zero_input_gives_zeros_not_nan(op):
    x = np.zeros((3, 4), np.float32)
    j, t = both(op, {"X": x}, {}, {"Out": 1, "OutScale": 1}, ("X",))
    check(j, t)
    assert np.all(t["o_Out_0"] == 0) and np.all(np.isfinite(t["X_0@GRAD"]))


def test_scale_gradient_splits_over_tied_maxima():
    """max(|x|) over [1, -1, 0.5] gives X its share through the scale:
    the path JAX does not stop-gradient."""
    x = np.array([[1.0, -1.0, 0.5]], np.float32)
    j, t = both("fake_quantize_abs_max", {"X": x}, {},
                {"Out": 1, "OutScale": 1}, ("X",))
    check(j, t, exact=True)


def test_range_abs_max_window_evicts_the_old_maximum():
    """Four steps of the window: a large first batch holds the scale
    while it is in the window and leaves when its slot is written
    again (window 2)."""
    def steps(pkg):
        scale = np.array([0.001], np.float32)
        scales = np.zeros(2, np.float32)
        got = []
        for i, mult in enumerate((10.0, 1.0, 1.0, 0.5)):
            x = _f(3, 4, seed=i) * mult
            out = run_op(pkg, "fake_quantize_range_abs_max",
                         {"X": x, "InScale": scale,
                          "Iter": np.array([float(i)], np.float32),
                          "InScales": scales},
                         {}, {"Out": 1, "OutScale": 1, "OutScales": 1})
            scale, scales = out["o_OutScale_0"], out["o_OutScales_0"]
            got.append((scale.copy(), scales.copy(), out["o_Out_0"]))
        return got

    for (js, jw, jo), (ts, tw, to) in zip(steps(jfluid), steps(fluid)):
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-7)
    got = steps(fluid)
    assert got[1][0] == got[0][0] and got[2][0] < got[0][0]


# -- QAT: the transform and freeze passes --------------------------------------------


def _classifier(pkg, seed=3):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), _names(pkg).guard():
        x = pkg.layers.data("x", [8])
        y = pkg.layers.data("y", [1], dtype="int64")
        h = pkg.layers.fc(x, 16, act="relu")
        logits = pkg.layers.fc(h, 4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
    return main, startup, logits, loss


def _qat(pkg, act_type="moving_average_abs_max"):
    from importlib import import_module

    slim = import_module(pkg.__name__ + ".contrib.slim.quantization")
    main, startup, logits, loss = _classifier(pkg)
    with pkg.program_guard(main, startup), _names(pkg).guard():
        pkg.optimizer.Adam(5e-3).minimize(loss)
        slim.QuantizationTransformPass(
            startup_program=startup,
            activation_quantize_type=act_type).apply(main)
    return main, startup, logits, loss


@pytest.mark.parametrize("act_type", ["moving_average_abs_max",
                                      "abs_max", "range_abs_max"])
def test_qat_training_matches_jax(act_type, unfused):
    """The pass runs after ``minimize``: the grad ops still name the
    unquantized inputs, and both Executors take the gradients there.
    Five Adam steps from JAX's startup, every persistable held."""
    rng = np.random.RandomState(0)
    W = rng.randn(8, 4)
    batches = []
    for _ in range(5):
        xb = rng.randn(16, 8).astype(np.float32)
        batches.append({"x": xb, "y": np.argmax(xb @ W, 1).reshape(
            -1, 1).astype(np.int64)})
    jmain, jstart, _, jloss = _qat(jfluid, act_type)
    tmain, _, _, tloss = _qat(fluid, act_type)
    assert tmain.to_dict() == jmain.to_dict()
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(jmain)}
        jl = [float(np.asarray(exe.run(jmain, feed=b, fetch_list=[jloss])[0]))
              for b in batches]
        jstate = {n: np.asarray(scope.find_var(n)) for n in init}
    tscope = fluid.Scope()
    load_scope_arrays(tscope, init, tmain, "cpu")
    texe = fluid.Executor(fluid.CPUPlace())
    tl = [float(texe.run(tmain, feed=b, fetch_list=[tloss],
                         scope=tscope)[0]) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    for n, v in jstate.items():
        np.testing.assert_allclose(tscope.get_numpy(n), v, rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, err_msg=n)
    moved = [n for n in jstate if ".q_" in n
             and not np.array_equal(tscope.get_numpy(n), init[n])]
    assert bool(moved) == (act_type != "abs_max"), moved


def test_qat_gradients_are_taken_at_the_unquantized_inputs():
    """The fc weight's gradient after the pass equals the one of the
    program without it, on the same (quantized) forward cotangents:
    checked by comparing against JAX, whose grad ops re-trace the
    forward on the inputs they name."""
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(6, 8).astype(np.float32),
            "y": rng.randint(0, 4, (6, 1)).astype(np.int64)}

    def grads(pkg):
        from importlib import import_module

        slim = import_module(pkg.__name__ + ".contrib.slim.quantization")
        main, startup, _, loss = _classifier(pkg)
        with pkg.program_guard(main, startup), _names(pkg).guard():
            pg = pkg.append_backward(loss)
        slim.QuantizationTransformPass(startup_program=startup).apply(main)
        names = [g.name for _, g in pg]
        return main, startup, names

    jmain, jstart, names = grads(jfluid)
    tmain, _, _ = grads(fluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(jmain)}
        jg = exe.run(jmain, feed=feed, fetch_list=names)
    tscope = fluid.Scope()
    load_scope_arrays(tscope, init, tmain, "cpu")
    tg = fluid.Executor(fluid.CPUPlace()).run(tmain, feed=feed,
                                              fetch_list=names, scope=tscope)
    for n, a, b in zip(names, jg, tg):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def test_freeze_pass_forward_matches_jax_and_keeps_the_state(unfused):
    """After three QAT steps, the frozen test program (``is_test`` fake
    quantization by the learned scales) gives JAX's logits on the same
    state, and leaves every persistable as it was."""
    def run(pkg, init=None):
        from importlib import import_module

        slim = import_module(pkg.__name__ + ".contrib.slim.quantization")
        main, startup, logits, loss = _classifier(pkg)
        test_prog = main.clone(for_test=True)
        with pkg.program_guard(main, startup), _names(pkg).guard():
            pkg.optimizer.Adam(5e-3).minimize(loss)
        slim.QuantizationTransformPass(startup_program=startup).apply(main)
        slim.QuantizationTransformPass().apply(test_prog)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        if init is None:
            with pkg.scope_guard(scope):
                exe.run(startup)
            init = {n: np.asarray(scope.find_var(n))
                    for n in _persistables(main)}
        else:
            load_scope_arrays(scope, init, main, "cpu")
        rng = np.random.RandomState(2)
        for _ in range(3):
            exe.run(main, feed={"x": rng.randn(8, 8).astype(np.float32),
                                "y": rng.randint(0, 4, (8, 1)).astype(
                                    np.int64)},
                    fetch_list=[loss], scope=scope)
        # the test clone's quant state vars are its own: take the
        # trained ones by the order the passes made them
        trained = [n for n in _persistables(main) if ".q_" in n]
        fresh = [n for n in _persistables(test_prog) if ".q_" in n]
        for a, b in zip(sorted(trained), sorted(fresh)):
            scope.set_var(b, np.asarray(scope.find_var(a)))
        slim.QuantizationFreezePass(scope, pkg.CPUPlace()).apply(test_prog)
        assert all(op.attrs.get("is_test")
                   for op in test_prog.global_block().ops
                   if op.type.startswith("fake_quantize"))
        before = {n: np.array(scope.find_var(n))
                  for n in _persistables(test_prog)}
        xb = rng.randn(5, 8).astype(np.float32)
        (out,) = exe.run(test_prog, feed={"x": xb, "y": np.zeros(
            (5, 1), np.int64)}, fetch_list=[logits.name], scope=scope)
        for n, v in before.items():
            np.testing.assert_array_equal(np.asarray(scope.find_var(n)), v,
                                          err_msg=n)
        return init, np.asarray(out)

    init, jout = run(jfluid)
    _, tout = run(fluid, init)
    np.testing.assert_allclose(tout, jout, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)


# -- twins of tests/test_slim.py and tests/test_quantize.py --------------------------


def test_qat_trains_and_stays_close_to_fp32(unfused):
    """Twin of ``tests/test_slim.py:22``."""
    from paddle_tpu_torch.contrib.slim.quantization import \
        QuantizationTransformPass

    rng = np.random.RandomState(0)
    W = rng.randn(8, 4)
    main, startup, logits, loss = _classifier(fluid)
    with fluid.program_guard(main, startup):
        fluid.optimizer.Adam(5e-3).minimize(loss)
    QuantizationTransformPass(startup_program=startup).apply(main)
    types = {op.type for op in main.global_block().ops}
    assert "fake_quantize_abs_max" in types
    assert "fake_quantize_dequantize_moving_average_abs_max" in types
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    first = None
    for _ in range(60):
        xb = rng.randn(64, 8).astype("float32")
        yb = np.argmax(xb @ W, 1).reshape(-1, 1).astype("int64")
        (l,) = exe.run(main, feed={"x": xb, "y": yb}, fetch_list=[loss],
                       scope=scope)
        if first is None:
            first = float(l)
    assert float(l) < first * 0.7, (first, float(l))


def test_qat_range_abs_max_threads_window():
    """Twin of ``tests/test_slim.py:52``."""
    from paddle_tpu_torch.contrib.slim.quantization import \
        QuantizationTransformPass

    rng = np.random.RandomState(1)
    main, startup, logits, loss = _classifier(fluid)
    QuantizationTransformPass(
        startup_program=startup,
        activation_quantize_type="range_abs_max").apply(main)
    qops = [op for op in main.global_block().ops
            if op.type == "fake_quantize_range_abs_max"]
    assert qops
    for op in qops:
        assert op.inputs.get("InScales") and op.inputs.get("Iter")
        assert op.inputs["InScales"][0] == op.outputs["OutScales"][0]
    it_name = qops[0].inputs["Iter"][0]
    scale_name = qops[0].outputs["OutScale"][0]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    scales = []
    for i in range(3):
        xb = rng.randn(16, 8).astype("float32") * (10.0 if i == 0 else 1.0)
        yb = np.zeros((16, 1), "int64")
        _, s, it = exe.run(main, feed={"x": xb, "y": yb},
                           fetch_list=[loss, scale_name, it_name],
                           scope=scope)
        scales.append(float(np.asarray(s)[0]))
    assert float(np.asarray(it)[0]) == 3.0
    assert scales[1] == scales[0] and scales[2] == scales[0]


def test_quant_dequant_identity_within_step():
    """Twin of ``tests/test_slim.py:91``."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16])
        out = main.global_block().create_var(name="q_out")
        scale = main.global_block().create_var(name="q_scale")
        main.global_block().append_op(
            type="fake_quantize_abs_max", inputs={"X": [x]},
            outputs={"Out": [out], "OutScale": [scale]},
            attrs={"bit_length": 8})
    xv = np.random.RandomState(1).randn(4, 16).astype("float32")
    got, sc = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"x": xv}, fetch_list=[out, scale], scope=fluid.Scope())
    np.testing.assert_allclose(got, xv, atol=float(sc[0]) / 127 + 1e-6)


def _mlp_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), _names(pkg).guard():
        x = pkg.layers.data("x", [16])
        h = pkg.layers.fc(x, 32, act="relu")
        out = pkg.layers.fc(h, 8, act="softmax")
    return main, startup, out


def test_calibrate_observes_activation_scales():
    """Twin of ``tests/test_quantize.py:202``, and the scales held to
    JAX's on the same parameters and feeds (rtol 1e-6), on the float
    program and on the int8-rewritten one."""
    rng = np.random.RandomState(3)
    feeds = [{"x": rng.rand(4, 16).astype("float32") * 2.0}
             for _ in range(3)]
    jmain, jstart, _ = _mlp_program(jfluid)
    tmain, _, _ = _mlp_program(fluid)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        init = {n: np.asarray(jscope.find_var(n))
                for n in _persistables(jmain)}
        jscales = jquantize.calibrate(jmain, feeds, scope=jscope,
                                      executor=jexe)
    scope = fluid.Scope()
    load_scope_arrays(scope, init, tmain, "cpu")
    exe = fluid.Executor(fluid.CPUPlace())
    scales = tquantize.calibrate(tmain, feeds, scope=scope, executor=exe)
    assert set(scales) == {"x", "fc_0.tmp_2"}
    assert all(0.0 < v < 4.0 for v in scales.values())
    for n in scales:
        np.testing.assert_allclose(scales[n], jscales[n], rtol=1e-6)
    assert scope.find_var("x.act_accum") is None
    assert not [n for n in scope.local_var_names() if ".act_" in n]
    tquantize.rewrite_for_inference(tmain, scope, "int8")
    scales_q = tquantize.calibrate(tmain, feeds, scope=scope, executor=exe)
    assert set(scales_q) == set(scales)
    assert scales_q["x"] == scales["x"]


def test_calibrate_stops_at_max_batches():
    main, startup, _ = _mlp_program(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(4)
    feeds = [{"x": rng.rand(4, 16).astype("float32") * (i + 1)}
             for i in range(5)]
    two = tquantize.calibrate(main, feeds, scope=scope, executor=exe,
                              max_batches=2)
    ref = tquantize.calibrate(main, feeds[:2], scope=scope, executor=exe)
    assert two == ref
    with pytest.raises(ValueError, match="no batches"):
        tquantize.calibrate(main, [], scope=scope, executor=exe)
