"""The port's recurrent ops (``ops/rnn.py``), ``StaticRNN`` /
``DynamicRNN`` (the ``recurrent`` op) and the contrib RNN stacks and
cells against the JAX package, on the CPU.

(a) Each ``ops/rnn.py`` lowering as a one-op Program in both packages
    (``test_torch_activations.both``): forward outputs within rtol 1e-5
    / atol 1e-6, input gradients (of a weighted sum of every float
    output) within rtol 1e-4 / atol 1e-5; with lengths, reversed, and
    with initial states where the op takes them.
(b) ``StaticRNN`` (time-major) and ``DynamicRNN`` ([B, T] with lengths)
    twins of tests/test_static_dynamic_rnn.py: the numpy oracle, and
    training from JAX's startup values, losses and every parameter at
    rtol 1e-4 / atol 1e-5 after 4 steps. DynamicRNN's finished rows keep
    their memory bit for bit and emit exact zeros.
(c) A parameter and an outer value read inside the step block (the
    seq2seq decoder reads the encoder output and ``s2s_att_e.w``) get
    JAX's gradients through the ``Parameters`` slot.
(d) ``contrib.layers.basic_gru`` / ``basic_lstm`` (twins of
    tests/test_contrib_layers.py:128-182, :294) trained from JAX's
    startup values; ``BasicGRUUnit`` / ``BasicLSTMUnit`` against JAX's
    dygraph cells on the same weights.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core.framework import unique_name as jax_unique_name

import paddle_tpu_torch as fluid
from paddle_tpu_torch.io import load_scope_arrays
from test_torch_activations import both

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5


def _names(pkg):
    return jax_unique_name if pkg is jfluid else fluid.unique_name


def check_split(j, t):
    """Forward outputs at the forward tolerance, gradients at the
    gradient tolerance; integer outputs exactly."""
    assert sorted(j) == sorted(t)
    for n in j:
        a, b = np.asarray(j[n]), np.asarray(t[n])
        assert a.shape == b.shape, (n, a.shape, b.shape)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=n)
            continue
        rtol, atol = ((GRAD_RTOL, GRAD_ATOL) if n.endswith("@GRAD")
                      else (FWD_RTOL, FWD_ATOL))
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=n)


def f32(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# -- program-level parity: train both packages from JAX's startup values -------


def jax_init(scope, main):
    return {v.name: np.asarray(scope.get_numpy(v.name))
            for v in main.list_vars() if v.persistable and not v.is_data}


def train_both(build, batches):
    """``build(pkg)`` -> (loss, [extra fetches]) inside a program_guard,
    or (loss, [extra fetches], main, startup) for a builder that makes
    its own programs. Returns {"jax": (losses, params, extras), "port":
    ...}, the port starting from JAX's startup values."""
    out = {}
    init = None
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 7
        with pkg.program_guard(main, startup), _names(pkg).guard():
            built = build(pkg)
        loss, extra = built[:2]
        if len(built) == 4:
            main, startup = built[2:]
        fetch = [loss] + list(extra)
        if pkg is jfluid:
            scope = jfluid.Scope()
            with jfluid.scope_guard(scope):
                exe = jfluid.Executor(jfluid.CPUPlace())
                exe.run(startup)
                init = jax_init(scope, main)
                runs = [exe.run(main, feed=b, fetch_list=fetch)
                        for b in batches]
        else:
            scope = fluid.Scope()
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup, scope=scope)
            load_scope_arrays(scope, init, main, "cpu")
            runs = [exe.run(main, feed=b, fetch_list=fetch, scope=scope)
                    for b in batches]
        losses = [float(np.asarray(r[0]).reshape(-1)[0]) for r in runs]
        params = {n: np.asarray(scope.get_numpy(n)) for n in init}
        extras = [[np.asarray(v) for v in r[1:]] for r in runs]
        out["jax" if pkg is jfluid else "port"] = (losses, params, extras)
    return out


def assert_trained_alike(res, extra_tol=(FWD_RTOL, FWD_ATOL)):
    jl, jp, je = res["jax"]
    tl, tp, te = res["port"]
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, err_msg=n)
    for a, b in zip(je, te):
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, rtol=extra_tol[0],
                                       atol=extra_tol[1])


# -- (a) the ops of ops/rnn.py ---------------------------------------------------

B, T, D, H = 3, 5, 4, 3
LEN = np.array([5, 2, 4], np.int32)


def _lstm_ins(with_len=True, with_state=True):
    ins = {"X": f32(B, T, D, seed=1), "WeightX": f32(D, 4 * H, seed=2),
           "WeightH": f32(H, 4 * H, seed=3), "Bias": f32(4 * H, seed=4)}
    if with_state:
        ins["H0"], ins["C0"] = f32(B, H, seed=5), f32(B, H, seed=6)
    if with_len:
        ins["Length"] = LEN
    return ins


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("with_len", [False, True])
def test_fused_lstm(rev, with_len):
    ins = _lstm_ins(with_len)
    j, t = both("fused_lstm", ins, {"is_reverse": rev},
                {"Hidden": 1, "Cell": 1, "LastH": 1, "LastC": 1},
                grads=("X", "WeightX", "WeightH", "Bias", "H0", "C0"))
    check_split(j, t)


@pytest.mark.parametrize("rev,origin", [(False, False), (True, True)])
def test_fused_gru(rev, origin):
    ins = {"X": f32(B, T, D, seed=1), "WeightX": f32(D, 3 * H, seed=2),
           "WeightH": f32(H, 3 * H, seed=3), "Bias": f32(3 * H, seed=4),
           "H0": f32(B, H, seed=5), "Length": LEN}
    j, t = both("fused_gru", ins, {"is_reverse": rev, "origin_mode": origin},
                {"Hidden": 1, "LastH": 1},
                grads=("X", "WeightX", "WeightH", "Bias", "H0"))
    check_split(j, t)


def test_lstm_unit_and_gru_unit():
    j, t = both("lstm_unit", {"X": f32(B, 4 * H, seed=1),
                              "C_prev": f32(B, H, seed=2)},
                {"forget_bias": 0.5}, {"C": 1, "H": 1},
                grads=("X", "C_prev"))
    check_split(j, t)
    j, t = both("gru_unit", {"Input": f32(B, 3 * H, seed=1),
                             "HiddenPrev": f32(B, H, seed=2),
                             "Weight": f32(H, 3 * H, seed=3),
                             "Bias": f32(3 * H, seed=4)},
                {"activation": "tanh", "gate_activation": "sigmoid"},
                {"Gate": 1, "ResetHiddenPrev": 1, "Hidden": 1},
                grads=("Input", "HiddenPrev", "Weight", "Bias"))
    check_split(j, t)


@pytest.mark.parametrize("peep,rev", [(False, False), (True, True)])
def test_lstm_pre_projected(peep, rev):
    """``lstm`` over pre-projected gates; a 7H bias carries peepholes."""
    ins = {"Input": f32(B, T, 4 * H, seed=1), "Weight": f32(H, 4 * H, seed=2),
           "Bias": f32(1, (7 if peep else 4) * H, seed=3),
           "H0": f32(B, H, seed=4), "C0": f32(B, H, seed=5), "Length": LEN}
    j, t = both("lstm", ins, {"is_reverse": rev, "use_peepholes": peep},
                {"Hidden": 1, "Cell": 1, "BatchGate": 1,
                 "BatchCellPreAct": 1},
                grads=("Input", "Weight", "Bias", "H0", "C0"))
    check_split(j, t)


def test_lstmp_with_clips():
    P = 2
    ins = {"Input": f32(B, T, 4 * H, seed=1), "Weight": f32(P, 4 * H, seed=2),
           "ProjWeight": f32(H, P, seed=3), "Bias": f32(1, 7 * H, seed=4)}
    j, t = both("lstmp", ins, {"cell_clip": 0.8, "proj_clip": 0.5,
                               "is_reverse": True},
                {"Projection": 1, "Cell": 1, "BatchGate": 1,
                 "BatchCellPreAct": 1, "BatchHidden": 1},
                grads=("Input", "Weight", "ProjWeight", "Bias"))
    check_split(j, t)


@pytest.mark.parametrize("rev,origin", [(False, True), (True, False)])
def test_gru_pre_projected(rev, origin):
    ins = {"Input": f32(B, T, 3 * H, seed=1), "Weight": f32(H, 3 * H, seed=2),
           "Bias": f32(1, 3 * H, seed=3), "H0": f32(B, H, seed=4),
           "Length": LEN}
    j, t = both("gru", ins, {"is_reverse": rev, "origin_mode": origin},
                {"BatchGate": 1, "BatchResetHiddenPrev": 1,
                 "BatchHidden": 1, "Hidden": 1},
                grads=("Input", "Weight", "Bias", "H0"))
    check_split(j, t)


@pytest.mark.parametrize("scalars", [False, True])
def test_attention_lstm(scalars):
    M, Dh = 4, 3
    ins = {"X": f32(B, T, M, seed=1), "C0": f32(B, Dh, seed=2),
           "H0": f32(B, Dh, seed=3),
           "AttentionWeight": f32(M + Dh, 1, seed=4),
           "AttentionBias": f32(1, 1, seed=5),
           "LSTMWeight": f32(Dh + M, 4 * Dh, seed=6, scale=0.5),
           "LSTMBias": f32(1, 4 * Dh, seed=7)}
    if scalars:
        ins["AttentionScalar"] = np.array([[0.7]], np.float32)
        ins["AttentionScalarBias"] = np.array([[0.1]], np.float32)
    j, t = both("attention_lstm", ins, {},
                {"Hidden": 1, "Cell": 1, "AttentionedX": 1,
                 "AttentionFCOut": 1, "LSTMX": 1, "LSTMOUT": 1},
                grads=("X", "AttentionWeight", "LSTMWeight", "LSTMBias",
                       "H0", "C0"))
    check_split(j, t)


@pytest.mark.parametrize("bidi", [False, True])
def test_cudnn_lstm_flat_weights(bidi):
    """The JAX package's flat layout [D·4H | H·4H | 4H | 4H] a direction,
    not cuDNN's own."""
    dirs = 2 if bidi else 1
    n = dirs * (D * 4 * H + H * 4 * H + 8 * H)
    ins = {"Input": f32(T, B, D, seed=1), "W": f32(n, seed=2, scale=0.4),
           "InitH": f32(dirs, B, H, seed=3), "InitC": f32(dirs, B, H, seed=4)}
    j, t = both("cudnn_lstm", ins, {"hidden_size": H, "is_bidirec": bidi},
                {"Out": 1, "last_h": 1, "last_c": 1},
                grads=("Input", "W", "InitH", "InitC"))
    check_split(j, t)


# -- (b) StaticRNN / DynamicRNN -------------------------------------------------


def _static_rnn(pkg, T_=4, B_=3, D_=5, H_=6, outer=False):
    L = pkg.layers
    blk = pkg.default_main_program().global_block()
    x = blk.create_var(name="x", shape=(T_, B_, D_), dtype="float32",
                       is_data=True, stop_gradient=False)
    ctx = None
    if outer:
        ctx = blk.create_var(name="ctx", shape=(B_, 2, H_), dtype="float32",
                             is_data=True, stop_gradient=False)
    rnn = L.StaticRNN()
    with rnn.step():
        word = rnn.step_input(x)
        prev = rnn.memory(shape=[-1, H_], batch_ref=word, ref_batch_dim_idx=0)
        hidden = L.fc([word, prev], H_, act="tanh", bias_attr=False)
        if outer:
            # an outer value through a named weight, as seq2seq's
            # attention reads the encoder output
            proj = L.fc(ctx, H_, num_flatten_dims=2, bias_attr=False,
                        param_attr=pkg.ParamAttr(name="outer.w"))
            hidden = L.elementwise_add(hidden, L.reduce_mean(proj, dim=1))
        rnn.update_memory(prev, hidden)
        rnn.step_output(hidden)
    out = rnn()
    loss = L.reduce_sum(L.elementwise_mul(out, out))
    return out, loss, x, ctx


def test_static_rnn_matches_numpy_and_trains_like_jax():
    T_, B_, D_, H_ = 4, 3, 5, 6
    xv = f32(T_, B_, D_, seed=0)

    def build(pkg):
        out, loss, _, _ = _static_rnn(pkg)
        pkg.optimizer.SGD(0.05).minimize(loss)
        return loss, [out]

    res = train_both(build, [{"x": xv}] * 4)
    assert_trained_alike(res)
    # the numpy oracle on the port's first step (JAX's startup weights)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out, _, _, _ = _static_rnn(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    w = np.concatenate([scope.get_numpy(n) for n in sorted(
        v.name for v in main.list_vars() if v.persistable)], 0)
    got, = exe.run(main, feed={"x": xv}, fetch_list=[out], scope=scope)
    h = np.zeros((B_, H_), np.float32)
    want = []
    for t in range(T_):
        h = np.tanh(np.concatenate([xv[t], h], 1) @ w)
        want.append(h)
    np.testing.assert_allclose(got, np.stack(want), rtol=FWD_RTOL,
                               atol=FWD_ATOL)


def test_outer_values_read_in_the_step_block_get_jax_gradients():
    T_, B_, D_, H_ = 4, 3, 5, 6
    feed = {"x": f32(T_, B_, D_, seed=1), "ctx": f32(B_, 2, H_, seed=2)}

    def build(pkg):
        out, loss, x, ctx = _static_rnn(pkg, outer=True)
        pkg.append_backward(loss)
        return loss, [out, x.name + "@GRAD", ctx.name + "@GRAD",
                      "outer.w@GRAD"]

    res = train_both(build, [feed])
    jl, _, je = res["jax"]
    tl, _, te = res["port"]
    np.testing.assert_allclose(tl, jl, rtol=FWD_RTOL, atol=FWD_ATOL)
    for k, (a, b) in enumerate(zip(je[0], te[0])):
        tol = (FWD_RTOL, FWD_ATOL) if k == 0 else (GRAD_RTOL, GRAD_ATOL)
        np.testing.assert_allclose(b, a, rtol=tol[0], atol=tol[1])
    assert np.abs(te[0][2]).max() > 0 and np.abs(te[0][3]).max() > 0


def _dynamic_rnn(pkg, B_, T_, D_, H_):
    L = pkg.layers
    blk = pkg.default_main_program().global_block()
    x = blk.create_var(name="x", shape=(B_, T_, D_), dtype="float32",
                       is_data=True, stop_gradient=False)
    ln = blk.create_var(name="len", shape=(B_,), dtype="int32", is_data=True)
    drnn = L.DynamicRNN()
    with drnn.block():
        word = drnn.step_input(x, length=ln)
        prev = drnn.memory(shape=[H_], value=0.0)
        hidden = L.fc([word, prev], H_, act="tanh", bias_attr=False)
        drnn.update_memory(prev, hidden)
        drnn.output(hidden)
    out = drnn()
    return out, L.reduce_sum(L.elementwise_mul(out, out))


def test_dynamic_rnn_masks_by_length_and_trains_like_jax():
    B_, T_, D_, H_ = 3, 5, 4, 4
    feed = {"x": f32(B_, T_, D_, seed=1),
            "len": np.array([5, 2, 3], np.int32)}

    def build(pkg):
        out, loss = _dynamic_rnn(pkg, B_, T_, D_, H_)
        pkg.optimizer.SGD(0.05).minimize(loss)
        return loss, [out]

    res = train_both(build, [feed] * 4)
    assert_trained_alike(res)
    out = res["port"][2][0][0]
    assert out.shape == (B_, T_, H_)
    for b, n in enumerate(feed["len"]):
        assert np.all(out[b, n:] == 0.0)          # exact zeros
        assert np.all(np.abs(out[b, :n]).sum(-1) > 0)


def test_dynamic_rnn_final_memory_is_frozen_bit_for_bit():
    """The final memory of a row equals its output at its last step,
    exactly (``where`` keeps the old value)."""
    main, startup = fluid.Program(), fluid.Program()
    B_, T_, D_, H_ = 4, 6, 3, 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out, _ = _dynamic_rnn(fluid, B_, T_, D_, H_)
    op = [o for o in main.global_block().ops if o.type == "recurrent"][0]
    fin = op.outputs["FinalMemories"][0]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    lens = np.array([6, 1, 3, 4], np.int32)
    o, m = exe.run(main, feed={"x": f32(B_, T_, D_, seed=3), "len": lens},
                   fetch_list=[out, fin], scope=scope)
    for b, n in enumerate(lens):
        np.testing.assert_array_equal(m[b], o[b, n - 1])


# -- (d) contrib stacks and cells -----------------------------------------------


def test_basic_lstm_gru_stacks_train_like_jax():
    """Twin of tests/test_contrib_layers.py::test_basic_lstm_gru_stacks,
    trained from JAX's startup values."""
    x = f32(3, 7, 5, seed=4)

    def build(pkg):
        from importlib import import_module

        cl = import_module(pkg.__name__ + ".contrib.layers")
        xv = pkg.layers.data("x", [7, 5])
        lout, lh, lc = cl.basic_lstm(xv, None, None, hidden_size=6,
                                     num_layers=2, bidirectional=True)
        gout, gh = cl.basic_gru(xv, None, hidden_size=6, num_layers=1)
        L = pkg.layers
        loss = L.elementwise_add(L.reduce_mean(L.square(lout)),
                                 L.reduce_mean(L.square(gout)))
        pkg.optimizer.Adam(1e-2).minimize(loss)
        return loss, [lout, lh, lc, gout, gh]

    res = train_both(build, [{"x": x}] * 3)
    assert_trained_alike(res)
    lout, lh, lc, gout, gh = res["port"][2][0]
    assert lout.shape == (3, 7, 12) and lh.shape == (4, 3, 6)
    assert lc.shape == (4, 3, 6)
    assert gout.shape == (3, 7, 6) and gh.shape == (1, 3, 6)
    np.testing.assert_allclose(gh[0], gout[:, -1], atol=1e-6, rtol=1e-6)


def test_basic_gru_follows_the_reference_unit_equations():
    """Twin of test_contrib_layers.py::
    test_basic_gru_matches_reference_unit_equations: h = u·h + (1−u)·c."""
    x = f32(2, 4, 3, seed=9)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        xv = fluid.layers.data("x", [4, 3])
        gout, _ = fluid.contrib.layers.basic_gru(xv, None, hidden_size=5)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    out, = exe.run(main, feed={"x": x}, fetch_list=[gout], scope=scope)
    by_shape = {scope.get_numpy(v.name).shape: scope.get_numpy(v.name)
                for v in main.list_vars() if v.persistable}
    wx, wh, b = by_shape[(3, 15)], by_shape[(5, 15)], by_shape[(15,)]
    sig = lambda v: 1 / (1 + np.exp(-v))
    h = np.zeros((2, 5), np.float32)
    for t in range(4):
        xp = x[:, t] @ wx + b
        rz = sig(xp[:, :10] + h @ wh[:, :10])
        r, u = np.split(rz, 2, 1)
        c = np.tanh(xp[:, 10:] + (r * h) @ wh[:, 10:])
        h = u * h + (1 - u) * c
    np.testing.assert_allclose(out[:, -1], h, atol=1e-5, rtol=1e-5)


def test_basic_units_match_jax_cells_on_the_same_weights():
    """BasicLSTMUnit / BasicGRUUnit (dygraph Layers in both packages)
    against JAX's cells, the port's parameters set to JAX's through
    ``set_dict(state_dict())``; the port's step also reaches its
    parameters through ``backward()``."""
    import paddle_tpu.contrib.layers as jcl
    from paddle_tpu.dygraph.base import to_variable

    import paddle_tpu_torch.dygraph as dg

    x, h, c = f32(2, 4, seed=6), f32(2, 3, seed=7), f32(2, 3, seed=8)
    jl = jcl.BasicLSTMUnit("lstm_u", 3, forget_bias=1.0)
    jh, jc = jl.forward(to_variable(x), to_variable(h), to_variable(c))
    jg = jcl.BasicGRUUnit("gru_u", 3)
    jout = jg.forward(to_variable(x), to_variable(h))
    with dg.guard(fluid.CPUPlace()):
        tl = fluid.contrib.layers.BasicLSTMUnit("lstm_u", 3, forget_bias=1.0)
        assert isinstance(tl, dg.Layer)
        tl(x, h, c)
        tl.set_dict(jl.state_dict())
        th, tc = tl(x, h, c)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh.value),
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc.value),
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
        fluid.layers.mean(th).backward()
        assert tl._weight.gradient is not None

        tg = fluid.contrib.layers.BasicGRUUnit("gru_u", 3)
        tg(x, h)
        assert sorted(tg.state_dict()) == sorted(jg.state_dict())
        tg.set_dict(jg.state_dict())
        tout = tg(x, h)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout.value),
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
