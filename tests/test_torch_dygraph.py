"""The port's imperative mode (``paddle_tpu_torch.dygraph``) against the
JAX package's (``paddle_tpu.dygraph``), on the CPU.

Both sides run the same script on the same inputs; the port's layers
take JAX's initial values through ``Layer.set_dict(jax_layer.
state_dict())`` (the packages draw different initial values).
Tolerances: forward values within rtol 1e-5 / atol 1e-6, gradients
within rtol 1e-4 / atol 1e-5, training trajectories (losses and
parameters after optimizer steps) within rtol 2e-4 / atol 2e-5, the
learning-rate schedulers exactly (both compute on the host in Python
floats).

* twins of the 6 tests of tests/test_dygraph.py, under their names;
* the VarBase sugar and ``__getitem__``; intermediate gradients;
  accumulation over two ``backward()`` calls and ``clear_gradients``; a
  second ``backward()`` over the same graph; ``no_grad`` and
  ``stop_gradient``; BatchNorm's running statistics in train and eval;
* SGD / Momentum / Adam / Lamb, 3 eager steps each; the 8 schedulers
  over 20 steps, and one driving Momentum's eager steps;
* ``save_dygraph`` by one package and ``load_dygraph`` by the other,
  both ways; ``TracedLayer`` on the CPU; ``DataParallel`` with no
  world; the ``fluid.layers`` bridge (``mean``, ``reshape``);
* the three faults of the reference, pinned beside the port's
  behaviour: equal initial weights of same-shape layers, dropped
  ``regularization`` / ``grad_clip``, and ``KeyError`` for Adagrad /
  RMSProp / Adamax (ROADMAP §C).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.dygraph as jdg
from paddle_tpu.dygraph.base import _trace as jtrace

import paddle_tpu_torch as fluid
import paddle_tpu_torch.dygraph as dg
from paddle_tpu_torch.dygraph.base import _trace

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5
CPU = fluid.CPUPlace()


def jguard():
    return jfluid.core.dygraph.dygraph_guard()


def tguard():
    return dg.guard(CPU)


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def carry(tlayer, jlayer):
    """The port's layer takes the JAX layer's values."""
    tlayer.set_dict(jlayer.state_dict())


def f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- twins of tests/test_dygraph.py -----------------------------------------


def test_linear_backward_matches_manual():
    x0 = np.ones((2, 3), "float32")
    with jguard():
        jx = jdg.to_variable(x0)
        jx.stop_gradient = False
        jl = jdg.Linear(3, 2)
        jloss = jtrace("reduce_sum", {"X": [jl(jx)]}, ["Out"],
                       {"reduce_all": True})[0]
        jloss.backward()
    with tguard():
        x = dg.to_variable(x0)
        x.stop_gradient = False
        layer = dg.Linear(3, 2)
        carry(layer, jl)
        out = layer(x)
        loss = _trace("reduce_sum", {"X": [out]}, ["Out"],
                      {"reduce_all": True})[0]
        loss.backward()
        w = layer.weight.numpy()
        close(x.gradient, np.tile(w.sum(1), (2, 1)), rtol=1e-5)
        close(layer.weight.gradient, np.full((3, 2), 2.0), rtol=1e-5)
    close(loss.numpy(), jloss.numpy())
    close(x.gradient, jx.gradient, GRAD_RTOL, GRAD_ATOL)
    close(layer.weight.gradient, jl.weight.gradient, GRAD_RTOL, GRAD_ATOL)
    close(layer.bias.gradient, jl.bias.gradient, GRAD_RTOL, GRAD_ATOL)


def _mnist_style(pkg, dgm, trace, guard, steps, init=None):
    rng = np.random.RandomState(0)
    W = rng.randn(8, 3)
    with guard():
        model = dgm.Sequential(dgm.Linear(8, 32, act="relu"),
                               dgm.Linear(32, 3))
        if init is not None:
            model.set_dict(init)
        sd0 = model.state_dict()
        opt = pkg.optimizer.Adam(1e-2)
        losses = []
        for _ in range(steps):
            xb = rng.randn(32, 8).astype("float32")
            yb = np.argmax(xb @ W, 1).reshape(-1, 1).astype("int64")
            out = model(dgm.to_variable(xb))
            _, l = trace("softmax_with_cross_entropy",
                         {"Logits": [out], "Label": [dgm.to_variable(yb)]},
                         ["Softmax", "Loss"], {})
            loss = trace("mean", {"X": [l]}, ["Out"], {})[0]
            loss.backward()
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
            losses.append(float(loss.numpy()))
        return losses, sd0, model.state_dict()


def test_sequential_mnist_style_training():
    jl, sd0, jsd = _mnist_style(jfluid, jdg, jtrace, jguard, 60)
    tl, _, tsd = _mnist_style(fluid, dg, _trace, tguard, 60, init=sd0)
    assert tl[-1] < tl[0] * 0.5, (tl[0], tl[-1])
    close(tl[:10], jl[:10], TRAIN_RTOL, TRAIN_ATOL)
    # 60 Adam steps: float32 differences grow along the way
    close(tl, jl, 1e-3, 1e-4)


def _bn_script(dgm, guard, init=None):
    x0 = np.random.RandomState(0).randn(4, 3, 5, 5).astype("float32")
    with guard():
        bn = dgm.BatchNorm(3)
        if init is not None:
            bn.set_dict(init)
        sd0 = bn.state_dict()
        x = dgm.to_variable(x0)
        bn.train()
        y1 = bn(x)
        stats1 = (bn._mean.numpy(), bn._variance.numpy())
        y1b = bn(x)
        bn.eval()
        y2 = bn(x)
        stats2 = (bn._mean.numpy(), bn._variance.numpy())
        return (y1.numpy(), y1b.numpy(), y2.numpy(), stats1, stats2, sd0)


def test_batchnorm_train_eval_modes():
    j = _bn_script(jdg, jguard)
    t = _bn_script(dg, tguard, init=j[5])
    y1, _, y2 = t[:3]
    close(y1.mean(axis=(0, 2, 3)), np.zeros(3), atol=1e-5)
    assert not np.allclose(y1, y2)
    for a, b in zip(t[:3], j[:3]):
        close(a, b)
    # running statistics: written back in train mode twice, kept in eval
    for a, b in zip(t[3] + t[4], j[3] + j[4]):
        close(a, b)
    assert sorted(t[5]) == sorted(j[5])


def test_state_dict_roundtrip(tmp_path):
    with tguard():
        model = dg.Sequential(dg.Linear(4, 5), dg.Linear(5, 2))
        sd = model.state_dict()
        dg.save_dygraph(sd, str(tmp_path / "m"))
        state, opt_state = dg.load_dygraph(str(tmp_path / "m"))
        assert opt_state is None
        model2 = dg.Sequential(dg.Linear(4, 5), dg.Linear(5, 2))
        model2.set_dict(state)
        for p1, p2 in zip(model.parameters(), model2.parameters()):
            np.testing.assert_array_equal(p1.numpy(), p2.numpy())
    with jguard():
        jm = jdg.Sequential(jdg.Linear(4, 5), jdg.Linear(5, 2))
        assert sorted(jm.state_dict()) == sorted(sd) == [
            "0.bias", "0.weight", "1.bias", "1.weight"]


def test_traced_layer_jit():
    x0 = np.ones((2, 3), "float32")
    with jguard():
        jm = jdg.Linear(3, 2)
        jout, _ = jdg.TracedLayer.trace(jm, [jdg.to_variable(x0)])
    with tguard():
        model = dg.Linear(3, 2)
        carry(model, jm)
        x = dg.to_variable(x0)
        out, traced = dg.TracedLayer.trace(model, [x])
        (out2,) = traced([x])
        np.testing.assert_allclose(out.numpy(), out2.numpy(), rtol=1e-6)
        assert out.stop_gradient and out2.stop_gradient
        # a later update of the layer reaches the traced call
        model.weight.set_value(model.weight.numpy() * 2)
        (out3,) = traced([x])
        close(out3.numpy(), model(x).numpy())
    close(out.numpy(), jout.numpy())


def test_no_grad_blocks_tape():
    with tguard():
        layer = dg.Linear(3, 2)
        x = dg.to_variable(np.ones((2, 3), "float32"))
        with dg.no_grad():
            out = layer(x)
        assert out.stop_gradient and not out.value.requires_grad
        assert out.value.grad_fn is None


# -- VarBase ------------------------------------------------------------------


def _sugar(dgm, trace, guard):
    a0, b0 = f32(3, 4, seed=1), f32(3, 4, seed=2)
    with guard():
        a, b = dgm.to_variable(a0), dgm.to_variable(b0)
        a.stop_gradient = b.stop_gradient = False
        outs = [a + b, a - b, a * b, a / (b * b + 1), -a, a + 2.0, 3.0 - a,
                2.0 * a, a * 0.5, 1.0 + a, a[1], a[:, 1:3], a[0, 2:],
                a[1:2, 1], a[..., 1], a.astype("float64")]
        total = None
        for o in outs[:-2]:
            s = trace("reduce_sum", {"X": [o]}, ["Out"],
                      {"reduce_all": True})[0]
            total = s if total is None else total + s
        total.backward()
        return ([o.numpy() for o in outs], a.gradient, b.gradient,
                [o.shape for o in outs], [o.stop_gradient for o in outs])


def test_varbase_sugar_and_getitem():
    j = _sugar(jdg, jtrace, jguard)
    t = _sugar(dg, _trace, tguard)
    for k, (a, b) in enumerate(zip(t[0], j[0])):
        close(a, b, what=f"output {k}")
    close(t[1], j[1], GRAD_RTOL, GRAD_ATOL)
    close(t[2], j[2], GRAD_RTOL, GRAD_ATOL)
    assert t[3] == j[3]
    # a[..., 1] is not a simple index: a detached copy in both
    assert t[4] == j[4]
    assert t[0][-1].dtype == np.float64


def test_varbase_info_and_values():
    with tguard():
        v = dg.to_variable(f32(2, 3))
        assert v.shape == (2, 3) and v.dtype == "float32"
        assert "VarBase(" in repr(v)
        ids = dg.to_variable(np.arange(4, dtype=np.int64))
        assert ids.dtype == "int64"      # JAX narrows it to int32
        assert dg.to_variable(np.ones(2)).dtype == "float32"
        d = v.detach()
        assert d.stop_gradient
        v.set_value(np.zeros((2, 3), "float32"))
        np.testing.assert_array_equal(v.numpy(), 0)
        w = dg.to_variable(torch.ones(2, dtype=torch.float64))
        assert w.dtype == "float32" and w.value.device.type == "cpu"
        assert dg.to_variable(v) is v


def _intermediates(dgm, trace, guard, init=None):
    with guard():
        l1, l2 = dgm.Linear(3, 4, act="tanh"), dgm.Linear(4, 2)
        if init is not None:
            l1.set_dict(init[0])
            l2.set_dict(init[1])
        x = dgm.to_variable(f32(5, 3))
        x.stop_gradient = False
        h = l1(x)
        y = l2(h)
        loss = trace("reduce_mean", {"X": [y * y]}, ["Out"],
                     {"reduce_all": True})[0]
        loss.backward()
        grads = [h.gradient, y.gradient, x.gradient]
        # gradients accumulate over a second backward of the same graph
        loss.backward()
        grads2 = [h.gradient, y.gradient, x.gradient, l1.weight.gradient]
        l1.clear_gradients()
        l2.clear_gradients()
        cleared = [l1.weight.gradient, l2.bias.gradient]
        return grads, grads2, cleared, (l1.state_dict(), l2.state_dict())


def test_intermediate_gradients_accumulate_until_cleared():
    """The first backward's gradients, intermediates included, equal
    JAX's; the second backward adds the same gradients again (JAX feeds
    the intermediates' accumulated gradients back in as their
    cotangents, so its leaves get more: pinned in
    ``test_second_backward_over_the_same_graph``)."""
    j = _intermediates(jdg, jtrace, jguard)
    t = _intermediates(dg, _trace, tguard, init=j[3])
    for a, b in zip(t[0], j[0]):
        close(a, b, GRAD_RTOL, GRAD_ATOL)
    for a, b in zip(t[1][:3], t[0]):
        close(a, 2 * b, GRAD_RTOL, GRAD_ATOL)
    assert t[2] == [None, None] and j[2] == [None, None]


def test_stop_gradient_and_no_grad():
    for guard, dgm, trace in ((jguard, jdg, jtrace), (tguard, dg, _trace)):
        with guard():
            x = dgm.to_variable(f32(2, 3))
            x.stop_gradient = True
            y = x * 2.0
            assert y.stop_gradient
            with pytest.raises(RuntimeError, match="stop_gradient"):
                x.backward()
            w = dgm.to_variable(f32(2, 3, seed=1))
            w.stop_gradient = False
            with dgm.no_grad():
                z = w * x
            assert z.stop_gradient
            # an op with stop_gradient (a label-less cast of an int) or a
            # no_grad slot (the label) stops there
            u = w * x
            assert not u.stop_gradient
            s = trace("reduce_sum", {"X": [u]}, ["Out"],
                      {"reduce_all": True})[0]
            s.backward()
            close(w.gradient, x.numpy())
            assert x.gradient is None


def test_batch_norm_statistics_do_not_break_the_backward():
    """The running statistics are replaced after the traced op, never
    written in place, so the step's saved tensors keep their versions:
    a backward after a second forward (eval mode, which reads them)
    works."""
    with tguard():
        bn = dg.BatchNorm(3)
        bn.eval()
        x = dg.to_variable(f32(2, 3, 4, 4))
        x.stop_gradient = False
        y = bn(x)
        bn.train()
        bn(x)                     # writes new running statistics
        s = _trace("reduce_sum", {"X": [y]}, ["Out"], {"reduce_all": True})[0]
        s.backward()
        assert x.gradient is not None


# -- optimizers ---------------------------------------------------------------


def _opt_script(pkg, dgm, trace, guard, make_opt, init=None, steps=3):
    with guard():
        model = dgm.Sequential(dgm.Linear(6, 5, act="tanh"),
                               dgm.Linear(5, 3))
        if init is not None:
            model.set_dict(init)
        sd0 = model.state_dict()
        opt = make_opt(pkg)
        losses = []
        for s in range(steps):
            x = dgm.to_variable(f32(4, 6, seed=10 + s))
            out = model(x)
            loss = trace("reduce_mean", {"X": [out * out]}, ["Out"],
                         {"reduce_all": True})[0]
            loss.backward()
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
            losses.append(float(loss.numpy()))
        return losses, sd0, model.state_dict()


OPTIMIZERS = {
    "sgd": lambda pkg: pkg.optimizer.SGD(0.1),
    "momentum": lambda pkg: pkg.optimizer.Momentum(0.1, momentum=0.9),
    "momentum_nesterov": lambda pkg: pkg.optimizer.Momentum(
        0.05, momentum=0.8, use_nesterov=True),
    "adam": lambda pkg: pkg.optimizer.Adam(0.01),
    "lamb": lambda pkg: pkg.optimizer.Lamb(0.01),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_eager_optimizer_steps_match_jax(name):
    jl, sd0, jsd = _opt_script(jfluid, jdg, jtrace, jguard, OPTIMIZERS[name])
    tl, _, tsd = _opt_script(fluid, dg, _trace, tguard, OPTIMIZERS[name],
                             init=sd0)
    close(tl, jl, TRAIN_RTOL, TRAIN_ATOL)
    assert sorted(tsd) == sorted(jsd)
    for k in jsd:
        close(tsd[k], jsd[k], TRAIN_RTOL, TRAIN_ATOL, what=k)
        assert not np.array_equal(tsd[k], sd0[k]), k


def test_learning_rate_decay_drives_eager_steps():
    def make(pkg):
        sched = pkg.dygraph.PiecewiseDecay([1, 2], [0.1, 0.05, 0.01])
        return pkg.optimizer.Momentum(sched, momentum=0.9)

    jl, sd0, jsd = _opt_script(jfluid, jdg, jtrace, jguard, make, steps=4)
    tl, _, tsd = _opt_script(fluid, dg, _trace, tguard, make, init=sd0,
                             steps=4)
    close(tl, jl, TRAIN_RTOL, TRAIN_ATOL)
    for k in jsd:
        close(tsd[k], jsd[k], TRAIN_RTOL, TRAIN_ATOL, what=k)


def test_eager_minimize_needs_a_parameter_list():
    with tguard():
        layer = dg.Linear(2, 2)
        loss = fluid.layers.mean(layer(dg.to_variable(f32(1, 2))))
        loss.backward()
        with pytest.raises(ValueError, match="parameter_list"):
            fluid.optimizer.SGD(0.1).minimize(loss)


SCHEDULERS = {
    "piecewise": lambda m: m.PiecewiseDecay([3, 8, 15], [1.0, 0.5, 0.1,
                                                         0.01]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.5, 4, 0.3),
    "natural_exp_stair": lambda m: m.NaturalExpDecay(0.5, 4, 0.3, True),
    "exponential": lambda m: m.ExponentialDecay(0.5, 5, 0.7, True),
    "inverse_time": lambda m: m.InverseTimeDecay(0.5, 3, 0.2),
    "polynomial": lambda m: m.PolynomialDecay(0.5, 12, 0.01, power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(0.5, 6, 0.01,
                                                    cycle=True),
    "cosine": lambda m: m.CosineDecay(0.5, 3, 7),
    "noam": lambda m: m.NoamDecay(512, 6),
    "begin_step": lambda m: m.ExponentialDecay(0.5, 5, 0.7, begin=4,
                                               step=2),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_schedulers_over_20_steps(name):
    j, t = SCHEDULERS[name](jdg), SCHEDULERS[name](dg)
    jv = [j() for _ in range(20)]
    tv = [t() for _ in range(20)]
    assert tv == jv
    assert t.step_num == j.step_num


# -- checkpoints, capture, DataParallel, the bridge ---------------------------


def test_save_by_one_package_load_by_the_other(tmp_path):
    with jguard():
        jm = jdg.Sequential(jdg.Linear(4, 3), jdg.BatchNorm(3))
        jdg.save_dygraph(jm.state_dict(), str(tmp_path / "jax"))
    with tguard():
        tm = dg.Sequential(dg.Linear(4, 3), dg.BatchNorm(3))
        state, _ = dg.load_dygraph(str(tmp_path / "jax"))
        tm.set_dict(state)
        for k, v in jm.state_dict().items():
            np.testing.assert_array_equal(tm.state_dict()[k], v)
        tm.set_dict({"0.weight": f32(4, 3, seed=3)})
        dg.save_dygraph(tm.state_dict(), str(tmp_path / "torch"))
    with jguard():
        state, _ = jdg.load_dygraph(str(tmp_path / "torch"))
        jm2 = jdg.Sequential(jdg.Linear(4, 3), jdg.BatchNorm(3))
        jm2.set_dict(state)
        for k, v in tm.state_dict().items():
            np.testing.assert_array_equal(jm2.state_dict()[k], v)


def test_traced_layer_save_inference_model(tmp_path):
    with tguard():
        m = dg.Sequential(dg.Linear(3, 4), dg.Linear(4, 2))
        _, traced = dg.TracedLayer.trace(m, [f32(2, 3)])
        traced.save_inference_model(str(tmp_path / "t"))
    with jguard():
        jm = jdg.Sequential(jdg.Linear(3, 4), jdg.Linear(4, 2))
        jm.set_dict(m.state_dict())
        _, jt = jdg.TracedLayer.trace(jm, [jdg.to_variable(f32(2, 3))])
        jt.save_inference_model(str(tmp_path / "j"))
    a = np.load(tmp_path / "t" / "__traced_params__.npz")
    b = np.load(tmp_path / "j" / "__traced_params__.npz")
    assert sorted(a.files) == sorted(b.files) == ["p0", "p1", "p2", "p3"]
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_to_static_on_the_cpu():
    def body(pkg_dg, guard):
        with guard():
            lin = pkg_dg.Linear(3, 2)

            @pkg_dg.to_static
            def f(x):
                return lin(x) * 2.0

            return lin, f

    jlin, jf = body(jdg, jguard)
    tlin, tf = body(dg, tguard)
    carry(tlin, jlin)
    with jguard():
        jout = jf(jdg.to_variable(f32(4, 3)))
    with tguard():
        tout = tf(dg.to_variable(f32(4, 3)))
        assert tout.stop_gradient
    close(tout.numpy(), jout.numpy())


def test_data_parallel_without_a_world():
    for guard, dgm in ((jguard, jdg), (tguard, dg)):
        with guard():
            inner = dgm.Linear(3, 2)
            dp = dgm.DataParallel(inner)
            assert dp.nranks == 1
            loss = dgm.to_variable(f32(1))
            assert dp.scale_loss(loss) is loss
            dp.apply_collective_grads()
            assert sorted(dp.state_dict()) == ["bias", "weight"]
            dp.set_dict({"weight": np.zeros((3, 2), "float32")})
            np.testing.assert_array_equal(inner.weight.numpy(), 0)
            assert len(dp.parameters()) == 2


def test_layers_bridge_mean_and_reshape():
    x0 = f32(2, 6)
    outs = []
    for guard, pkg in ((jguard, jfluid), (tguard, fluid)):
        with guard():
            assert pkg.in_dygraph_mode()
            x = pkg.dygraph.to_variable(x0)
            x.stop_gradient = False
            r = pkg.layers.reshape(x, [3, 4], act="relu")
            m = pkg.layers.mean(r)
            m.backward()
            outs.append((r.numpy(), m.numpy(), x.gradient))
        assert not pkg.in_dygraph_mode()
    for a, b in zip(outs[1], outs[0]):
        close(a, b)


def test_mode_switches():
    for dgm, pkg, place in ((jdg, jfluid, None), (dg, fluid, CPU)):
        assert not dgm.enabled()
        dgm.enable_dygraph(place)
        try:
            assert dgm.enabled() and pkg.in_dygraph_mode()
            with dgm.no_grad():
                assert dgm.enabled()
        finally:
            dgm.disable_dygraph()
        assert not dgm.enabled() and not pkg.in_dygraph_mode()
    dg.enable_dygraph(CPU)
    try:
        assert dg.to_variable(f32(2)).value.device.type == "cpu"
    finally:
        dg.disable_dygraph()


def test_parallel_env_reads_the_launcher_contract(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6171")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       "127.0.0.1:6170,127.0.0.1:6171")
    j, t = jdg.ParallelEnv(), dg.ParallelEnv()
    for attr in ("rank", "nranks", "world_size", "current_endpoint",
                 "trainer_endpoints"):
        assert getattr(t, attr) == getattr(j, attr), attr
    with tguard():
        dp = dg.DataParallel(dg.Linear(2, 2))
        assert dp.nranks == 2
        loss = dg.to_variable(np.array([3.0], np.float32))
        np.testing.assert_array_equal(dp.scale_loss(loss).numpy(), [1.5])


@pytest.mark.skipif(torch.cuda.is_available(), reason="the box has a GPU")
def test_guard_with_no_place_raises_without_a_gpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with dg.guard():
            pass
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dg.enable_dygraph()
    assert not dg.enabled()


def test_layer_api_matches_jax():
    def build(dgm):
        class Net(dgm.Layer):
            def __init__(self):
                super().__init__("net")
                self.fc = dgm.Linear(3, 4)
                self.blocks = dgm.LayerList([dgm.Linear(4, 4),
                                             dgm.Linear(4, 2)])
                self.extra = dgm.ParameterList(
                    [self.create_parameter([2], is_bias=True)])
                self.add_sublayer("bn", dgm.BatchNorm(2))
                self.add_parameter("scale", self.create_parameter(
                    [1], default_initializer=None))

            def forward(self, x):
                x = self.fc(x)
                for b in self.blocks:
                    x = b(x)
                return self.bn(x + self.extra[0])

        return Net()

    with jguard():
        jn = build(jdg)
        jsd = jn.state_dict()
        jnames = [n for n, _ in jn.named_parameters()]
        jsubs = len(jn.sublayers())
        jn.eval()
        jtrain = [s.training for s in jn.sublayers()]
        jout = jn(f32(5, 3)).numpy()
    with tguard():
        tn = build(dg)
        tn.set_dict(jsd)
        assert sorted(tn.state_dict()) == sorted(jsd)
        assert [n for n, _ in tn.named_parameters()] == jnames
        assert len(tn.sublayers()) == jsubs
        assert len(tn.parameters()) == len(jn.parameters())
        assert tn.full_name() == jn.full_name() == "net"
        tn.eval()
        assert [s.training for s in tn.sublayers()] == jtrain
        tout = tn(f32(5, 3)).numpy()
        assert len(tn.blocks) == 2 and len(tn.extra) == 1
        assert isinstance(tn.blocks[1], dg.Linear)
    close(tout, jout)


def test_the_port_exports_what_jax_exports():
    missing = [n for n in dir(jdg) if not n.startswith("_")
               and not hasattr(dg, n)]
    assert not missing, missing
    nn_missing = [n for n in dir(jdg.nn) if n[:1].isupper()
                  and not hasattr(dg.nn, n)]
    assert not nn_missing, nn_missing
    assert fluid.dygraph is dg


def test_second_backward_over_the_same_graph():
    """A second ``backward()`` over a kept graph works in both packages.
    A fault of the reference, not copied: JAX's engine starts the second
    walk from the gradients the intermediates kept from the first, so
    d sum(x*x) / dx reads 2x + 4x = 6x there; the port adds 2x again."""
    got = []
    for guard, dgm, trace in ((jguard, jdg, jtrace), (tguard, dg, _trace)):
        with guard():
            x = dgm.to_variable(f32(3))
            x.stop_gradient = False
            m = x * x
            y = trace("reduce_sum", {"X": [m]}, ["Out"],
                      {"reduce_all": True})[0]
            y.backward()
            close(x.gradient, 2 * x.numpy())
            y.backward()
            got.append((x.gradient, m.gradient, x.numpy()))
    (jx, jm, x0), (tx, tm, _) = got
    close(jx, 6 * x0)
    close(tx, 4 * x0)
    close(tm, jm)


# -- the three faults of the reference, not copied -----------------------------


def test_fault1_same_shape_layers_differ_in_the_port():
    with jguard():
        a, b = jdg.Linear(4, 4), jdg.Linear(4, 4)
        np.testing.assert_array_equal(a.weight.numpy(), b.weight.numpy())
    with tguard():
        a, b = dg.Linear(4, 4), dg.Linear(4, 4)
        assert not np.allclose(a.weight.numpy(), b.weight.numpy())
    # one generator a mode, seeded from the startup program's seed: the
    # same draws again in a new guard
    with tguard():
        c = dg.Linear(4, 4)
    np.testing.assert_array_equal(c.weight.numpy(), a.weight.numpy())


def _momentum_updates(pkg, dgm, trace, guard, init, **kw):
    with guard():
        layer = dgm.Linear(3, 2)
        layer.set_dict(init)
        opt = pkg.optimizer.Momentum(0.1, momentum=0.9, **kw)
        for s in range(3):
            loss = trace("reduce_mean", {"X": [layer(dgm.to_variable(
                f32(4, 3, seed=s)))]}, ["Out"], {"reduce_all": True})[0]
            loss.backward()
            opt.minimize(loss, parameter_list=layer.parameters())
            layer.clear_gradients()
        return layer.state_dict()


def test_fault2_regularization_and_grad_clip_are_refused():
    with jguard():
        init = jdg.Linear(3, 2).state_dict()
    plain = _momentum_updates(jfluid, jdg, jtrace, jguard, init)
    for kw in ({"regularization": jfluid.regularizer.L2Decay(10.0)},
               {"grad_clip": jfluid.clip.GradientClipByGlobalNorm(1e-6)}):
        got = _momentum_updates(jfluid, jdg, jtrace, jguard, init, **kw)
        for k in plain:   # JAX drops them without a word
            np.testing.assert_array_equal(got[k], plain[k])
    for kw, what in (({"regularization": fluid.regularizer.L2Decay(10.0)},
                      "regularization"),
                     ({"grad_clip": fluid.clip.GradientClipByGlobalNorm(
                         1e-6)}, "grad_clip")):
        with pytest.raises(ValueError, match=what):
            _momentum_updates(fluid, dg, _trace, tguard, init, **kw)
    with tguard():
        layer = dg.Linear(3, 2)
        loss = fluid.layers.mean(layer(dg.to_variable(f32(2, 3))))
        loss.backward()
        with pytest.raises(ValueError, match="grad_clip"):
            fluid.optimizer.SGD(0.1).minimize(
                loss, parameter_list=layer.parameters(),
                grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0))


@pytest.mark.parametrize("name", ["Adagrad", "RMSProp", "Adamax"])
def test_fault3_optimizers_without_an_eager_state_say_so(name):
    with jguard():
        layer = jdg.Linear(3, 2)
        loss = jtrace("mean", {"X": [layer(jdg.to_variable(f32(2, 3)))]},
                      ["Out"], {})[0]
        loss.backward()
        with pytest.raises(KeyError, match="Moment"):
            getattr(jfluid.optimizer, name)(0.1).minimize(
                loss, parameter_list=layer.parameters())
    with tguard():
        layer = dg.Linear(3, 2)
        loss = fluid.layers.mean(layer(dg.to_variable(f32(2, 3))))
        loss.backward()
        opt = getattr(fluid.optimizer, name)(0.1)
        with pytest.raises(NotImplementedError, match=type(opt).__name__):
            opt.minimize(loss, parameter_list=layer.parameters())


@pytest.mark.parametrize("name", ["LarsMomentum", "DecayedAdagrad",
                                  "Adadelta", "Ftrl", "Dpsgd",
                                  "DGCMomentumOptimizer"])
def test_every_other_optimizer_refuses_eager_steps(name):
    with tguard():
        layer = dg.Linear(3, 2)
        loss = fluid.layers.mean(layer(dg.to_variable(f32(2, 3))))
        loss.backward()
        cls = getattr(fluid.optimizer, name)
        opt = cls(0.1, 0.9) if "Momentum" in name else cls(0.1)
        with pytest.raises(NotImplementedError, match=type(opt).__name__):
            opt.minimize(loss, parameter_list=layer.parameters())
