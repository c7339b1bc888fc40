"""The port's other optimizers and the learning-rate schedules' op
lowerings against the JAX package, on the CPU.

(a) Each optimizer class of ``paddle_tpu/optimizer.py:368-838`` trains a
    two-fc net 5 steps in both packages from JAX's startup values
    (``io.load_scope_arrays``): both programs hold the same persistables
    (parameters and every accumulator, by name), and the losses and
    every persistable after the steps agree at ``TRAIN_RTOL`` /
    ``TRAIN_ATOL``, the training tolerance of the other parity files
    (a float32 sum in another order moves the last bits). Lamb's
    ``exclude_from_weight_decay_fn`` and Dpsgd at ``sigma=0`` are cases.
(b) Every new optimizer lowering (``paddle_tpu/ops/optim.py:111-497``)
    on the same random state, op by op, at ``OP_RTOL`` / ``OP_ATOL``;
    dpsgd's noise by its statistics (its bits come from the op's
    ``torch.Generator``, JAX's from its PRNG).
(c) The schedules' ops (``exp``, ``floor``, ``ceil``, ``cos``, ``pow``,
    ``elementwise_pow``, ``where``, the comparisons, ``increment``,
    ``cast``) through both Executors, with their gradients where JAX has
    them (``ceil``, ``cos`` and ``pow`` as in tests/test_op_sweep.py), at
    ``OP_RTOL`` / ``OP_ATOL``.
(d) ``lookup_table_grad`` with heavily repeated ids (the deterministic
    segment sum) equals JAX's scatter-add.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core import registry as jregistry
from paddle_tpu.core.framework import unique_name as jax_unique_name

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.io import load_scope_arrays

TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5
OP_RTOL, OP_ATOL = 1e-6, 1e-6
STEPS, BATCH = 5, 16


def _names(pkg):
    return jax_unique_name if pkg is jfluid else fluid.unique_name


def _two_fc(pkg, make_opt):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup), _names(pkg).guard():
        x = pkg.layers.data("x", [8])
        y = pkg.layers.data("y", [1], dtype="int64")
        h = pkg.layers.fc(x, 16, act="relu")
        logits = pkg.layers.fc(h, 4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        make_opt(pkg).minimize(loss)
    return main, startup, loss


def _feeds(n=STEPS, seed=3):
    """One batch fed n times (the loss must fall on it)."""
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(BATCH, 8).astype("float32"),
             "y": rng.randint(0, 4, (BATCH, 1)).astype("int64")}] * n


def _persistables(program):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and not v.is_data)


def train_both(make_opt, feeds):
    """(JAX losses, JAX final persistables, port losses, port final)."""
    jmain, jstart, jloss = _two_fc(jfluid, make_opt)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(jmain)}
        jl = [float(np.asarray(exe.run(jmain, feed=f, fetch_list=[jloss])[0]))
              for f in feeds]
        jfinal = {n: np.asarray(scope.find_var(n))
                  for n in _persistables(jmain)}
    tmain, _, tloss = _two_fc(fluid, make_opt)
    assert _persistables(tmain) == sorted(init)
    tscope = fluid.Scope()
    load_scope_arrays(tscope, init, tmain, "cpu")
    texe = fluid.Executor(fluid.CPUPlace())
    tl = [float(texe.run(tmain, feed=f, fetch_list=[tloss],
                         scope=tscope)[0]) for f in feeds]
    tfinal = {n: tscope.get_numpy(n) for n in _persistables(tmain)}
    return jl, jfinal, tl, tfinal


def _no_decay_on_biases(p):
    return p.name.endswith(".b_0")


OPTIMIZERS = {
    "adagrad": lambda pkg: pkg.optimizer.AdagradOptimizer(
        0.1, initial_accumulator_value=0.1),
    "adamax": lambda pkg: pkg.optimizer.AdamaxOptimizer(0.01),
    "dpsgd_sigma0": lambda pkg: pkg.optimizer.DpsgdOptimizer(
        0.1, clip=0.5, batch_size=4.0, sigma=0.0),
    "decayed_adagrad": lambda pkg: pkg.optimizer.DecayedAdagradOptimizer(0.1),
    "adadelta": lambda pkg: pkg.optimizer.AdadeltaOptimizer(1.0, rho=0.9),
    "rmsprop": lambda pkg: pkg.optimizer.RMSPropOptimizer(0.01),
    "rmsprop_centered_momentum": lambda pkg: pkg.optimizer.RMSPropOptimizer(
        0.01, momentum=0.9, centered=True),
    "ftrl": lambda pkg: pkg.optimizer.FtrlOptimizer(0.1, l1=1e-3, l2=1e-3),
    "ftrl_lr_power": lambda pkg: pkg.optimizer.FtrlOptimizer(
        0.1, l1=1e-3, lr_power=-0.3),
    "lamb": lambda pkg: pkg.optimizer.LambOptimizer(0.01),
    "lamb_exclude": lambda pkg: pkg.optimizer.LambOptimizer(
        0.01, lamb_weight_decay=0.1,
        exclude_from_weight_decay_fn=_no_decay_on_biases),
    "lars_momentum": lambda pkg: pkg.optimizer.LarsMomentumOptimizer(
        0.1, momentum=0.9),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_trains_as_jax(name):
    jl, jfinal, tl, tfinal = train_both(OPTIMIZERS[name], _feeds())
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    assert sorted(tfinal) == sorted(jfinal)
    for n in jfinal:
        np.testing.assert_allclose(tfinal[n], jfinal[n], rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, err_msg=n)
    assert tl[-1] < tl[0]


def test_lamb_exclude_fn_takes_weight_decay_off():
    """The excluded parameters' lamb ops carry weight_decay 0, the rest
    the optimizer's, in both packages."""
    for pkg in (jfluid, fluid):
        main, _, _ = _two_fc(pkg, OPTIMIZERS["lamb_exclude"])
        wd = {op.inputs["Param"][0]: op.attrs["weight_decay"]
              for op in main.global_block().ops if op.type == "lamb"}
        assert wd == {"fc_0.b_0": 0.0, "fc_0.w_0": 0.1, "fc_1.b_0": 0.0,
                      "fc_1.w_0": 0.1}


def test_lamb_stays_unfused_and_aliases_exist():
    fluid.set_flags({"optimizer_fuse": "on"})
    try:
        main, _, _ = _two_fc(fluid, OPTIMIZERS["lamb"])
    finally:
        fluid.set_flags({"optimizer_fuse": "auto"})
    types = [op.type for op in main.global_block().ops]
    assert types.count("lamb") == 4 and "fused_adam" not in types
    for alias, cls in (("Adagrad", "AdagradOptimizer"),
                       ("Adamax", "AdamaxOptimizer"),
                       ("Dpsgd", "DpsgdOptimizer"),
                       ("DecayedAdagrad", "DecayedAdagradOptimizer"),
                       ("Adadelta", "AdadeltaOptimizer"),
                       ("RMSProp", "RMSPropOptimizer"),
                       ("Ftrl", "FtrlOptimizer"), ("Lamb", "LambOptimizer"),
                       ("LarsMomentum", "LarsMomentumOptimizer")):
        assert getattr(fluid.optimizer, alias) is \
            getattr(fluid.optimizer, cls)
    assert fluid.optimizer.PipelineOptimizer(
        fluid.optimizer.SGD(0.1), num_microbatches=2)._num_microbatches == 2


# -- (b) the optimizer lowerings op by op ------------------------------------


class _Op:
    def __init__(self, type, attrs):
        self.type = type
        self.attrs = dict(attrs)


def _state(rng, shape=(6, 5)):
    f = lambda: rng.randn(*shape).astype("float32")  # noqa: E731
    pos = lambda: (rng.rand(*shape) + 0.1).astype("float32")  # noqa: E731
    return f, pos


def _op_case(name, rng):
    f, pos = _state(rng)
    lr = np.array([0.05], "float32")
    cases = {
        "lars_momentum": ({"Param": f(), "Grad": f(), "Velocity": f(),
                           "LearningRate": lr},
                          {"mu": 0.9, "lars_coeff": 0.01,
                           "lars_weight_decay": 5e-4}),
        "adagrad": ({"Param": f(), "Grad": f(), "Moment": pos(),
                     "LearningRate": lr}, {"epsilon": 1e-6}),
        "decayed_adagrad": ({"Param": f(), "Grad": f(), "Moment": pos(),
                             "LearningRate": lr},
                            {"decay": 0.9, "epsilon": 1e-6}),
        "adadelta": ({"Param": f(), "Grad": f(), "AvgSquaredGrad": pos(),
                      "AvgSquaredUpdate": pos()},
                     {"rho": 0.9, "epsilon": 1e-6}),
        "adamax": ({"Param": f(), "Grad": f(), "LearningRate": lr,
                    "Moment": f(), "InfNorm": pos(),
                    "Beta1Pow": np.array([0.81], "float32")},
                   {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        "rmsprop": ({"Param": f(), "Grad": f(), "Moment": f(),
                     "MeanSquare": pos() + 1.0, "MeanGrad": f() * 0.1,
                     "LearningRate": lr},
                    {"epsilon": 1e-6, "decay": 0.9, "momentum": 0.5,
                     "centered": True}),
        "ftrl": ({"Param": f(), "SquaredAccumulator": pos(),
                  "LinearAccumulator": f(), "Grad": f(), "LearningRate": lr},
                 {"l1": 1e-3, "l2": 1e-2, "lr_power": -0.5}),
        "lamb": ({"Param": f(), "Grad": f(), "LearningRate": lr,
                  "Moment1": f(), "Moment2": pos(),
                  "Beta1Pow": np.array([0.9], "float32"),
                  "Beta2Pow": np.array([0.999], "float32")},
                 {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                  "weight_decay": 0.01}),
        "proximal_gd": ({"Param": f(), "Grad": f(), "LearningRate": lr},
                        {"l1": 0.3, "l2": 0.1}),
        "proximal_adagrad": ({"Param": f(), "Moment": pos(), "Grad": f(),
                              "LearningRate": lr}, {"l1": 0.3, "l2": 0.1}),
    }
    return cases[name]


@pytest.mark.parametrize("name", ["lars_momentum", "adagrad",
                                  "decayed_adagrad", "adadelta", "adamax",
                                  "rmsprop", "ftrl", "lamb", "proximal_gd",
                                  "proximal_adagrad"])
def test_optimizer_op_matches_jax(name):
    ins, attrs = _op_case(name, np.random.RandomState(11))
    op = _Op(name, attrs)
    jout = jregistry.get_op_def(name).lower(
        None, op, {k: [jnp.asarray(v)] for k, v in ins.items()})
    tout = tregistry.get_op_def(name).lower(
        None, op, {k: [torch.from_numpy(v.copy())] for k, v in ins.items()})
    assert sorted(tout) == sorted(jout)
    for slot in jout:
        np.testing.assert_allclose(tout[slot][0].numpy(),
                                   np.asarray(jout[slot][0]), rtol=OP_RTOL,
                                   atol=OP_ATOL, err_msg=slot)


def test_dpsgd_noise_statistics_and_sigma0():
    """At sigma 0 the update is JAX's; with noise, ParamOut minus the
    noiseless update is lr * sigma * clip / batch_size times a standard
    normal (mean and std within 4 sigma of their sampling error over
    40,000 entries), and two runs of one step draw the same noise."""
    rng = np.random.RandomState(2)
    p = rng.randn(200, 200).astype("float32")
    g = rng.randn(200, 200).astype("float32")
    lr = np.array([0.1], "float32")
    attrs = {"clip": 2.0, "batch_size": 8.0, "sigma": 0.0}

    class _Ctx:
        def op_key(self, op):
            return jax.random.PRNGKey(0)

    def port(attrs, step=1):
        ctx = tregistry.LoweringContext("cpu", seed=3, step=step)
        return tregistry.get_op_def("dpsgd").lower(
            ctx, _Op("dpsgd", dict(attrs, op_ident=7)),
            {"Param": [torch.from_numpy(p)], "Grad": [torch.from_numpy(g)],
             "LearningRate": [torch.from_numpy(lr)]})["ParamOut"][0].numpy()

    jout = jregistry.get_op_def("dpsgd").lower(
        _Ctx(), _Op("dpsgd", attrs), {"Param": [jnp.asarray(p)],
                                      "Grad": [jnp.asarray(g)],
                                      "LearningRate": [jnp.asarray(lr)]})
    base = port(attrs)
    np.testing.assert_allclose(base, np.asarray(jout["ParamOut"][0]),
                               rtol=OP_RTOL, atol=OP_ATOL)
    noisy = dict(attrs, sigma=1.5)
    z = (base - port(noisy)) / (0.1 * 1.5 * 2.0 / 8.0)
    n = z.size
    assert abs(z.mean()) < 4 / np.sqrt(n)
    assert abs(z.std() - 1.0) < 4 / np.sqrt(2 * n)
    np.testing.assert_array_equal(port(noisy), port(noisy))
    assert not np.array_equal(port(noisy, step=1), port(noisy, step=2))


@pytest.mark.parametrize("name", ["lars_momentum", "adagrad",
                                  "decayed_adagrad", "adadelta", "adamax",
                                  "rmsprop", "ftrl", "lamb"])
def test_new_optimizer_ops_take_selected_rows_as_jax(name):
    """A SelectedRows gradient (rows 4, 1, 4: one repeated): adagrad's
    sparse path, the others densify (``_densify_grad``), all as JAX's
    lowerings do."""
    from paddle_tpu.core.selected_rows import SelectedRows as JSR
    from paddle_tpu_torch.core.selected_rows import SelectedRows

    ins, attrs = _op_case(name, np.random.RandomState(12))
    rows = np.array([4, 1, 4])
    vals = np.random.RandomState(13).randn(3, 5).astype("float32")
    op = _Op(name, attrs)
    jins = {k: [jnp.asarray(v)] for k, v in ins.items()}
    jins["Grad"] = [JSR(jnp.asarray(rows), jnp.asarray(vals), 6)]
    tins = {k: [torch.from_numpy(v.copy())] for k, v in ins.items()}
    tins["Grad"] = [SelectedRows(torch.from_numpy(rows),
                                 torch.from_numpy(vals), 6)]
    jout = jregistry.get_op_def(name).lower(None, op, jins)
    tout = tregistry.get_op_def(name).lower(None, op, tins)
    assert sorted(tout) == sorted(jout)
    for slot in jout:
        np.testing.assert_allclose(tout[slot][0].numpy(),
                                   np.asarray(jout[slot][0]), rtol=OP_RTOL,
                                   atol=OP_ATOL, err_msg=slot)


# -- (c) the schedules' ops through both Executors -------------------------


def _run_program(pkg, build, feeds, grads):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), _names(pkg).guard():
        vars_ = {n: pkg.layers.data(n, list(v.shape), dtype=str(v.dtype),
                                    append_batch_size=False,
                                    stop_gradient=n not in grads)
                 for n, v in feeds.items()}
        out = build(pkg, vars_)
        fetch = [out]
        if grads:
            w = pkg.layers.data("w", list(feeds[grads[0]].shape),
                                append_batch_size=False)
            loss = pkg.layers.mean(pkg.layers.elementwise_mul(out, w))
            pkg.append_backward(loss)
            fetch += [f"{n}@GRAD" for n in grads]
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup)
    return [np.asarray(v) for v in exe.run(main, feed=feeds,
                                           fetch_list=fetch)]


def _unary(name, **kw):
    return lambda pkg, v: getattr(pkg.layers, name)(v["x"], **kw)


F = np.random.RandomState(0).randn(3, 4).astype("float32") * 2
POS = np.abs(F) + 0.5

SCHEDULE_OPS = {
    "exp": (_unary("exp"), {"x": F}, ["x"]),
    "floor": (_unary("floor"), {"x": F}, []),
    "ceil": (_unary("ceil"), {"x": F}, ["x"]),
    "cos": (_unary("cos"), {"x": F}, ["x"]),
    "pow": (_unary("pow", factor=2.0), {"x": POS}, ["x"]),
    "pow_neg_half": (_unary("pow", factor=-0.5), {"x": POS}, ["x"]),
    "elementwise_pow": (
        lambda pkg, v: pkg.layers.elementwise_pow(v["x"], v["y"]),
        {"x": POS, "y": F}, ["x", "y"]),
    "where": (lambda pkg, v: pkg.layers.where(
        pkg.layers.less_than(v["x"], v["y"]), v["x"], v["y"]),
        {"x": F, "y": F[::-1].copy()}, ["x", "y"]),
    "cast": (lambda pkg, v: pkg.layers.cast(v["x"], "int32"), {"x": F}, []),
}


@pytest.mark.parametrize("name", sorted(SCHEDULE_OPS))
def test_schedule_op_matches_jax(name):
    build, feeds, grads = SCHEDULE_OPS[name]
    feeds = dict(feeds)
    if grads:
        feeds["w"] = np.random.RandomState(1).randn(
            *feeds[grads[0]].shape).astype("float32")
    want = _run_program(jfluid, build, feeds, grads)
    got = _run_program(fluid, build, feeds, grads)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=OP_RTOL, atol=OP_ATOL)


@pytest.mark.parametrize("name", ["equal", "not_equal", "less_than",
                                  "less_equal", "greater_than",
                                  "greater_equal", "logical_and",
                                  "logical_or", "logical_xor"])
def test_compare_op_matches_jax(name):
    """With a broadcast Y along ``axis`` and ties between X and Y."""
    rng = np.random.RandomState(4)
    x = rng.randint(-2, 3, (2, 3, 4)).astype("float32")
    y = rng.randint(-2, 3, (3,)).astype("float32")
    if name.startswith("logical"):
        x, y = x > 0, y > 0
    op = _Op(name, {"axis": 1})
    jout = jregistry.get_op_def(name).lower(
        None, op, {"X": [jnp.asarray(x)], "Y": [jnp.asarray(y)]})
    tout = tregistry.get_op_def(name).lower(
        None, op, {"X": [torch.from_numpy(x)], "Y": [torch.from_numpy(y)]})
    np.testing.assert_array_equal(tout["Out"][0].numpy(),
                                  np.asarray(jout["Out"][0]))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_increment_matches_jax(dtype):
    x = np.array([41], dtype)  # int32: JAX runs without x64
    op = _Op("increment", {"step": 2.0})
    jout = jregistry.get_op_def("increment").lower(
        None, op, {"X": [jnp.asarray(x)]})["Out"][0]
    tout = tregistry.get_op_def("increment").lower(
        None, op, {"X": [torch.from_numpy(x)]})["Out"][0]
    assert tout.numpy().dtype == np.asarray(jout).dtype
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


# -- (d) the embedding gradient over repeated ids ---------------------------


@pytest.mark.parametrize("padding_idx", [-1, 2])
def test_lookup_table_grad_repeated_ids_match_jax(padding_idx):
    """4,096 ids over 7 rows of a 50-row table (every id repeated
    hundreds of times, most rows untouched): the segment sum equals
    JAX's scatter-add at the training tolerance."""
    rng = np.random.RandomState(9)
    w = rng.randn(50, 16).astype("float32")
    ids = rng.choice([0, 2, 3, 9, 17, 31, 49], size=(8, 512, 1)).astype("int64")
    og = rng.randn(8, 512, 16).astype("float32")
    op = _Op("lookup_table_grad", {"padding_idx": padding_idx})
    ins = {"W": w, "Ids": ids, "Out@GRAD": og}
    jout = jregistry.get_op_def("lookup_table_grad").lower(
        None, op, {k: [jnp.asarray(v)] for k, v in ins.items()})
    tout = tregistry.get_op_def("lookup_table_grad").lower(
        None, op, {k: [torch.from_numpy(v)] for k, v in ins.items()})
    got, want = tout["W@GRAD"][0].numpy(), np.asarray(jout["W@GRAD"][0])
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    untouched = sorted(set(range(50)) - set(ids.reshape(-1).tolist()))
    assert not got[untouched].any()
