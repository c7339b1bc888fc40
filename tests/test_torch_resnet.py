"""The port's image path (conv2d, batch_norm, pool2d, top_k, accuracy)
and ResNet-50 against the JAX package, on the CPU.

(a) a two-bottleneck net built from ``_conv_bn`` / ``_bottleneck``, in
    NCHW and NHWC: every op's forward output, the gradients of the image
    and of every parameter, batch norm's ``SavedMean`` /
    ``SavedVariance`` and the written-back running ``Mean`` / ``Variance``
    equal the JAX lowerings' within rtol 1e-4 / atol 1e-5 (float32 sums
    over channels and windows in another order);
(b) ``build_resnet50`` gives the same program as the JAX package
    (``to_dict()``), in both layouts, fused and unfused;
(c) five Momentum + L2Decay steps of the small net (with an identity
    shortcut block added), from the JAX startup's parameters: losses
    within rtol 2e-4 / atol 2e-5 (as the other training parity tests),
    every persistable within rtol 2e-4 / atol 2e-5 as well, and the BN
    running statistics have moved;
(d) the full-depth ResNet-50 at ``image_size=64``, ``num_classes=10``,
    batch 4, from the JAX startup's parameters: the first loss (a
    forward through all 53 conv / batch-norm pairs) within rtol 2e-4 of
    JAX's, then three fused Momentum + L2Decay steps equal bit for bit
    to the unfused ones, finite, with the BN statistics moving.

Why (d) compares the trajectory only through the first loss: at full
depth and a batch this small, batch norm over a handful of values a
channel is ill-conditioned at initialisation: scaling the input by
(1 + 1e-7) moves the port's own parameter gradients by more than 10 %
(``test_full_depth_gradients_are_ill_conditioned``), about as much as
the port and JAX differ. No two float32 implementations can agree on
that trajectory; the small net of (c) is well conditioned and holds
every step to the tolerance.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.core.framework import unique_name as jax_unique_name
from paddle_tpu.models import resnet as jresnet

import paddle_tpu_torch as fluid
from paddle_tpu_torch.io import load_scope_arrays
from paddle_tpu_torch.models import resnet as tresnet

RTOL, ATOL = 1e-4, 1e-5      # forward / gradient parity of the image ops
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5


@pytest.fixture
def fuse_flag():
    saved = (jfluid.get_flags("optimizer_fuse")["optimizer_fuse"],
             fluid.get_flags("optimizer_fuse")["optimizer_fuse"])

    def set_fuse(value):
        jfluid.set_flags({"optimizer_fuse": value})
        fluid.set_flags({"optimizer_fuse": value})

    yield set_fuse
    jfluid.set_flags({"optimizer_fuse": saved[0]})
    fluid.set_flags({"optimizer_fuse": saved[1]})


def _small_net(pkg, unique, resnet, fmt, optimizer=None, size=16):
    """stem conv-bn (stride 2) -> max pool 3/2/1 -> a bottleneck with a
    projection shortcut -> one with an identity shortcut -> a strided
    bottleneck -> global average pool -> fc 5 -> loss and top-1
    accuracy."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), unique.guard():
        img = pkg.layers.data("image", [3, size, size],
                              stop_gradient=optimizer is not None)
        label = pkg.layers.data("label", [1], dtype="int64")
        x = img
        if fmt == "NHWC":
            x = pkg.layers.transpose(x, [0, 2, 3, 1])
        x = resnet._conv_bn(x, 8, 3, stride=2, name="stem", fmt=fmt)
        x = pkg.layers.pool2d(x, 3, "max", pool_stride=2, pool_padding=1,
                              data_format=fmt)
        x = resnet._bottleneck(x, 4, 1, "a", fmt=fmt)
        x = resnet._bottleneck(x, 4, 1, "c", fmt=fmt)   # identity shortcut
        x = resnet._bottleneck(x, 4, 2, "b", fmt=fmt)
        pool = pkg.layers.pool2d(x, 2, "avg", global_pooling=True,
                                 data_format=fmt)
        logits = pkg.layers.fc(pool, 5, param_attr=pkg.ParamAttr(name="head.w"))
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, label))
        acc = pkg.layers.accuracy(pkg.layers.softmax(logits), label)
        if optimizer is None:
            pkg.append_backward(loss)
        else:
            optimizer.minimize(loss)
    return main, startup, loss, acc


def _batch(n, size, classes, seed):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(n, 3, size, size).astype("float32"),
            "label": rng.randint(0, classes, (n, 1)).astype("int64")}


def _persistables(program):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and not v.is_data)


def _fetchable(main):
    """Every op output of the forward and every gradient, by name (the
    XShape placeholders and in-place written persistables excluded)."""
    names = []
    for op in main.global_block().ops:
        for slot, vs in op.outputs.items():
            if slot == "XShape" or op.type in ("fill_constant",):
                continue
            for n in vs:
                v = main.global_block()._find_var_recursive(n)
                if v is not None and not v.persistable and n not in names:
                    names.append(n)
    return names


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_image_ops_forward_and_grads_match_jax(fmt):
    jmain, jstart, jloss, _ = _small_net(jfluid, jax_unique_name, jresnet, fmt)
    tmain, _, tloss, _ = _small_net(fluid, fluid.unique_name, tresnet, fmt)
    assert tmain.to_dict() == jmain.to_dict()
    types = {op.type for op in tmain.global_block().ops}
    assert {"conv2d", "batch_norm", "pool2d", "top_k", "accuracy",
            "conv2d_grad", "batch_norm_grad", "pool2d_grad"} <= types
    names = _fetchable(tmain)
    assert "image@GRAD" in names and "stem.conv.w@GRAD" in names
    feed = _batch(3, 16, 5, 0)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(jmain)}
        jout = exe.run(jmain, feed=feed, fetch_list=names)
        jstate = {n: np.asarray(scope.find_var(n)) for n in _persistables(jmain)}
    tscope = fluid.Scope()
    load_scope_arrays(tscope, init, tmain, "cpu")
    tout = fluid.Executor(fluid.CPUPlace()).run(tmain, feed=feed,
                                                fetch_list=names,
                                                scope=tscope)
    for n, j, t in zip(names, jout, tout):
        j = np.asarray(j)
        # JAX runs without x64: its int64 indices arrive as int32
        assert t.shape == j.shape and t.dtype.kind == j.dtype.kind, n
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL, err_msg=n)
    # running statistics written back in place, with the biased batch
    # variance (VarianceOut), and moved off their initial 0 / 1
    for n in _persistables(tmain):
        np.testing.assert_allclose(tscope.get_numpy(n), jstate[n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)
        if n.endswith((".bn.mean", ".bn.var")):
            assert not np.allclose(tscope.get_numpy(n), init[n]), n


def test_batch_norm_statistics_are_the_references():
    """SavedMean is the batch mean, SavedVariance 1/sqrt(biased var +
    eps), and MeanOut / VarianceOut the momentum blend with the BIASED
    variance, computed with numpy."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4, 3, 5])
        y = fluid.layers.batch_norm(x, momentum=0.8, epsilon=1e-3,
                                    moving_mean_name="m",
                                    moving_variance_name="v")
    bn = next(op for op in main.global_block().ops if op.type == "batch_norm")
    xv = np.random.RandomState(4).randn(6, 4, 3, 5).astype("float32") * 3 + 1
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    yv, sm, sv = exe.run(main, feed={"x": xv},
                         fetch_list=[y, bn.outputs["SavedMean"][0],
                                     bn.outputs["SavedVariance"][0]],
                         scope=scope)
    mean = xv.mean(axis=(0, 2, 3))
    var = xv.var(axis=(0, 2, 3))
    np.testing.assert_allclose(sm, mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sv, 1 / np.sqrt(var + 1e-3), rtol=1e-5)
    np.testing.assert_allclose(scope.get_numpy("m"), 0.2 * mean, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(scope.get_numpy("v"), 0.8 + 0.2 * var,
                               rtol=1e-5)
    ref = (xv - mean[None, :, None, None]) / np.sqrt(
        var[None, :, None, None] + 1e-3)
    np.testing.assert_allclose(yv, ref, rtol=1e-4, atol=1e-5)
    # at test time the running statistics normalise and stay as they are
    test_main, test_startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(test_main, test_startup), \
            fluid.unique_name.guard():
        xt = fluid.layers.data("x", [4, 3, 5])
        yt_var = fluid.layers.batch_norm(xt, is_test=True, epsilon=1e-3,
                                         moving_mean_name="m",
                                         moving_variance_name="v")
    m, v = scope.get_numpy("m"), scope.get_numpy("v")
    (yt,) = exe.run(test_main, feed={"x": xv}, fetch_list=[yt_var],
                    scope=scope)
    np.testing.assert_allclose(
        yt, (xv - m[None, :, None, None])
        / np.sqrt(v[None, :, None, None] + 1e-3), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(scope.get_numpy("m"), m)


def test_accuracy_counts_top1_hits():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        p = fluid.layers.data("p", [4])
        label = fluid.layers.data("label", [1], dtype="int64")
        acc = fluid.layers.accuracy(p, label)
        acc2 = fluid.layers.accuracy(p, label, k=2)
    pv = np.array([[0.1, 0.5, 0.25, 0.15], [0.7, 0.05, 0.15, 0.1],
                   [0.2, 0.3, 0.4, 0.1]], "float32")
    lv = np.array([[1], [2], [3]], "int64")     # top-1 hit, top-2 hit, miss
    a1, a2 = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"p": pv, "label": lv}, fetch_list=[acc, acc2],
        scope=fluid.Scope())
    np.testing.assert_allclose(a1, [1 / 3])
    np.testing.assert_allclose(a2, [2 / 3])


@pytest.mark.parametrize("fuse", ["on", "off"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_resnet50_program_matches_jax(fmt, fuse, fuse_flag):
    fuse_flag(fuse)
    with jax_unique_name.guard():
        jmain, jstart, _, _ = jresnet.build_resnet50(
            1000, 224, jfluid.optimizer.MomentumOptimizer(
                0.025, 0.9, regularization=jfluid.regularizer.L2Decay(1e-4)),
            fmt)
    with fluid.unique_name.guard():
        tmain, tstart, _, _ = tresnet.build_resnet50(
            1000, 224, fluid.optimizer.MomentumOptimizer(
                0.025, 0.9, regularization=fluid.regularizer.L2Decay(1e-4)),
            fmt)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    params = tmain.all_parameters()
    assert len(params) == 161
    assert sum(int(np.prod(p.shape)) for p in params) == 25_557_032
    types = [op.type for op in tmain.global_block().ops]
    assert types.count("fused_momentum" if fuse == "on" else "momentum") == 161
    assert types.count("conv2d") == 53 and types.count("batch_norm") == 53


def _train(pkg_name, build, steps, batch, init=None):
    """Steps of a program from ``build(pkg, unique)``; JAX starts from its
    startup, the port from ``init``. Returns init, losses, final state."""
    if pkg_name == "jax":
        main, startup, loss = build(jfluid, jax_unique_name)
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(startup)
            init = {n: np.asarray(scope.find_var(n))
                    for n in _persistables(main)}
            losses = [float(np.asarray(exe.run(main, feed=batch,
                                               fetch_list=[loss])[0]))
                      for _ in range(steps)]
            final = {n: np.asarray(scope.find_var(n))
                     for n in _persistables(main)}
        return init, losses, final
    main, _, loss = build(fluid, fluid.unique_name)
    scope = fluid.Scope()
    load_scope_arrays(scope, init, main, "cpu")
    exe = fluid.Executor(fluid.CPUPlace())
    losses = [float(exe.run(main, feed=batch, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    return init, losses, {n: scope.get_numpy(n) for n in _persistables(main)}


def _check_training(build, steps, batch):
    init, jlosses, jfinal = _train("jax", build, steps, batch)
    _, tlosses, tfinal = _train("port", build, steps, batch, init)
    np.testing.assert_allclose(tlosses, jlosses, rtol=TRAIN_RTOL,
                               atol=TRAIN_ATOL)
    assert tlosses[-1] < tlosses[0]
    assert sorted(tfinal) == sorted(jfinal)
    for n in jfinal:
        np.testing.assert_allclose(tfinal[n], jfinal[n], rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, err_msg=n)
        if n.endswith((".bn.mean", ".bn.var")):
            assert not np.allclose(tfinal[n], init[n]), n


def _momentum_l2(pkg):
    return pkg.optimizer.MomentumOptimizer(
        0.05, 0.9, regularization=pkg.regularizer.L2Decay(1e-4))


@pytest.mark.parametrize("fuse", ["on", "off"])
def test_small_net_momentum_training_matches_jax(fuse, fuse_flag,
                                                 monkeypatch):
    """Five Momentum + L2Decay steps of the two-bottleneck net; fused,
    JAX's momentum kernel runs in Pallas interpret mode."""
    fuse_flag(fuse)
    if fuse == "on":
        monkeypatch.setenv("PADDLE_TPU_KERNEL_INTERPRET", "1")
    else:
        monkeypatch.delenv("PADDLE_TPU_KERNEL_INTERPRET", raising=False)

    def build(pkg, unique):
        resnet = jresnet if pkg is jfluid else tresnet
        main, startup, loss, _ = _small_net(pkg, unique, resnet, "NCHW",
                                            _momentum_l2(pkg))
        return main, startup, loss

    _check_training(build, 5, _batch(4, 16, 5, 1))


def test_resnet50_full_depth_forward_matches_jax_and_steps(fuse_flag):
    """All 53 conv / batch-norm pairs and the 161 momentum updates: the
    first loss against JAX, then three steps fused and unfused (the
    plain versions here), equal bit for bit."""
    batch = tresnet.synthetic_image_batch(np.random.RandomState(0), 4, 64,
                                          10)

    def build(pkg, unique):
        resnet = jresnet if pkg is jfluid else tresnet
        with unique.guard():
            main, startup, _, fetches = resnet.build_resnet50(
                num_classes=10, image_size=64, optimizer=_momentum_l2(pkg))
        return main, startup, fetches["loss"]

    fuse_flag("off")
    init, jlosses, _ = _train("jax", build, 1, batch)
    runs = {}
    for fuse in ("on", "off"):
        fuse_flag(fuse)
        runs[fuse] = _train("port", build, 3, batch, init)[1:]
    losses, final = runs["on"]
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=TRAIN_RTOL,
                               atol=TRAIN_ATOL)
    assert np.all(np.isfinite(losses))
    assert runs["off"][0] == losses
    for n, v in runs["off"][1].items():
        np.testing.assert_array_equal(final[n], v, err_msg=n)
        if n.endswith((".bn.mean", ".bn.var")):
            assert not np.allclose(v, init[n]), n


def test_full_depth_gradients_are_ill_conditioned():
    """What limits (d): at image 64, batch 4, a 1e-7 relative change of
    the input moves some parameter gradient of the port by over 10 %
    of its largest entry."""
    with fluid.unique_name.guard():
        main, startup, _, fetches = tresnet.build_resnet50(10, 64, None)
        with fluid.program_guard(main, startup):
            grads = [g.name for _, g in fluid.append_backward(fetches["loss"])]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    batch = tresnet.synthetic_image_batch(np.random.RandomState(0), 4, 64,
                                          10)
    nudged = dict(batch, image=batch["image"] * np.float32(1 + 1e-7))
    a = exe.run(main, feed=batch, fetch_list=grads, scope=scope)
    b = exe.run(main, feed=nudged, fetch_list=grads, scope=scope)
    worst = max(float(np.abs(x - y).max() / np.abs(x).max())
                for x, y in zip(a, b))
    assert worst > 0.1
