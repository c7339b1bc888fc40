"""LeNet, VGG and SE-ResNeXt (``models/mnist.py``, ``models/vision.py``)
and the composite nets under them (``nets.simple_img_conv_pool``,
``img_conv_group``, ``glu``) in the port, against the JAX package, on the
CPU.

(a) each builder gives the JAX package's programs (``to_dict()``, main
    and startup), in both layouts;
(b) three training steps of LeNet (Adam), VGG-11 at a 32-pixel image and
    the CI-sized SE-ResNeXt (grouped 3x3 convolutions and the
    squeeze-excite gate), both by Momentum + L2Decay, from the JAX startup's
    parameters: losses within rtol 2e-4 / atol 2e-5, as
    ``test_torch_resnet.py`` (c), every persistable as well, and the
    batch-norm running statistics have moved. VGG's two dropouts are set
    to probability 0 in both programs for this: the two frameworks'
    random streams differ. VGG trains by Momentum here, not by the
    Adam its chip phase uses: Adam's first steps move every weight by
    about lr * sign(gradient), so a gradient entry near 0 that the two
    float32 sums round to opposite signs moves a weight by a full lr
    in opposite directions (one of 512 running means of VGG-11 landed
    4e-4 apart). Adam itself is held by LeNet here and by every
    ``fc(act=...)`` case of ``test_torch_activations.py``.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import nets as jnets
from paddle_tpu.models import mnist as jmnist, vision as jvision

import paddle_tpu_torch as fluid
from paddle_tpu_torch import nets as tnets
from paddle_tpu_torch.io import load_scope_arrays
from paddle_tpu_torch.models import mnist as tmnist, vision as tvision
from test_torch_activations import (  # noqa: F401 (unfused: a fixture)
    _names, _persistables, unfused)

TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5


def _mods(pkg):
    return (jmnist, jvision) if pkg is jfluid else (tmnist, tvision)


def _adam(pkg):
    return pkg.optimizer.AdamOptimizer(1e-3)


def _momentum(pkg, lr=0.05):
    return pkg.optimizer.MomentumOptimizer(
        lr, 0.9, regularization=pkg.regularizer.L2Decay(1e-4))


BUILDS = {
    "lenet": lambda pkg, fmt: _mods(pkg)[0].build_lenet(_adam(pkg)),
    "vgg11": lambda pkg, fmt: _mods(pkg)[1].build_vgg(
        10, 32, _momentum(pkg, 0.005), 11, data_format=fmt),
    "vgg16": lambda pkg, fmt: _mods(pkg)[1].build_vgg(
        10, 32, _adam(pkg), 16, data_format=fmt),
    "se_resnext": lambda pkg, fmt: _mods(pkg)[1].build_se_resnext(
        10, 16, _momentum(pkg), data_format=fmt),
    "se_resnext50_layout": lambda pkg, fmt: _mods(pkg)[1].build_se_resnext(
        10, 32, _momentum(pkg), depth=(3, 4, 6, 3),
        filters=(128, 256, 512, 1024), cardinality=32, reduction=16,
        data_format=fmt),
}


def _build(pkg, name, fmt="NCHW"):
    with _names(pkg).guard():
        return BUILDS[name](pkg, fmt)


# LeNet has one layout
@pytest.mark.parametrize("name,fmt", [(n, f) for n in sorted(BUILDS)
                                      for f in ("NCHW", "NHWC")
                                      if n != "lenet" or f == "NCHW"])
def test_builders_give_the_jax_programs(name, fmt, unfused):
    jmain, jstart, _, _ = _build(jfluid, name, fmt)
    tmain, tstart, _, _ = _build(fluid, name, fmt)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    types = [op.type for op in tmain.global_block().ops]
    if name.startswith("se_resnext"):
        groups = {op.attrs["groups"] for op in tmain.global_block().ops
                  if op.type == "conv2d"}
        assert groups == {1, 32 if "50" in name else 8}
        assert "elementwise_mul" in types and "sigmoid" in types
    if name.startswith("vgg"):
        assert types.count("conv2d") == {"vgg11": 8, "vgg16": 13}[name]


def _no_dropout(program):
    # the grad ops carry copies of the forward's attrs
    for op in program.global_block().ops:
        if op.type in ("dropout", "dropout_grad"):
            op.attrs["dropout_prob"] = 0.0
    program._bump()


def _batch(name, n, seed):
    rng = np.random.RandomState(seed)
    if name == "lenet":
        return tmnist.synthetic_mnist_batch(rng, n)
    size = {"vgg11": 32, "se_resnext": 16}[name]
    return {"image": rng.randn(n, 3, size, size).astype("float32"),
            "label": rng.randint(0, 10, (n, 1)).astype("int64")}


@pytest.mark.parametrize("name", ["lenet", "vgg11", "se_resnext"])
def test_three_training_steps_match_jax(name, unfused):
    batch = _batch(name, 4, 1)
    jmain, jstart, _, jf = _build(jfluid, name)
    tmain, _, _, tf = _build(fluid, name)
    _no_dropout(jmain)
    _no_dropout(tmain)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(jmain)}
        jl = [float(np.asarray(exe.run(jmain, feed=batch,
                                       fetch_list=[jf["loss"]])[0]))
              for _ in range(3)]
        jstate = {n: np.asarray(scope.find_var(n)) for n in init}
    tscope = fluid.Scope()
    load_scope_arrays(tscope, init, tmain, "cpu")
    texe = fluid.Executor(fluid.CPUPlace())
    tl = [float(texe.run(tmain, feed=batch, fetch_list=[tf["loss"]],
                         scope=tscope)[0]) for _ in range(3)]
    assert np.all(np.isfinite(tl)) and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    assert sorted(jstate) == _persistables(tmain)
    for n, v in jstate.items():
        np.testing.assert_allclose(tscope.get_numpy(n), v, rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, err_msg=n)
    stats = [n for n in jstate if n.endswith((".m", ".v", ".bn.mean",
                                              ".bn.var"))]
    assert stats or name == "lenet"
    for n in stats:
        assert not np.allclose(tscope.get_numpy(n), init[n]), n


def _nets_program(pkg, nets):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), _names(pkg).guard():
        img = pkg.layers.data("img", [3, 12, 12])
        x = nets.simple_img_conv_pool(img, 4, 3, 2, 2, conv_padding=1,
                                      act="leaky_relu", pool_type="avg")
        x = nets.img_conv_group(x, [6, 6], 2, conv_act="relu",
                                conv_with_batchnorm=[True, False],
                                pool_stride=2)
        g = nets.glu(pkg.layers.fc(x, 8), dim=1)
        loss = pkg.layers.mean(g)
        pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main, startup, loss


def test_composite_nets_match_jax(unfused):
    jmain, jstart, jloss = _nets_program(jfluid, jnets)
    tmain, _, tloss = _nets_program(fluid, tnets)
    assert tmain.to_dict() == jmain.to_dict()
    feed = {"img": np.random.RandomState(5).randn(3, 3, 12, 12).astype(
        np.float32)}
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(jmain)}
        jl = [float(np.asarray(exe.run(jmain, feed=feed,
                                       fetch_list=[jloss])[0]))
              for _ in range(2)]
    tscope = fluid.Scope()
    load_scope_arrays(tscope, init, tmain, "cpu")
    texe = fluid.Executor(fluid.CPUPlace())
    tl = [float(texe.run(tmain, feed=feed, fetch_list=[tloss],
                         scope=tscope)[0]) for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)


def test_se_resnext_zips_depth_with_filters():
    """Four stages need four filters: the builder zips them."""
    with fluid.unique_name.guard():
        main, _, _, _ = tvision.build_se_resnext(
            10, 16, depth=(1, 1, 1, 1), filters=(8, 16, 16, 32),
            cardinality=4)
    names = {p.name.split(".")[0] for p in main.all_parameters()}
    assert {"s0b0", "s1b0", "s2b0", "s3b0"} <= names
