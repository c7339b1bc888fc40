"""The port's Momentum / SGD training, gradient clipping and weight
decay against the JAX package, on the CPU.

(a) programs: ``MomentumOptimizer`` (plain and nesterov) and
    ``SGDOptimizer`` with each clip (the global-norm clip folded into the
    fused op's ClipScale, the unfused clip chain, per-parameter clip
    attributes, ``set_gradient_clip``) and with L2 / L1 decay give the
    same ``to_dict()`` as the JAX package, fused and unfused;
(b) five steps of a small fc net from the JAX startup's parameters:
    the losses within rtol 2e-4 / atol 2e-5 and every persistable
    (parameters, velocities) within the same tolerance (the JAX
    package's own kernel-vs-XLA tolerance, tests/test_fused_kernels.py),
    with JAX's fused momentum kernel in Pallas interpret mode;
(c) the fused op's plain version and the unfused chain give the same
    bits on the CPU;
(d) ``fused_momentum_update_plain`` against ``_reference_momentum``
    (float32, bit for bit) and the JAX kernel in interpret mode
    (bfloat16: both compute in float32 and round once, bit for bit;
    float32 within the fma XLA may form there);
(e) what stays unported raises naming its ROADMAP item.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core.framework import unique_name as jax_unique_name
from paddle_tpu.kernels import fused_optim as jfo

import paddle_tpu_torch as fluid
from paddle_tpu_torch.io import load_scope_arrays
from paddle_tpu_torch.kernels import (fused_momentum_update,
                                      fused_momentum_update_plain)

STEPS, BATCH = 5, 16


@pytest.fixture
def fuse_flag():
    """Sets optimizer_fuse in both packages; restores both after."""
    saved = (jfluid.get_flags("optimizer_fuse")["optimizer_fuse"],
             fluid.get_flags("optimizer_fuse")["optimizer_fuse"])

    def set_fuse(value):
        jfluid.set_flags({"optimizer_fuse": value})
        fluid.set_flags({"optimizer_fuse": value})

    yield set_fuse
    jfluid.set_flags({"optimizer_fuse": saved[0]})
    fluid.set_flags({"optimizer_fuse": saved[1]})


@pytest.fixture(autouse=True)
def no_global_clip():
    """set_gradient_clip is process-wide in both packages: start and end
    every test without one."""
    jfluid.clip.set_gradient_clip(None)
    fluid.clip.set_gradient_clip(None)
    yield
    jfluid.clip.set_gradient_clip(None)
    fluid.clip.set_gradient_clip(None)


# each case: (optimizer kind, kwargs for it, clip spec, regularizer spec)
# clip spec: None, ("opt", cls, args) on the optimizer, ("global", ...)
# through set_gradient_clip, ("param", ...) as a ParamAttr attribute
CASES = {
    "momentum": ("momentum", {}, None, None),
    "nesterov_l2": ("momentum", {"use_nesterov": True}, None, ("L2Decay", 1e-3)),
    "global_norm": ("momentum", {}, ("opt", "GradientClipByGlobalNorm", 0.05),
                    None),
    "global_norm_set": ("momentum", {"use_nesterov": True},
                        ("global", "GradientClipByGlobalNorm", 0.05), None),
    "global_norm_l1": ("momentum", {}, ("opt", "GradientClipByGlobalNorm", 0.05),
                       ("L1Decay", 1e-3)),
    "by_norm": ("momentum", {}, ("opt", "GradientClipByNorm", 0.02), None),
    "param_by_value": ("momentum", {}, ("param", "GradientClipByValue", 0.01),
                       None),
    "sgd_by_value_l2": ("sgd", {}, ("opt", "GradientClipByValue", 0.01),
                        ("L2Decay", 1e-2)),
}


def _net(pkg, unique, case):
    """fc(8 -> 16, relu) -> fc(16 -> 3) -> softmax cross-entropy."""
    kind, kw, clip, reg = CASES[case]
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), unique.guard():
        x = pkg.layers.data("x", [8])
        y = pkg.layers.data("y", [1], dtype="int64")
        pattr = None
        if clip is not None and clip[0] == "param":
            pattr = pkg.ParamAttr(
                name="fc_a.w",
                gradient_clip=getattr(pkg.clip, clip[1])(clip[2]))
        h = pkg.layers.fc(x, 16, param_attr=pattr, act="relu")
        logits = pkg.layers.fc(h, 3)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        opt_kw = {}
        if reg is not None:
            opt_kw["regularization"] = getattr(pkg.regularizer, reg[0])(reg[1])
        if clip is not None and clip[0] == "opt":
            opt_kw["grad_clip"] = getattr(pkg.clip, clip[1])(clip[2])
        if clip is not None and clip[0] == "global":
            pkg.clip.set_gradient_clip(getattr(pkg.clip, clip[1])(clip[2]))
        if kind == "momentum":
            opt = pkg.optimizer.MomentumOptimizer(0.1, 0.9, **kw, **opt_kw)
        else:
            opt = pkg.optimizer.SGDOptimizer(0.1, **opt_kw)
        opt.minimize(loss)
    return main, startup, loss


def _batch(seed=11):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(BATCH, 8).astype("float32"),
            "y": rng.randint(0, 3, (BATCH, 1)).astype("int64")}


def _persistables(program):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and not v.is_data)


@pytest.mark.parametrize("fuse", ["on", "off"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_program_matches_jax(case, fuse, fuse_flag):
    fuse_flag(fuse)
    jmain, jstart, _ = _net(jfluid, jax_unique_name, case)
    jfluid.clip.set_gradient_clip(None)
    tmain, tstart, _ = _net(fluid, fluid.unique_name, case)
    for jp, tp in ((jmain, tmain), (jstart, tstart)):
        jb, tb = jp.to_dict()["blocks"][0], tp.to_dict()["blocks"][0]
        assert [op["type"] for op in tb["ops"]] == \
            [op["type"] for op in jb["ops"]]
        assert tb == jb
    types = [op.type for op in tmain.global_block().ops]
    kind, _, clip, _ = CASES[case]
    if kind == "sgd":
        assert types.count("sgd") == 4
    else:
        want = "fused_momentum" if fuse == "on" else "momentum"
        assert types.count(want) == 4
        folded = (fuse == "on" and clip is not None
                  and clip[1] == "GradientClipByGlobalNorm"
                  and CASES[case][3] is None)
        ops = [op for op in tmain.global_block().ops if op.type == want]
        assert all(bool(op.inputs.get("ClipScale")) == folded for op in ops)


def _train_jax(case, batch):
    main, startup, loss = _net(jfluid, jax_unique_name, case)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
        losses = [float(np.asarray(exe.run(main, feed=batch,
                                           fetch_list=[loss])[0]))
                  for _ in range(STEPS)]
        final = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
    return init, losses, final


def _train_port(case, batch, init, steps=STEPS):
    main, _, loss = _net(fluid, fluid.unique_name, case)
    scope = fluid.Scope()
    load_scope_arrays(scope, init, main, "cpu")
    exe = fluid.Executor(fluid.CPUPlace())
    losses = [float(exe.run(main, feed=batch, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    return losses, {n: scope.get_numpy(n) for n in _persistables(main)}


@pytest.mark.parametrize("fuse", ["on", "off"])
@pytest.mark.parametrize("case", ["momentum", "nesterov_l2", "global_norm",
                                  "global_norm_set", "global_norm_l1",
                                  "by_norm", "param_by_value",
                                  "sgd_by_value_l2"])
def test_training_matches_jax(case, fuse, fuse_flag, monkeypatch):
    """Five steps from the JAX startup's parameters: losses and every
    persistable within rtol 2e-4 / atol 2e-5; the loss falls."""
    fuse_flag(fuse)
    if fuse == "on":
        monkeypatch.setenv("PADDLE_TPU_KERNEL_INTERPRET", "1")
    else:
        monkeypatch.delenv("PADDLE_TPU_KERNEL_INTERPRET", raising=False)
    batch = _batch()
    init, jlosses, jfinal = _train_jax(case, batch)
    jfluid.clip.set_gradient_clip(None)
    tlosses, tfinal = _train_port(case, batch, init)
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-4, atol=2e-5)
    assert tlosses[-1] < tlosses[0]
    assert sorted(tfinal) == sorted(jfinal)
    for n in jfinal:
        np.testing.assert_allclose(tfinal[n], jfinal[n], rtol=2e-4,
                                   atol=2e-5, err_msg=n)


@pytest.mark.parametrize("case", ["nesterov_l2", "global_norm",
                                  "global_norm_l1"])
def test_fused_and_unfused_agree_bitwise(case, fuse_flag):
    """The fused op's plain version, with the global-norm clip folded
    into its ClipScale or not, is the unfused chain's ops in the same
    order: equal bit for bit."""
    batch = _batch(3)
    fuse_flag("off")
    init, _, _ = _train_jax(case, batch)
    jfluid.clip.set_gradient_clip(None)
    runs = {}
    for fuse in ("on", "off"):
        fuse_flag(fuse)
        runs[fuse] = _train_port(case, batch, init, steps=3)
    assert runs["on"][0] == runs["off"][0]
    for n, v in runs["off"][1].items():
        np.testing.assert_array_equal(runs["on"][1][n], v, err_msg=n)


def _momentum_inputs(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(*shape).astype("float32") * s for s in (1.0, 0.1, 0.05)]
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return arrs


@pytest.mark.parametrize("clip", [None, 0.37])
@pytest.mark.parametrize("nesterov", [False, True])
def test_plain_version_equals_reference_momentum(nesterov, clip):
    """float32: ``fused_momentum_update_plain`` is ``_reference_momentum``
    op for op, bit for bit."""
    p, g, v = _momentum_inputs((37, 129), "float32", 1)
    lr = np.array([0.025], "float32")
    cs = None if clip is None else np.array(clip, "float32")
    jp, jv = jfo._reference_momentum(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(v),
        jnp.asarray(lr).reshape(()), None if cs is None else jnp.asarray(cs),
        0.9, nesterov)
    tp, tv = torch.tensor(p), torch.tensor(v)
    fused_momentum_update(tp, torch.tensor(g), tv, torch.tensor(lr), mu=0.9,
                          use_nesterov=nesterov,
                          clip_scale=None if cs is None else torch.tensor(cs))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nesterov", [False, True])
def test_plain_version_equals_jax_kernel_interpret(dtype, nesterov,
                                                   monkeypatch):
    """Against the TPU kernel ``_momentum_kernel`` in Pallas interpret
    mode, with a clip scale: both update in float32 and round once to
    the parameter dtype. Interpret mode runs the kernel body through XLA,
    which may contract ``p - lr * vel`` into one fma, so float32 agrees
    within the rounding of that product (2^-24 of |lr * vel| < 1e-8
    here; rtol 2^-23 for the last bit of p); the bfloat16 results round
    that float32 to 8 bits and agree bit for bit."""
    monkeypatch.setenv("PADDLE_TPU_KERNEL_INTERPRET", "1")
    p, g, v = _momentum_inputs((300,), dtype, 2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    lr = np.array([0.1], "float32")
    jp, jv = jfo.fused_momentum_update(
        jnp.asarray(p, jdt), jnp.asarray(g, jdt), jnp.asarray(v, jdt),
        jnp.asarray(lr), mu=0.9, use_nesterov=nesterov,
        clip_scale=jnp.asarray(0.6, jnp.float32))
    tdt = getattr(torch, dtype)
    tp, tv = torch.tensor(p).to(tdt), torch.tensor(v).to(tdt)
    fused_momentum_update_plain(tp, torch.tensor(g).to(tdt), tv,
                                torch.tensor(lr), mu=0.9,
                                use_nesterov=nesterov,
                                clip_scale=torch.tensor(0.6))
    rtol, atol = (0.0, 0.0) if dtype == "bfloat16" else (2.0 ** -23, 1e-8)
    np.testing.assert_allclose(tp.float().numpy(),
                               np.asarray(jp.astype(jnp.float32)),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(tv.float().numpy(),
                               np.asarray(jv.astype(jnp.float32)),
                               rtol=rtol, atol=atol)


def test_fused_momentum_update_checks_its_inputs():
    p = torch.zeros(8)
    lr = torch.tensor([0.1])
    with pytest.raises(ValueError, match="vel"):
        fused_momentum_update(p, torch.zeros(8), torch.zeros(7), lr)
    with pytest.raises(ValueError, match="lr must be one float32"):
        fused_momentum_update(p, torch.zeros(8), torch.zeros(8),
                              torch.tensor([0.1, 0.2]))
    with pytest.raises(ValueError, match="clip_scale must be one float32"):
        fused_momentum_update(p, torch.zeros(8), torch.zeros(8), lr,
                              clip_scale=torch.tensor([1.0], dtype=torch.float64))


@pytest.mark.parametrize("name,item", [
    # DGC is ported now (tests/test_torch_parallel.py); its case checks
    # that it imports and is momentum's subclass
    pytest.param("DGCMomentumOptimizer", "ported",
                 id="DGCMomentumOptimizer-ROADMAP A10"),
    # PipelineOptimizer is ported now (tests/test_torch_pipeline.py):
    # its case checks that it wraps an optimizer
    pytest.param("PipelineOptimizer", "ported",
                 id="PipelineOptimizer-ROADMAP A10"),
    ("switch_moe over an ep mesh", "ROADMAP A10"),
    ("StaticRNN", "ROADMAP A11"),
    ("DynamicRNN", "ROADMAP A11"),
])
def test_unported_items_are_refused_naming_their_roadmap_item(name, item):
    """What still waits raises naming its ROADMAP item: the optimizers
    of distribution, expert parallelism, the recurrent layers. (The
    meta-optimizers and SelectedRows gradients are ported:
    tests/test_torch_meta_optimizers.py, test_torch_selected_rows.py.)"""
    if name.startswith("switch_moe"):
        from paddle_tpu_torch.core.registry import LoweringContext, get_op_def

        ctx = LoweringContext("cpu")
        ctx.mesh = {"ep": 2}

        class _Op:
            attrs = {"capacity_factor": 1.25}

        with pytest.raises(NotImplementedError, match=item):
            get_op_def("switch_moe").lower(ctx, _Op(), {})
    elif name.endswith("RNN"):
        with pytest.raises(NotImplementedError, match=item):
            getattr(fluid.layers, name)()
    elif item == "ported" and name == "PipelineOptimizer":
        opt = fluid.optimizer.SGD(0.1)
        assert fluid.optimizer.PipelineOptimizer(opt)._optimizer is opt
    elif item == "ported":
        assert issubclass(getattr(fluid.optimizer, name),
                          fluid.optimizer.MomentumOptimizer)
    else:
        with pytest.raises(NotImplementedError, match=item):
            getattr(fluid.optimizer, name)
        with pytest.raises(AttributeError):
            getattr(fluid.optimizer, "NoSuchOptimizer")


@pytest.mark.parametrize("op_type,attrs", [
    ("relu", {}), ("sqrt", {}), ("square", {}), ("abs", {}),
    ("reciprocal", {}), ("sign", {}), ("clip", {"min": -0.3, "max": 0.5}),
    ("clip_by_norm", {"max_norm": 1.0}), ("clip_by_norm", {"max_norm": 100.0}),
    ("elementwise_max", {"axis": -1}), ("elementwise_min", {"axis": -1})])
def test_clip_math_op_lowerings_match_jax(op_type, attrs):
    """The ops clip.py and regularizer.py emit (and ``sign``,
    ``clip_by_norm``, which the JAX package registers beside them),
    lowering for lowering against the JAX package, float32 within 1e-6."""
    from paddle_tpu.core.registry import get_op_def as jax_op

    from paddle_tpu_torch.core.registry import get_op_def as port_op

    class _Op:
        pass

    op = _Op()
    op.attrs = attrs
    rng = np.random.RandomState(8)
    x = rng.randn(5, 7).astype("float32")
    if op_type in ("sqrt", "reciprocal"):
        x = np.abs(x) + 0.1
    ins = {"X": [x]}
    if op_type.startswith("elementwise"):
        ins["Y"] = [rng.randn(5, 7).astype("float32")]
    want = jax_op(op_type).lower(
        None, op, {k: [jnp.asarray(v[0])] for k, v in ins.items()})["Out"][0]
    got = port_op(op_type).lower(
        None, op, {k: [torch.tensor(v[0])] for k, v in ins.items()})["Out"][0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_fetched_values_do_not_change_with_later_steps(fuse_flag):
    """A persistable read from the scope (or fetched) after one step is a
    copy: the fused update of the next step, in place on the CPU tensor,
    must not reach it (it did while ``to_numpy`` returned ``numpy()``'s
    view of a CPU tensor)."""
    fuse_flag("on")
    main, startup, loss = _net(fluid, fluid.unique_name, "momentum")
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    batch = _batch()
    w = main.all_parameters()[0].name
    exe.run(main, feed=batch, fetch_list=[loss], scope=scope)
    held = scope.get_numpy(w)
    (fetched,) = exe.run(main, feed=batch, fetch_list=[w], scope=scope)
    before = (held.copy(), fetched.copy())
    exe.run(main, feed=batch, fetch_list=[loss], scope=scope)
    np.testing.assert_array_equal(held, before[0])
    np.testing.assert_array_equal(fetched, before[1])
    assert not np.array_equal(scope.get_numpy(w), before[1])
