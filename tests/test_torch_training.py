"""The port's training path against the JAX package, on the CPU.

``paddle_tpu_torch`` builds programs with its own copies of the Program
IR, layers, ``append_backward`` and ``AdamOptimizer``, and runs them
with an eager Executor whose kernels take their plain PyTorch versions
on CPU tensors. These tests hold that against ``paddle_tpu``:

(a) ``build_gpt_lm`` gives the same program (op types, var names,
    shapes, attrs), main and startup, with the fused optimizer on and
    off;
(b) from the JAX startup's parameters carried across
    (``io.load_scope_arrays``), Adam steps on ``synthetic_lm_batch``
    give the JAX losses within rtol 2e-4 / atol 2e-5 (the JAX package's
    own kernel-vs-XLA tolerance, tests/test_fused_kernels.py) and the
    same parameters within 1e-5, fused (JAX's kernels in interpret
    mode) and unfused;
(c) dropout statistics (the two frameworks' random bits differ);
(d) the reference's error messages and its identical-init probe;
(e) a fetched Softmax slot of softmax_with_cross_entropy.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core.framework import unique_name as jax_unique_name
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch as fluid
from paddle_tpu_torch.io import load_scope_arrays
from paddle_tpu_torch.models import gpt as tgpt

SEQ, BATCH, STEPS, LR = 16, 4, 5, 1e-3


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


def _build_jax(cfg, seq=SEQ):
    with jax_unique_name.guard():
        return jgpt.build_gpt_lm(cfg, seq, jfluid.optimizer.AdamOptimizer(LR))


def _build_port(cfg, seq=SEQ):
    with fluid.unique_name.guard():
        return tgpt.build_gpt_lm(cfg, seq, fluid.optimizer.AdamOptimizer(LR))


def _batches(vocab, n=STEPS, seed=7):
    """One synthetic batch, fed n times (the loss must fall on it)."""
    rng = np.random.RandomState(seed)
    return [tgpt.synthetic_lm_batch(rng, BATCH, SEQ, vocab)] * n


def _persistables(program):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and not v.is_data)


@pytest.mark.parametrize("fuse", ["on", "off"])
def test_gpt_program_matches_jax(fuse, fuse_flag):
    fuse_flag(fuse)
    cfg = tgpt.GPTConfig.tiny()
    jmain, jstart, _, _ = _build_jax(cfg)
    tmain, tstart, _, _ = _build_port(cfg)
    for jp, tp in ((jmain, tmain), (jstart, tstart)):
        jd, td = jp.to_dict(), tp.to_dict()
        jb, tb = jd["blocks"][0], td["blocks"][0]
        assert [op["type"] for op in tb["ops"]] == \
            [op["type"] for op in jb["ops"]]
        assert [(v["name"], v["shape"], v["dtype"], v["persistable"])
                for v in tb["vars"]] == \
            [(v["name"], v["shape"], v["dtype"], v["persistable"])
             for v in jb["vars"]]
        assert tb == jb     # inputs, outputs, attrs, tags: all of it
    want = "fused_adam" if fuse == "on" else "adam"
    types = [op.type for op in tmain.global_block().ops]
    assert types.count(want) == 12 * cfg.num_layers + 6
    assert types.count("layer_norm") == 2 * cfg.num_layers + 1


def _train_jax(cfg, batches):
    main, startup, _, fetches = _build_jax(cfg)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
        losses = [float(np.asarray(exe.run(main, feed=b,
                                           fetch_list=[fetches["loss"]])[0]))
                  for b in batches]
        final = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
    return init, losses, final


def _train_port(cfg, batches, init):
    main, _, _, fetches = _build_port(cfg)
    scope = fluid.Scope()
    load_scope_arrays(scope, init, main, "cpu")
    exe = fluid.Executor(fluid.CPUPlace())
    losses = [float(exe.run(main, feed=b, fetch_list=[fetches["loss"]],
                            scope=scope)[0]) for b in batches]
    final = {n: scope.get_numpy(n) for n in _persistables(main)}
    return losses, final


@pytest.mark.parametrize("fuse", ["on", "off"])
def test_tiny_gpt_training_matches_jax(fuse, fuse_flag, monkeypatch):
    """Five Adam steps of the tiny GPT from the JAX startup's parameters:
    the losses within rtol 2e-4 / atol 2e-5, every persistable (params,
    moments, beta pows) within 1e-5 afterwards."""
    fuse_flag(fuse)
    if fuse == "on":
        monkeypatch.setenv("PADDLE_TPU_KERNEL_INTERPRET", "1")
    else:
        monkeypatch.delenv("PADDLE_TPU_KERNEL_INTERPRET", raising=False)
    cfg = tgpt.GPTConfig.tiny()
    batches = _batches(cfg.vocab_size)
    init, jlosses, jfinal = _train_jax(cfg, batches)
    tlosses, tfinal = _train_port(cfg, batches, init)
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-4, atol=2e-5)
    assert tlosses[-1] < tlosses[0]
    assert sorted(tfinal) == sorted(jfinal)
    for n in jfinal:
        np.testing.assert_allclose(tfinal[n], jfinal[n], rtol=0, atol=1e-5,
                                   err_msg=n)


def test_fused_and_unfused_adam_agree_bitwise(fuse_flag):
    """On one backend the fused op's plain version and the unfused adam
    chain are the same ops in the same order: equal bit for bit."""
    cfg = tgpt.GPTConfig.tiny()
    batches = _batches(cfg.vocab_size, n=3)
    fuse_flag("off")
    init, _, _ = _train_jax(cfg, [])
    runs = {}
    for fuse in ("on", "off"):
        fuse_flag(fuse)
        runs[fuse] = _train_port(cfg, batches, init)
    assert runs["on"][0] == runs["off"][0]
    for n, v in runs["off"][1].items():
        np.testing.assert_array_equal(runs["on"][1][n], v, err_msg=n)


def _dropout_program(n, p, impl="upscale_in_train"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [n], append_batch_size=False,
                              stop_gradient=False)
        y = fluid.layers.dropout(x, p, dropout_implementation=impl)
        loss = fluid.layers.mean(y)
        fluid.append_backward(loss)
    return main, x, y, loss


def test_dropout_statistics_and_mask_reuse():
    n, p = 200_000, 0.3
    main, x, y, _ = _dropout_program(n, p)
    exe = fluid.Executor(fluid.CPUPlace())
    xv = np.random.RandomState(0).rand(n).astype("float32") + 0.5
    outs = []
    for _ in range(2):
        yv, gx = exe.run(main, feed={"x": xv},
                         fetch_list=[y, x.name + "@GRAD"],
                         scope=fluid.Scope())
        keep = yv != 0
        # keep rate 1 - p: 200k draws put 5 sigma at 0.0051
        assert abs(keep.mean() - (1 - p)) < 0.006
        np.testing.assert_allclose(yv[keep], xv[keep] / (1 - p), rtol=1e-6)
        # the grad op applies the forward's mask: d mean(y) / dx
        np.testing.assert_array_equal(gx != 0, keep)
        np.testing.assert_allclose(gx[keep], 1.0 / (1 - p) / n, rtol=1e-6)
        outs.append(keep)
    # a new run (step) draws a new mask; about p(1-p)*2 of them differ
    assert 0.3 < (outs[0] != outs[1]).mean() < 0.5


def test_dropout_is_identity_at_test_time_and_p0():
    n = 1000
    xv = np.random.RandomState(1).randn(n).astype("float32")
    exe = fluid.Executor(fluid.CPUPlace())
    main, x, y, _ = _dropout_program(n, 0.5)
    test = main.clone(for_test=True)
    (yv,) = exe.run(test, feed={"x": xv}, fetch_list=[y], scope=fluid.Scope())
    np.testing.assert_array_equal(yv, xv)
    main, x, y, _ = _dropout_program(n, 0.0)
    (yv,) = exe.run(main, feed={"x": xv}, fetch_list=[y], scope=fluid.Scope())
    np.testing.assert_array_equal(yv, xv)


def _surface_program():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8])
        y = fluid.layers.data("y", [1], dtype="int64")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
            fluid.layers.fc(x, 3), y))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


def test_reference_error_messages():
    main, startup, loss = _surface_program()
    exe = fluid.Executor(fluid.CPUPlace())
    xv = np.zeros((4, 8), "float32")
    yv = np.zeros((4, 1), "int64")
    with pytest.raises(RuntimeError, match="run the startup program first"):
        exe.run(main, feed={"x": xv, "y": yv}, fetch_list=[loss],
                scope=fluid.Scope())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(RuntimeError, match="data var 'y' was not fed"):
        exe.run(main, feed={"x": xv}, fetch_list=[loss], scope=scope)


def test_surface_script_trains():
    main, startup, loss = _surface_program()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(3)
    xv = rng.randn(16, 8).astype("float32")
    yv = rng.randint(0, 3, (16, 1)).astype("int64")
    losses = [float(exe.run(main, feed={"x": xv, "y": yv},
                            fetch_list=[loss], scope=scope)[0])
              for _ in range(10)]
    assert losses[-1] < losses[0] and np.all(np.isfinite(losses))


def test_same_program_built_twice_inits_identically():
    """The reference probe: per-program op identities make the init of
    two builds of one program identical (and a different random_seed
    gives different numbers)."""
    cfg = tgpt.GPTConfig.tiny()
    inits = []
    for seed in (0, 0, 5):
        _, startup, _, _ = _build_port(cfg)
        startup.random_seed = seed
        scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
        inits.append({n: scope.get_numpy(n) for n in scope.local_var_names()})
    assert sorted(inits[0]) == sorted(inits[1])
    for n in inits[0]:
        np.testing.assert_array_equal(inits[0][n], inits[1][n], err_msg=n)
    w = "dec0_qkv.w"
    assert not np.array_equal(inits[0][w], inits[2][w])
    # Normal(0, 0.02): the draws have the configured spread
    assert abs(inits[0][w].std() - cfg.initializer_range) < 0.002
    np.testing.assert_array_equal(inits[0]["dec0_ln1.scale"], 1.0)


def _xent_programs(pkg, unique):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), unique.guard():
        lg = pkg.layers.data("lg", [4, 6], append_batch_size=False)
        y = pkg.layers.data("y", [4, 1], dtype="int64",
                            append_batch_size=False)
        loss, sm = pkg.layers.softmax_with_cross_entropy(
            lg, y, ignore_index=-1, return_softmax=True)
    return main, loss, sm


def test_fetched_softmax_slot_and_ignore_index():
    rng = np.random.RandomState(2)
    lgv = rng.randn(4, 6).astype("float32")
    yv = np.array([[2], [-1], [0], [5]], "int64")
    main, loss, sm = _xent_programs(fluid, fluid.unique_name)
    lv, smv = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"lg": lgv, "y": yv}, fetch_list=[loss, sm],
        scope=fluid.Scope())
    e = np.exp(lgv - lgv.max(1, keepdims=True))
    np.testing.assert_allclose(smv, e / e.sum(1, keepdims=True), rtol=1e-6,
                               atol=1e-7)
    assert lv.shape == (4, 1) and lv[1, 0] == 0.0
    jmain, jloss, jsm = _xent_programs(jfluid, jax_unique_name)
    jlv, jsmv = jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed={"lg": lgv, "y": yv}, fetch_list=[jloss, jsm])
    np.testing.assert_allclose(lv, np.asarray(jlv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(smv, np.asarray(jsmv), rtol=1e-6, atol=1e-7)


def test_load_scope_arrays_checks_names_and_shapes():
    cfg = tgpt.GPTConfig.tiny()
    main, startup, _, _ = _build_port(cfg)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    arrays = {n: scope.get_numpy(n) for n in _persistables(main)}
    load_scope_arrays(fluid.Scope(), arrays, main, "cpu")
    bad = dict(arrays)
    bad.pop("gpt_head.b")
    with pytest.raises(ValueError, match="missing"):
        load_scope_arrays(fluid.Scope(), bad, main, "cpu")
    with pytest.raises(ValueError, match="not persistable"):
        load_scope_arrays(fluid.Scope(), {**arrays, "nope": np.zeros(1)},
                          main, "cpu")
    with pytest.raises(ValueError, match="shape"):
        load_scope_arrays(fluid.Scope(), {**arrays, "gpt_head.b":
                                          np.zeros(3, "float32")}, main, "cpu")


def test_port_registers_the_training_path_ops(fuse_flag):
    """Every op type of the tiny GPT's programs (fused and unfused), of
    the tiny GPT under each of the other optimizers, and of every
    learning-rate schedule has a lowering in the port once
    ``paddle_tpu_torch`` is imported, as do the optimizer ops without a
    class (``proximal_gd``, ``proximal_adagrad``) and the rest of the
    comparison family."""
    from paddle_tpu_torch.core import registry

    for fuse in ("on", "off"):
        fuse_flag(fuse)
        main, startup, _, _ = _build_port(tgpt.GPTConfig.tiny())
        for program in (main, startup):
            for op in program.global_block().ops:
                assert registry.has_op(op.type), op.type
    O, L = fluid.optimizer, fluid.layers
    optimizers = [O.AdagradOptimizer(0.1), O.AdamaxOptimizer(),
                  O.DpsgdOptimizer(), O.DecayedAdagradOptimizer(0.1),
                  O.AdadeltaOptimizer(0.1), O.RMSPropOptimizer(0.1),
                  O.FtrlOptimizer(0.1), O.LambOptimizer(),
                  O.LarsMomentumOptimizer(0.1)]
    schedules = [lambda: L.noam_decay(64, 4),
                 lambda: L.exponential_decay(0.1, 3, 0.5, staircase=True),
                 lambda: L.natural_exp_decay(0.1, 3, 0.5),
                 lambda: L.inverse_time_decay(0.1, 3, 0.5),
                 lambda: L.polynomial_decay(0.1, 8, cycle=True),
                 lambda: L.piecewise_decay([2, 4], [0.1, 0.01, 0.001]),
                 lambda: L.cosine_decay(0.1, 2, 4),
                 lambda: L.linear_lr_warmup(0.1, 2, 0.0, 0.1)]
    seen = set()
    for opt, schedule in zip(optimizers, schedules + schedules[:1]):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            loss = fluid.layers.mean(fluid.layers.fc(
                fluid.layers.data("x", [4]), 2))
            opt._learning_rate = schedule()
            opt.minimize(loss)
        for program in (main, startup):
            seen |= {op.type for op in program.global_block().ops}
    assert {"lamb", "lars_momentum", "adagrad", "decayed_adagrad",
            "adadelta", "adamax", "rmsprop", "ftrl", "dpsgd", "increment",
            "cast", "exp", "floor", "ceil", "cos", "pow", "less_than",
            "where", "elementwise_min", "elementwise_max"} <= seen
    for t in sorted(seen) + ["proximal_gd", "proximal_adagrad",
                             "elementwise_pow", "equal", "not_equal",
                             "less_equal", "greater_than", "greater_equal",
                             "logical_and", "logical_or", "logical_xor"]:
        assert registry.has_op(t), t
    with pytest.raises(NotImplementedError, match="no registered lowering"):
        registry.get_op_def("conv3d")
    # the rest of the training path: a MoE GPT under gradient merge over
    # recompute, the meta-optimizers, DeepFM and wide&deep with sparse
    # tables, and the control flow; every op of every block, sub-blocks
    # included, lowers (the control-flow ops through core/control_flow.py)
    from paddle_tpu_torch.core.executor import _CONTROL_FLOW
    from paddle_tpu_torch.models import ctr

    def all_ops(program):
        return [op for blk in program.blocks for op in blk.ops]

    programs = []
    cfg = tgpt.GPTConfig.tiny()
    cfg.moe_every = 2
    with fluid.unique_name.guard():
        opt = O.RecomputeOptimizer(O.Adam(1e-3))
        main, startup, _, _ = tgpt.build_gpt_lm(cfg, 16)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = main.global_block().var(
            [op for op in main.global_block().ops
             if op.type == "mean"][-1].output("Out")[0])
        opt._set_checkpoints([loss])
        O.GradientMergeOptimizer(opt, k_steps=2).minimize(loss)
    programs += [main, startup]
    for meta in ("ema", "model_average", "lookahead"):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            loss = fluid.layers.mean(fluid.layers.fc(
                fluid.layers.data("x", [4]), 2))
            if meta == "lookahead":
                O.LookaheadOptimizer(O.SGD(0.1), k=2).minimize(loss)
            else:
                O.SGD(0.1).minimize(loss)
                if meta == "ema":
                    O.ExponentialMovingAverage(0.9).update()
                else:
                    O.ModelAverage(0.15)
        programs += [main, startup]
    for build in (ctr.build_deepfm, ctr.build_wide_deep):
        for opt in (O.SGD(0.1), O.Momentum(0.1, 0.9), O.Adam(0.1),
                    O.Adagrad(0.1)):
            main, startup, _, _ = build(optimizer=opt, is_sparse=True)
            programs += [main, startup]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        i = L.fill_constant([1], "int64", 0)
        arr = L.create_array("float32", 3, [2])
        cond = L.less_than(i, L.fill_constant([1], "int64", 3))
        loop = L.While(cond)
        with loop.block():
            L.array_write(L.fill_constant([2], "float32", 1.0), i, array=arr)
            L.increment(i, 1.0)
            L.less_equal(i, L.fill_constant([1], "int64", 2), cond=cond)
        L.array_read(arr, i)
        L.array_length(arr)
        sw = L.Switch()
        with sw:
            with sw.case(L.greater_equal(i, i)):
                L.assign(L.fill_constant([1], "int64", 1), i)
            with sw.default():
                L.assign(L.fill_constant([1], "int64", 2), i)
    programs += [main, startup]
    new = set()
    for program in programs:
        for op in all_ops(program):
            new.add(op.type)
            assert registry.has_op(op.type) or op.type in _CONTROL_FLOW, \
                op.type
    assert {"switch_moe", "recompute_segment_grad", "elementwise_mod",
            "sigmoid", "concat", "sigmoid_cross_entropy_with_logits",
            "while", "conditional_block", "write_to_array",
            "read_from_array", "lod_array_length", "logical_not",
            "lookup_table_grad"} <= new
    for t in ("merge_selected_rows", "get_tensor_from_selected_rows",
              "lookup_table_v2", "lookup_table_v2_grad"):
        assert registry.has_op(t), t


def test_no_gpu_means_no_executor():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fluid.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fluid.Executor(fluid.CUDAPlace(0))
