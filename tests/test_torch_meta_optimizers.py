"""ExponentialMovingAverage, ModelAverage and LookaheadOptimizer in the
port against the JAX package, on the CPU.

A two-fc net trains 4 steps in both packages from JAX's startup values
(``io.load_scope_arrays``). Held at ``TRAIN_RTOL`` / ``TRAIN_ATOL``:
the losses and every persistable (parameters, EMA shadows and their
step counter, ModelAverage's sums and count, Lookahead's slow weights
and step); the values ``apply()`` swaps into the scope (the EMA's bias-
corrected shadows, ModelAverage's sum / count) and the parameters it
restores after (bit for bit: the scope gets its own tensors back).
Lookahead over Adam with the fused update (K10's plain version here)
and with the unfused one: the slow weights start as a copy of the
parameters (their own storage, so the in-place update leaves them).
The five names import; DGC and Pipeline are refused naming A10.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.core.framework import unique_name as jax_unique_name

import paddle_tpu_torch as fluid
from paddle_tpu_torch.io import load_scope_arrays

TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5
STEPS = 4


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


def _names(pkg):
    return jax_unique_name if pkg is jfluid else fluid.unique_name


def _persistables(program):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and not v.is_data)


def _build(pkg, kind):
    """(main, startup, loss, meta) with ``meta`` the EMA / ModelAverage
    object (None for Lookahead)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 9
    meta = None
    with pkg.program_guard(main, startup), _names(pkg).guard():
        L = pkg.layers
        x = L.data("x", [8])
        y = L.data("y", [1], dtype="int64")
        h = L.fc(x, 16, act="relu")
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, 4), y))
        O = pkg.optimizer
        if kind == "ema":
            O.SGD(0.1).minimize(loss)
            meta = O.ExponentialMovingAverage(0.9)
            meta.update()
        elif kind == "model_average":
            O.Momentum(0.1, momentum=0.9).minimize(loss)
            meta = O.ModelAverage(0.15)
        else:
            O.LookaheadOptimizer(O.Adam(0.05), alpha=0.5, k=2).minimize(loss)
    return main, startup, loss, meta


def _feeds(seed=3):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(16, 8).astype("float32"),
             "y": rng.randint(0, 4, (16, 1)).astype("int64")}
            for _ in range(STEPS)]


def _params(program):
    return sorted(p.name for p in program.all_parameters())


def _run_jax(kind, feeds):
    main, startup, loss, meta = _build(jfluid, kind)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
        losses = [float(np.asarray(exe.run(main, feed=f,
                                           fetch_list=[loss])[0]))
                  for f in feeds]
        final = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
        applied = None
        if meta is not None:
            with meta.apply():
                applied = {n: np.asarray(scope.find_var(n))
                           for n in _params(main)}
    return init, losses, final, applied


def _run_port(kind, feeds, init):
    main, startup, loss, meta = _build(fluid, kind)
    assert _persistables(main) == sorted(init)
    scope = fluid.Scope()
    load_scope_arrays(scope, init, main, "cpu")
    exe = fluid.Executor(fluid.CPUPlace())
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
    final = {n: scope.get_numpy(n) for n in _persistables(main)}
    applied = restored = None
    if meta is not None:
        with fluid.scope_guard(scope):
            before = {n: scope.find_var(n) for n in _params(main)}
            with meta.apply():
                applied = {n: scope.get_numpy(n) for n in _params(main)}
            restored = all(scope.find_var(n) is before[n] for n in before)
    return losses, final, applied, restored


@pytest.mark.parametrize("fuse", ["off", "on"])
@pytest.mark.parametrize("kind", ["ema", "model_average", "lookahead"])
def test_meta_optimizer_trains_as_jax(kind, fuse, fuse_flag):
    fuse_flag(fuse)
    feeds = _feeds()
    init, jl, jfinal, japplied = _run_jax(kind, feeds)
    tl, tfinal, tapplied, restored = _run_port(kind, feeds, init)
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    for n in jfinal:
        np.testing.assert_allclose(tfinal[n], jfinal[n], rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, err_msg=n)
    if kind == "lookahead":
        return
    for n in japplied:
        np.testing.assert_allclose(tapplied[n], japplied[n],
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                   err_msg=n)
        assert not np.array_equal(tapplied[n], tfinal[n]), n
    assert restored


def test_ema_counter_shadows_and_correction():
    """The EMA's own arithmetic: after t steps the counter is t and
    apply() gives shadow / (1 - decay^t), computed here in numpy."""
    feeds = _feeds()
    init, *_ = _run_jax("ema", feeds)
    main, startup, loss, meta = _build(fluid, "ema")
    scope = fluid.Scope()
    load_scope_arrays(scope, init, main, "cpu")
    exe = fluid.Executor(fluid.CPUPlace())
    for f in feeds:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    assert float(scope.get_numpy(meta._counter.name)[0]) == STEPS
    with fluid.scope_guard(scope):
        with meta.apply():
            for p, shadow in meta._shadows.items():
                want = scope.get_numpy(shadow.name) / np.float32(
                    1 - 0.9 ** STEPS)
                np.testing.assert_allclose(scope.get_numpy(p), want,
                                           rtol=1e-6)


def test_lookahead_slow_weights_start_as_a_copy():
    main, startup, loss, _ = _build(fluid, "lookahead")
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    for p in main.all_parameters():
        slow = [v.name for v in main.list_vars()
                if v.name.startswith(p.name + ".slow")]
        assert len(slow) == 1
        a, b = scope.find_var(p.name), scope.find_var(slow[0])
        assert a is not b and a.data_ptr() != b.data_ptr()
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_meta_optimizers_import():
    for name in ("ExponentialMovingAverage", "ModelAverage",
                 "RecomputeOptimizer", "LookaheadOptimizer",
                 "GradientMergeOptimizer"):
        assert callable(getattr(fluid.optimizer, name))
