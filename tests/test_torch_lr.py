"""The port's learning-rate schedules against the JAX package, on the
CPU (``paddle_tpu/layers/learning_rate_scheduler.py:60-159``).

Each schedule is built alone in a Program of each package and run 12
times through its Executor, the learning rate fetched every run: the
values agree at float32 rtol 1e-6 (``exp``, ``cos`` and ``pow`` of two
libraries may differ in the last bit). The persistable counter
``@LR_DECAY_COUNTER@`` starts at 0 and is incremented before it is read,
so the first run sees step 1 in both; staircase decays, ``cycle=True``
and piecewise boundaries are cases, and linear warmup runs over a float
and over another schedule. Last, a warmup-then-decay learning rate drives
Lamb on a two-fc net in both packages, losses and persistables at the
training tolerance.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.core.framework import unique_name as jax_unique_name

import paddle_tpu_torch as fluid
from paddle_tpu_torch.io import load_scope_arrays

RTOL = 1e-6
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5
RUNS = 12


def _names(pkg):
    return jax_unique_name if pkg is jfluid else fluid.unique_name


SCHEDULES = {
    "noam": lambda L: L.noam_decay(64, 4, learning_rate=2.0),
    "exponential": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(
        0.1, 3, 0.5, staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 4, 0.3),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(
        0.1, 4, 0.3, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 2, 0.7),
    "inverse_time_staircase": lambda L: L.inverse_time_decay(
        0.1, 2, 0.7, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 8, 0.001, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(
        0.1, 5, 0.001, power=1.0, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([3, 6, 9], [0.1, 0.05, 0.01,
                                                          0.001]),
    "cosine": lambda L: L.cosine_decay(0.1, 2, 6),
    "warmup_float": lambda L: L.linear_lr_warmup(0.1, 5, 0.0, 0.1),
    "warmup_over_decay": lambda L: L.linear_lr_warmup(
        L.polynomial_decay(1e-4, 8, end_learning_rate=0.0, power=1.0),
        2, 0.0, 1e-4),
}


def _lrs(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), _names(pkg).guard():
        lr = build(pkg.layers)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        exe.run(startup)
        out = [float(np.asarray(exe.run(main, fetch_list=[lr])[0])
                     .reshape(-1)[0]) for _ in range(RUNS)]
        counter = np.asarray(scope.find_var("@LR_DECAY_COUNTER@")
                             if pkg is jfluid else
                             scope.get_numpy("@LR_DECAY_COUNTER@"))
    return out, main, counter


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    want, jmain, jcount = _lrs(jfluid, SCHEDULES[name])
    got, tmain, tcount = _lrs(fluid, SCHEDULES[name])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert float(tcount.reshape(-1)[0]) == float(jcount.reshape(-1)[0]) == RUNS
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    assert sorted(v.name for v in tmain.list_vars() if v.persistable) == \
        sorted(v.name for v in jmain.list_vars() if v.persistable)


def test_first_run_sees_step_one():
    """The counter is created at 0 and incremented before the read."""
    got, _, _ = _lrs(fluid, lambda L: L.linear_lr_warmup(1.0, 100, 0.0, 100.0))
    assert got[:3] == [1.0, 2.0, 3.0]
    got, _, _ = _lrs(fluid, lambda L: L.piecewise_decay([1, 2], [7.0, 8.0,
                                                                 9.0]))
    assert got[:3] == [8.0, 9.0, 9.0]


def _lamb_net(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 8
    with pkg.program_guard(main, startup), _names(pkg).guard():
        x = pkg.layers.data("x", [8])
        y = pkg.layers.data("y", [1], dtype="int64")
        logits = pkg.layers.fc(pkg.layers.fc(x, 16, act="relu"), 4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        lr = pkg.layers.linear_lr_warmup(
            pkg.layers.polynomial_decay(0.05, 8, end_learning_rate=0.0,
                                        power=1.0), 2, 0.0, 0.05)
        pkg.optimizer.LambOptimizer(lr).minimize(loss)
    return main, startup, loss, lr


def test_schedule_drives_lamb_as_jax():
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(16, 8).astype("float32"),
            "y": rng.randint(0, 4, (16, 1)).astype("int64")}
    jmain, jstart, jloss, jlr = _lamb_net(jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        names = sorted(v.name for v in jmain.list_vars()
                       if v.persistable and not v.is_data)
        init = {n: np.asarray(scope.find_var(n)) for n in names}
        jout = [exe.run(jmain, feed=feed, fetch_list=[jloss, jlr])
                for _ in range(10)]
        jfinal = {n: np.asarray(scope.find_var(n)) for n in names}
    tmain, _, tloss, tlr = _lamb_net(fluid)
    tscope = fluid.Scope()
    load_scope_arrays(tscope, init, tmain, "cpu")
    texe = fluid.Executor(fluid.CPUPlace())
    tout = [texe.run(tmain, feed=feed, fetch_list=[tloss, tlr], scope=tscope)
            for _ in range(10)]
    np.testing.assert_allclose([float(np.asarray(o[1]).reshape(-1)[0])
                                for o in tout],
                               [float(np.asarray(o[1]).reshape(-1)[0])
                                for o in jout], rtol=RTOL)
    np.testing.assert_allclose([float(o[0]) for o in tout],
                               [float(np.asarray(o[0])) for o in jout],
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    for n in names:
        np.testing.assert_allclose(tscope.get_numpy(n), jfinal[n],
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                   err_msg=n)
