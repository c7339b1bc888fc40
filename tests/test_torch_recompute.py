"""Recompute (activation checkpointing) and gradient merge in the port,
against the JAX package on the CPU: twins of tests/test_recompute.py.

(a) ``RecomputeOptimizer`` trains the deep MLP as plain SGD does, and as
    JAX's recompute run does, at the recompute test's tolerance (rtol
    1e-5, atol 1e-6); under Momentum too. (Adam moves a weight whose
    gradient is a rounding error by lr whatever its sign, so it is not
    held at 1e-5: its merged run is held at the merge tolerance.)
(b) The backward is one ``recompute_segment_grad`` op a segment (3 for 2
    checkpoints) and no per-op grad op; the port's program equals JAX's
    op for op (types, slots, var names, the segments' attrs and their
    sub-blocks' ops).
(c) JAX's HLO-counting test becomes two checks of the eager run: the
    segments' first forward records nothing on the tape (no
    ``run_recorded`` call in a step), and each segment's forward ops are
    lowered twice a step (once forward, once in the segment's gradient).
    A dropout inside a segment draws the same mask in its rerun, so a
    recompute run with dropout equals the plain run with dropout.
(d) ``GradientMergeOptimizer``: k = 4 microbatches of batch 32 train as
    the full batch (rtol 1e-4, atol 1e-5), as JAX's do; the fetched loss
    is the microbatches' mean; k must divide the batch (JAX's
    ``ValueError``); merged over recompute too; each microbatch draws
    its own dropout mask.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.core.framework import unique_name as jax_unique_name

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.io import load_scope_arrays
from paddle_tpu_torch.runtime import dispatch

RC_RTOL, RC_ATOL = 1e-5, 1e-6
GM_RTOL, GM_ATOL = 1e-4, 1e-5


def _names(pkg):
    return jax_unique_name if pkg is jfluid else fluid.unique_name


def _deep_mlp(pkg, width=32, depth=6, dropout=0.0):
    L = pkg.layers
    x = L.data("x", [width])
    label = L.data("label", [1], dtype="int64")
    h = x
    ckpts = []
    for i in range(depth):
        h = L.fc(h, width, act="relu")
        if dropout:
            h = L.dropout(h, dropout,
                          dropout_implementation="upscale_in_train")
        if i in (depth // 3, 2 * depth // 3):
            ckpts.append(h)
    logits = L.fc(h, 10)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    return loss, ckpts


def _build(pkg, opt_factory, dropout=0.0):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.program_guard(main, startup), _names(pkg).guard():
        loss, ckpts = _deep_mlp(pkg, dropout=dropout)
        opt = opt_factory(pkg)
        inner = getattr(opt, "inner_optimizer", opt)
        if isinstance(inner, pkg.optimizer.RecomputeOptimizer):
            inner._set_checkpoints(ckpts)
        opt.minimize(loss)
    return main, startup, loss


def _feeds(steps=5, batch=16, width=32, seed=3):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(batch, width).astype("float32"),
             "label": rng.randint(0, 10, (batch, 1)).astype("int64")}
            for _ in range(steps)]


def _persistables(program):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and not v.is_data)


def _train_port(opt_factory, feeds, init=None, dropout=0.0):
    main, startup, loss = _build(fluid, opt_factory, dropout)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    if init is None:
        exe.run(startup, scope=scope)
    else:
        load_scope_arrays(scope, init, main, "cpu")
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
    return losses, {n: scope.get_numpy(n) for n in _persistables(main)}


def _train_jax(opt_factory, feeds):
    main, startup, loss = _build(jfluid, opt_factory)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
        losses = [float(np.asarray(exe.run(main, feed=f,
                                           fetch_list=[loss])[0]))
                  for f in feeds]
        final = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
    return init, losses, final


def _close(a_losses, a_params, b_losses, b_params, rtol, atol):
    np.testing.assert_allclose(a_losses, b_losses, rtol=rtol, atol=atol)
    assert sorted(a_params) == sorted(b_params) and a_params
    for n in b_params:
        np.testing.assert_allclose(a_params[n], b_params[n], rtol=rtol,
                                   atol=atol, err_msg=n)


def _sgd(pkg):
    return pkg.optimizer.SGD(0.1)


def _rc_sgd(pkg):
    return pkg.optimizer.RecomputeOptimizer(pkg.optimizer.SGD(0.1))


def _rc_momentum(pkg):
    return pkg.optimizer.RecomputeOptimizer(
        pkg.optimizer.Momentum(0.05, momentum=0.9))


# -- (a) --------------------------------------------------------------------------


def test_recompute_training_parity():
    feeds = _feeds()
    base = _train_port(_sgd, feeds)
    rc = _train_port(_rc_sgd, feeds)
    _close(*rc, *base, RC_RTOL, RC_ATOL)


@pytest.mark.parametrize("name", ["sgd", "momentum"])
def test_recompute_trains_as_jax(name):
    factory = {"sgd": _rc_sgd, "momentum": _rc_momentum}[name]
    feeds = _feeds()
    init, jl, jfinal = _train_jax(factory, feeds)
    tl, tfinal = _train_port(factory, feeds, init)
    _close(tl, tfinal, jl, jfinal, RC_RTOL, RC_ATOL)


# -- (b) --------------------------------------------------------------------------


def test_recompute_emits_segment_ops_not_per_op_grads():
    main, _, _ = _build(fluid, _rc_sgd)
    types = [op.type for op in main.global_block().ops]
    assert types.count("recompute_segment_grad") == 3   # 2 ckpts, 3 segments
    assert not any(t.endswith("_grad") and t != "recompute_segment_grad"
                   for t in types)


def _op_view(op):
    attrs = {}
    for k, v in op.attrs.items():
        if k == "sub_block":
            attrs[k] = [_op_view(o) for o in v.ops]
        elif k != "op_ident":
            attrs[k] = v
    return (op.type, op.inputs, op.outputs, attrs)


def test_recompute_program_equals_jax():
    jmain, _, _ = _build(jfluid, _rc_sgd)
    tmain, _, _ = _build(fluid, _rc_sgd)
    jops, tops = jmain.global_block().ops, tmain.global_block().ops
    assert len(tops) == len(jops)
    for t, j in zip(tops, jops):
        assert _op_view(t) == _op_view(j)
    assert sorted(tmain.global_block().vars) == sorted(jmain.global_block().vars)


# -- (c) --------------------------------------------------------------------------


def _count_lowerings(monkeypatch, op_type):
    calls = {"n": 0}
    opdef = tregistry.get_op_def(op_type)
    orig = opdef.lower

    def counted(ctx, op, ins):
        calls["n"] += 1
        return orig(ctx, op, ins)

    monkeypatch.setattr(opdef, "lower", counted)
    return calls


def _count_recorded(monkeypatch):
    calls = {"n": 0}
    orig = dispatch.run_recorded

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(dispatch, "run_recorded", counted)
    return calls


@pytest.mark.parametrize("recompute", [False, True])
def test_segments_record_nothing_and_rerun_their_forward(recompute,
                                                         monkeypatch):
    main, startup, loss = _build(fluid, _rc_sgd if recompute else _sgd)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    muls = _count_lowerings(monkeypatch, "mul")
    recorded = _count_recorded(monkeypatch)
    exe.run(main, feed=_feeds(1)[0], fetch_list=[loss], scope=scope)
    n_fc = 7
    if recompute:
        # the first forward records nothing; each segment's fcs lower
        # twice (forward, then its gradient's rerun)
        assert recorded["n"] == 0
        assert muls["n"] == 2 * n_fc
        plan = exe._plans[next(iter(exe._plans))]
        assert plan.record == {}
    else:
        assert recorded["n"] > 0
        assert muls["n"] == n_fc


def test_recompute_replays_the_dropout_masks():
    feeds = _feeds(3)
    base = _train_port(_sgd, feeds, dropout=0.3)
    rc = _train_port(_rc_sgd, feeds, dropout=0.3)
    _close(*rc, *base, RC_RTOL, RC_ATOL)


# -- (d) --------------------------------------------------------------------------


def _gm(inner):
    return lambda pkg: pkg.optimizer.GradientMergeOptimizer(inner(pkg),
                                                            k_steps=4)


def test_gradient_merge_parity_with_full_batch():
    """k microbatch grad-means averaged == the full-batch grad mean."""
    feeds = _feeds(batch=32)
    bl, bp = _train_port(_sgd, feeds)
    gl, gp = _train_port(_gm(_sgd), feeds)
    np.testing.assert_allclose(gl[-1], bl[-1], rtol=GM_RTOL, atol=GM_ATOL)
    for n in bp:
        np.testing.assert_allclose(gp[n], bp[n], rtol=GM_RTOL, atol=GM_ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("inner", ["sgd", "adam", "recompute_sgd"])
def test_gradient_merge_trains_as_jax(inner):
    factory = _gm({"sgd": _sgd, "adam": lambda pkg: pkg.optimizer.Adam(1e-2),
                   "recompute_sgd": _rc_sgd}[inner])
    feeds = _feeds(batch=32)
    init, jl, jfinal = _train_jax(factory, feeds)
    tl, tfinal = _train_port(factory, feeds, init)
    _close(tl, tfinal, jl, jfinal, GM_RTOL, GM_ATOL)


def test_gradient_merge_rejects_indivisible_batch():
    main, startup, loss = _build(
        fluid, lambda pkg: pkg.optimizer.GradientMergeOptimizer(
            pkg.optimizer.SGD(0.1), k_steps=3))
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="does not divide"):
        exe.run(main, feed={"x": np.zeros((16, 32), "float32"),
                            "label": np.zeros((16, 1), "int64")},
                fetch_list=[loss], scope=scope)


def test_gradient_merge_microbatches_draw_their_own_masks():
    """Two identical microbatches under dropout: their losses differ,
    so the fetched mean differs from each (the masks are keyed by the
    microbatch); two fresh runs of the same step repeat bit for bit."""
    feed = _feeds(1, batch=8)[0]
    twice = {k: np.concatenate([v, v]) for k, v in feed.items()}

    def run(k):
        main, startup, loss = _build(
            fluid, lambda pkg: pkg.optimizer.GradientMergeOptimizer(
                pkg.optimizer.SGD(0.0), k_steps=k), dropout=0.5)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        return float(exe.run(main, feed=twice if k == 2 else feed,
                             fetch_list=[loss], scope=scope)[0])

    merged = run(2)
    assert merged == run(2)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(merged, run(1), rtol=1e-7)
