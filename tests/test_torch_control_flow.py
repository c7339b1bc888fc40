"""The port's structured control flow (``core/control_flow.py``,
``layers/control_flow.py``) against the JAX package, on the CPU.

(a) Twins of tests/test_control_flow.py: a While summing to ten and a
    Switch whose first matching case wins.
(b) The same programs through both Executors: ``cond``, the dense tensor
    arrays (``create_array`` / ``array_write`` / ``array_read`` /
    ``array_length``) written in a While, a ``while`` nested in a
    ``conditional_block``, the comparison family, and a persistable
    counter written inside a loop going back to the scope.
(c) The bound plan: a var that only a sub-block reads stays live until
    its op has run, and a var freed before would be missing.
(d) Like ``lax.while_loop``, ``while`` has no gradient:
    ``append_backward`` over one raises as JAX's does.
(e) ``StaticRNN`` / ``DynamicRNN`` build their ``recurrent`` op and run
    (held to JAX in tests/test_torch_rnn.py).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.core.framework import unique_name as jax_unique_name

import paddle_tpu_torch as fluid

RTOL, ATOL = 1e-6, 1e-6


def _names(pkg):
    return jax_unique_name if pkg is jfluid else fluid.unique_name


def _run(pkg, build, feed, fetch_names):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), _names(pkg).guard():
        fetches = build(pkg)
    if pkg is jfluid:
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(startup)
            out = exe.run(main, feed=feed, fetch_list=fetches)
        return [np.asarray(o) for o in out], scope
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    out = exe.run(main, feed=feed, fetch_list=fetches, scope=scope)
    return out, scope


def _both(build, feed=None, fetch_names=None):
    jout, _ = _run(jfluid, build, feed or {}, fetch_names)
    tout, _ = _run(fluid, build, feed or {}, fetch_names)
    assert len(jout) == len(tout)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                                   np.asarray(b, dtype=np.float64),
                                   rtol=RTOL, atol=ATOL)
    return tout


# -- (a) twins --------------------------------------------------------------------


def _while_sum(pkg, limit_value=10.0):
    L = pkg.layers
    i = L.fill_constant([1], "float32", 0.0)
    total = L.fill_constant([1], "float32", 0.0)
    limit = L.fill_constant([1], "float32", limit_value)
    cond = L.less_than(i, limit)
    loop = L.While(cond)
    with loop.block():
        ni = L.elementwise_add(i, L.fill_constant([1], "float32", 1.0))
        nt = L.elementwise_add(total, ni)
        L.assign(ni, i)
        L.assign(nt, total)
        L.less_than(i, limit, cond=cond)
    return [total, i]


def test_while_loop_sums_to_ten():
    res, _ = _run(fluid, _while_sum, {}, None)
    assert float(res[0].reshape(-1)[0]) == 55.0     # 1 + 2 + ... + 10
    assert float(res[1].reshape(-1)[0]) == 10.0


def _switch(pkg):
    L = pkg.layers
    x = L.data("x", [1])
    out = L.fill_constant([1], "float32", -1.0)
    zero = L.fill_constant([1], "float32", 0.0)
    ten = L.fill_constant([1], "float32", 10.0)
    sw = L.Switch()
    with sw:
        with sw.case(L.greater_than(x, ten)):
            L.assign(L.fill_constant([1], "float32", 1000.0), out)
        with sw.case(L.greater_than(x, zero)):
            L.assign(L.fill_constant([1], "float32", 100.0), out)
        with sw.default():
            L.assign(L.fill_constant([1], "float32", 7.0), out)
    return [out]


@pytest.mark.parametrize("x,want", [(2.0, 100.0), (-2.0, 7.0), (20.0, 1000.0)])
def test_switch_selects_case(x, want):
    """The first matching case wins; the default only when none did."""
    feed = {"x": np.array([[x]], "float32")}
    (got,) = _both(_switch, feed)
    assert float(got.reshape(-1)[0]) == want


# -- (b) programs through both Executors ---------------------------------------


@pytest.mark.parametrize("limit", [0.0, 1.0, 10.0])
def test_while_equals_jax(limit):
    _both(lambda pkg: _while_sum(pkg, limit))


def _cond_prog(pkg):
    L = pkg.layers
    x = L.data("x", [3])
    s = L.reduce_sum(x, dim=[1], keep_dim=True)
    pred = L.greater_than(s, L.fill_constant([1], "float32", 0.0))
    out = L.cond(pred, lambda: L.scale(x, scale=2.0),
                 lambda: L.scale(x, scale=-1.0, bias=1.0))
    return [out]


def test_cond_selects_per_row_as_jax():
    feed = {"x": np.array([[1.0, 2.0, -0.5], [-3.0, 0.5, 0.1]], "float32")}
    (out,) = _both(_cond_prog, feed)
    np.testing.assert_allclose(out[0], [2.0, 4.0, -1.0])
    np.testing.assert_allclose(out[1], [4.0, 0.5, 0.9], rtol=1e-6)


def _arrays_prog(pkg, n=4):
    """squares written into an array in a While, read back and summed."""
    L = pkg.layers
    arr = L.create_array("float32", n, [2])
    i = L.fill_constant([1], "int64", 0)
    fi = L.fill_constant([1], "float32", 0.0)
    limit = L.fill_constant([1], "int64", n)
    cond = L.less_than(i, limit)
    loop = L.While(cond)
    with loop.block():
        v = L.elementwise_mul(L.fill_constant([2], "float32", 1.0),
                              L.elementwise_mul(fi, fi))
        L.array_write(v, i, array=arr)
        L.increment(i, 1.0)
        L.increment(fi, 1.0)
        L.less_than(i, limit, cond=cond)
    third = L.array_read(arr, L.fill_constant([1], "int64", 3))
    length = L.array_length(arr)
    return [arr, third, length]


def test_tensor_arrays_in_a_while_equal_jax():
    arr, third, length = _both(_arrays_prog)
    np.testing.assert_allclose(arr[:, 0], [0.0, 1.0, 4.0, 9.0])
    np.testing.assert_allclose(third, [9.0, 9.0])
    assert int(length.reshape(-1)[0]) == 4


def _nested_prog(pkg):
    """A while inside a conditional_block: counts to x when x > 0."""
    L = pkg.layers
    x = L.data("x", [1])
    i = L.fill_constant([1], "float32", 0.0)
    acc = L.fill_constant([1], "float32", 0.0)
    sw = L.Switch()
    with sw:
        with sw.case(L.greater_than(x, L.fill_constant([1], "float32", 0.0))):
            cond = L.less_than(i, x)
            loop = L.While(cond)
            with loop.block():
                L.assign(L.elementwise_add(
                    i, L.fill_constant([1], "float32", 1.0)), i)
                L.assign(L.elementwise_add(acc, i), acc)
                L.less_than(i, x, cond=cond)
    return [acc, i]


@pytest.mark.parametrize("x,want", [(4.0, 10.0), (-1.0, 0.0)])
def test_while_nested_in_conditional_block_equals_jax(x, want):
    acc, _ = _both(_nested_prog, {"x": np.array([[x]], "float32")})
    assert float(acc.reshape(-1)[0]) == want


@pytest.mark.parametrize("name", ["less_than", "less_equal", "greater_than",
                                  "greater_equal", "equal", "not_equal"])
def test_comparisons_equal_jax(name):
    def build(pkg):
        L = pkg.layers
        x = L.data("x", [4])
        y = L.data("y", [4])
        return [getattr(L, name)(x, y)]

    x = np.array([[1.0, 2.0, 3.0, 4.0]], "float32")
    y = np.array([[1.0, 3.0, 2.0, 4.0]], "float32")
    _both(build, {"x": x, "y": y})


def test_persistable_counter_written_in_a_loop_reaches_the_scope():
    """A persistable the sub-block writes goes back to the scope, and a
    second run continues from it."""
    def build(pkg):
        L = pkg.layers
        counter = L.create_global_var([1], 0.0, "float32", persistable=True,
                                      name="loop_counter")
        i = L.fill_constant([1], "float32", 0.0)
        three = L.fill_constant([1], "float32", 3.0)
        cond = L.less_than(i, three)
        loop = L.While(cond)
        with loop.block():
            L.increment(i, 1.0)
            L.increment(counter, 2.0)
            L.less_than(i, three, cond=cond)
        return [counter]

    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), _names(pkg).guard():
            (counter,) = build(pkg)
        scope = pkg.Scope()
        if pkg is jfluid:
            with jfluid.scope_guard(scope):
                exe = jfluid.Executor(jfluid.CPUPlace())
                exe.run(startup)
                outs = [exe.run(main, fetch_list=[counter])[0]
                        for _ in range(2)]
            jouts = [float(np.asarray(o).reshape(-1)[0]) for o in outs]
        else:
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup, scope=scope)
            outs = [exe.run(main, fetch_list=[counter], scope=scope)[0]
                    for _ in range(2)]
            touts = [float(o.reshape(-1)[0]) for o in outs]
            assert float(scope.get_numpy("loop_counter")[0]) == 12.0
    assert touts == jouts == [6.0, 12.0]


# -- (c) the bound plan ------------------------------------------------------------


def test_a_var_only_the_sub_block_reads_stays_live():
    """``step`` is read by nothing in the global block after its op but
    by the loop's body; the plan keeps it until the while has run."""
    from paddle_tpu_torch.core.executor import _Plan

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        step = L.scale(L.data("s", [1]), scale=1.0)
        i = L.fill_constant([1], "float32", 0.0)
        n = L.fill_constant([1], "float32", 3.0)
        cond = L.less_than(i, n)
        loop = L.While(cond)
        with loop.block():
            L.assign(L.elementwise_add(i, step), i)
            L.less_than(i, n, cond=cond)
    plan = _Plan(main.global_block(), ["s"], [i.name])
    k = [op.type for op in plan.ops].index("while")
    freed_before = {n for fa in plan.free_after[:k] for n in fa}
    assert step.name not in freed_before
    assert step.name in plan.reads[k][0][1]
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    (got,) = exe.run(main, feed={"s": np.array([[1.5]], "float32")},
                     fetch_list=[i])
    assert float(got.reshape(-1)[0]) == 3.0


# -- (d) no gradient through a while ---------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_append_backward_refuses_a_while(pkg):
    p = jfluid if pkg == "jax" else fluid
    main, startup = p.Program(), p.Program()
    with p.program_guard(main, startup), _names(p).guard():
        L = p.layers
        x = L.data("x", [2])
        h = L.fc(x, 2)
        i = L.fill_constant([1], "float32", 0.0)
        cond = L.less_than(i, L.fill_constant([1], "float32", 2.0))
        loop = L.While(cond)
        with loop.block():
            L.assign(L.elementwise_add(h, h), h)
            L.increment(i, 1.0)
            L.less_than(i, L.fill_constant([1], "float32", 2.0), cond=cond)
        loss = L.mean(h)
        with pytest.raises(NotImplementedError, match="while"):
            p.optimizer.SGD(0.1).minimize(loss)


def test_static_and_dynamic_rnn_are_refused_naming_a11():
    """Ported now (ROADMAP A11b): both layers build their ``recurrent``
    op and run (their parity with JAX: tests/test_torch_rnn.py)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        blk = main.global_block()
        xs = blk.create_var(name="xs", shape=(3, 2, 4), dtype="float32",
                            is_data=True)
        xb = blk.create_var(name="xb", shape=(2, 3, 4), dtype="float32",
                            is_data=True)
        ln = blk.create_var(name="ln", shape=(2,), dtype="int32",
                            is_data=True)
        rnn = L.StaticRNN()
        with rnn.step():
            w = rnn.step_input(xs)
            prev = rnn.memory(shape=[-1, 4], batch_ref=w, ref_batch_dim_idx=0)
            h = L.elementwise_add(w, prev)
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        drnn = L.DynamicRNN()
        with drnn.block():
            w = drnn.step_input(xb, length=ln)
            prev = drnn.memory(shape=[4], value=0.0)
            h = L.elementwise_add(w, prev)
            drnn.update_memory(prev, h)
            drnn.output(h)
        outs = [rnn(), drnn()]
    assert [op.type for op in main.global_block().ops].count("recurrent") == 2
    x = np.ones((3, 2, 4), np.float32)
    so, do = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"xs": x, "xb": x.transpose(1, 0, 2),
                    "ln": np.array([3, 1], np.int32)},
        fetch_list=outs, scope=fluid.Scope())
    np.testing.assert_array_equal(so[:, 0, 0], [1, 2, 3])   # running sums
    np.testing.assert_array_equal(do[1, :, 0], [1, 0, 0])   # zeros past 1
