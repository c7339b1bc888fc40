"""The port's ``dygraph_to_static`` (``declarative``, the AST transform of
if / while / for / break / continue / return and the bool ops) against
the JAX package's, on the CPU: the 28 cases of
tests/test_dygraph_to_static.py, under their names, each function
written over torch tensors for the port and run against the JAX test's
own function (or its twin over jnp) on the same values. Results equal
within rtol 1e-6 (the same float32 arithmetic, a step at a time).

The port has no tracer: a converted function reads each predicate on the
host and runs the original Python branch and loop, as JAX's eager path
does. What only ``jax.jit`` can show has no counterpart here and is not
tested:

* the jitted halves of every case (both branches traced into
  ``lax.cond``, loops into ``lax.while_loop``, a traced range bound);
* ``test_user_one_branch_none_sentinel_raises_under_jit``: the raise
  under jit (the eager ``None`` is held);
* ``test_traced_loop_conditional_assignment_still_raises``: the raise
  under jit (the eager result is held);
* ``test_tuple_early_return_under_jit``: the jitted call (the eager
  tuple is held).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_dygraph_to_static as J

import paddle_tpu as jfluid
import paddle_tpu.dygraph as jdg

import paddle_tpu_torch as fluid
import paddle_tpu_torch.dygraph as dg
from paddle_tpu_torch.dygraph import declarative
from paddle_tpu_torch.dygraph.jit import (dygraph_to_static_graph,
                                          dygraph_to_static_output)

CPU = fluid.CPUPlace()


def same(got, want):
    got = got.numpy() if hasattr(got, "numpy") else got
    want = want.numpy() if hasattr(want, "numpy") else want
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-6)


def t(*vals):
    return torch.tensor(np.asarray(vals if len(vals) > 1 else vals[0],
                                   np.float32))


@declarative
def _branchy(x):
    if torch.sum(x) > 0:
        y = x * 2.0
        z = y + 1.0
    else:
        y = -x
        z = y - 1.0
    return z


def test_if_conversion_eager_and_jit():
    for v in (np.ones((2, 2), "float32"), -np.ones((2, 2), "float32")):
        same(_branchy(torch.from_numpy(v)), J._branchy(jnp.asarray(v)))


@declarative
def _loopy(s, cap):
    n = torch.zeros((), dtype=torch.int32)
    while torch.sum(s) < cap:
        s = s * 2.0
        n = n + 1
    return s, n


def test_while_conversion_eager_and_jit():
    s0 = np.ones(4, "float32")
    s, n = _loopy(torch.from_numpy(s0), 100.0)
    js, jn = J._loopy(jnp.asarray(s0), 100.0)
    same(s, js)
    assert int(n) == int(jn) == 5


@declarative
def _boolops(x, lo, hi):
    if (torch.sum(x) > lo) and (torch.sum(x) < hi):
        r = x + 1.0
    else:
        r = x - 1.0
    return r


def test_boolop_conversion():
    x = np.ones(3, "float32")
    for lo, hi in ((0.0, 10.0), (5.0, 10.0), (0.0, 2.0)):
        same(_boolops(torch.from_numpy(x), lo, hi),
             J._boolops(jnp.asarray(x), lo, hi))


def test_varbase_dygraph_control_flow():
    @declarative
    def f(v):
        if torch.sum(v.value if hasattr(v, "value") else v) > 0:
            out = v * 2.0
        else:
            out = v * -1.0
        return out

    @jdg.declarative
    def jf(v):
        if jnp.sum(v.value if hasattr(v, "value") else v) > 0:
            out = v * 2.0
        else:
            out = v * -1.0
        return out

    for x in (np.ones(3, "float32"), -np.ones(3, "float32")):
        with dg.guard(CPU):
            r = f(dg.VarBase(x))
            assert isinstance(r, dg.VarBase)
        with jdg.guard():
            jr = jf(jdg.VarBase(x))
        same(r, jr)


def test_nested_if_in_while():
    @declarative
    def f(x):
        total = torch.zeros((), dtype=torch.float32)
        i = torch.zeros((), dtype=torch.int32)
        while i < 4:
            if x > 0:
                total = total + x
            else:
                total = total - x
            i = i + 1
        return total

    @jdg.declarative
    def jf(x):
        total = jnp.zeros((), "float32")
        i = jnp.zeros((), "int32")
        while i < 4:
            if x > 0:
                total = total + x
            else:
                total = total - x
            i = i + 1
        return total

    for v in (2.0, -3.0):
        same(f(t(v)), jf(jnp.float32(v)))


def test_return_inside_if():
    @declarative
    def f(x):
        if torch.sum(x) > 0:
            return x + 1.0
        return x - 1.0

    @jdg.declarative
    def jf(x):
        if jnp.sum(x) > 0:
            return x + 1.0
        return x - 1.0

    for v in (2.0, -2.0):
        same(f(t(v)), jf(jnp.float32(v)))


def test_return_inside_if_with_fallthrough_code():
    @declarative
    def f(x):
        y = x * 2.0
        if torch.sum(y) > 0:
            return y
        y = y * 10.0
        if torch.sum(y) < -100.0:
            return y + 0.5
        return y

    @jdg.declarative
    def jf(x):
        y = x * 2.0
        if jnp.sum(y) > 0:
            return y
        y = y * 10.0
        if jnp.sum(y) < -100.0:
            return y + 0.5
        return y

    for v in (3.0, -6.0, -1.0):
        same(f(t(v)), jf(jnp.float32(v)))


def test_while_else():
    @declarative
    def f(x):
        i = torch.tensor(0.0)
        while i < x:
            i = i + 1.0
        else:
            i = i + 100.0
        return i

    @jdg.declarative
    def jf(x):
        i = jnp.float32(0.0)
        while i < x:
            i = i + 1.0
        else:
            i = i + 100.0
        return i

    same(f(t(3.0)), jf(jnp.float32(3.0)))


def test_closure_over_local():
    scale = 3.0

    @declarative
    def f(x):
        if torch.sum(x) > 0:
            x = x * scale
        else:
            x = x / scale
        return x

    @jdg.declarative
    def jf(x):
        if jnp.sum(x) > 0:
            x = x * scale
        else:
            x = x / scale
        return x

    for v in (2.0, -6.0):
        same(f(t(v)), jf(jnp.float32(v)))


# -- the reference programs of tests/test_dygraph_to_static.py, over the
# port's fluid ----------------------------------------------------------------


def dyfunc_tensor_shape_1(x):
    x = fluid.dygraph.to_variable(x)
    res = fluid.layers.reshape(x, shape=x.shape)
    return res


def dyfunc_tensor_shape_2(x):
    x = fluid.dygraph.to_variable(x)
    shape = x.shape
    shape2 = shape
    res = fluid.layers.reshape(x, shape2)
    return res


def dyfunc_tensor_shape_3(x):
    x = fluid.dygraph.to_variable(x)
    y = np.ones(5)
    res = fluid.layers.reshape(x, shape=y.shape)
    return res


def test_reference_tensor_shape_programs():
    x = np.ones(5).astype("float32")
    pairs = ((dyfunc_tensor_shape_1, J.dyfunc_tensor_shape_1),
             (dyfunc_tensor_shape_2, J.dyfunc_tensor_shape_2),
             (dyfunc_tensor_shape_3, J.dyfunc_tensor_shape_3))
    for fn, jfn in pairs:
        with dg.guard(CPU):
            out = dygraph_to_static_graph(fn)(x)
        with jfluid.core.dygraph.dygraph_guard():
            jout = J.dygraph_to_static_graph(jfn)(x)
        same(out, jout)


class Pool2D(fluid.dygraph.Layer):
    def __init__(self):
        super(Pool2D, self).__init__()
        self.pool2d = fluid.dygraph.Pool2D(
            pool_size=2, pool_type='avg', pool_stride=1, global_pooling=False)

    @dygraph_to_static_output
    def forward(self, x):
        inputs = fluid.dygraph.to_variable(x)

        def get_result(x):
            return self.pool2d(x)

        pre = get_result(inputs)
        return pre


def test_reference_fetch_feed_pool2d():
    data = np.random.RandomState(0).random_sample((1, 2, 4, 4)).astype(
        "float32")
    with dg.guard(CPU):
        out = Pool2D().forward(data)
    with jfluid.core.dygraph.dygraph_guard():
        jout = J.Pool2D().forward(data)
    same(out, jout)


class Linear(fluid.dygraph.Layer):
    def __init__(self):
        super(Linear, self).__init__()
        self.fc = fluid.dygraph.Linear(
            input_dim=10,
            output_dim=5,
            act='relu',
            param_attr=fluid.ParamAttr(initializer=fluid.initializer.Constant(
                value=0.99)),
            bias_attr=fluid.ParamAttr(initializer=fluid.initializer.Constant(
                value=0.5)))

    @dygraph_to_static_output
    def forward(self, x):
        inputs = fluid.dygraph.to_variable(x)
        pre = self.fc(inputs)
        loss = fluid.layers.mean(pre, name='avg_loss')
        return pre, loss


def test_reference_fetch_feed_linear():
    data = np.random.RandomState(1).random_sample((4, 10)).astype("float32")
    with dg.guard(CPU):
        pre, loss = Linear().forward(data)
    with jfluid.core.dygraph.dygraph_guard():
        jpre, jloss = J.Linear().forward(data)
    same(pre, jpre)
    np.testing.assert_allclose(loss.numpy(), jloss.numpy(), rtol=1e-6)


def test_user_one_branch_none_sentinel_raises_under_jit():
    @declarative
    def f(x):
        y = None
        if torch.sum(x) > 0:
            y = x * 2.0
        return y

    assert f(t(-1.0)) is None
    same(f(t(1.0)), 2.0)


def test_tuple_early_return_under_jit():
    @declarative
    def f(x):
        if torch.sum(x) > 0:
            return x + 1.0, torch.sum(x)
        return x - 1.0, torch.sum(x) * 2.0

    @jdg.declarative
    def jf(x):
        if jnp.sum(x) > 0:
            return x + 1.0, jnp.sum(x)
        return x - 1.0, jnp.sum(x) * 2.0

    for v in (2.0, -2.0):
        (a, b), (ja, jb) = f(t(v)), jf(jnp.float32(v))
        same(a, ja)
        same(b, jb)


def test_eager_reshape_applies_act():
    with dg.guard(CPU):
        x = fluid.dygraph.to_variable(np.array([[-1.0, 4.0]], "float32"))
        out = fluid.layers.reshape(x, [2], act="relu")
        np.testing.assert_allclose(out.numpy(), [0.0, 4.0])


# -- loops ---------------------------------------------------------------------


@declarative
def _for_range(x, n):
    s = x * 0.0
    for i in range(n):
        s = s + x * i
    return s


@declarative
def _for_traced_range(x):
    m = (torch.sum(x) > 0).to(torch.int32) * 3 + 2
    s = x * 0.0
    for _ in range(m):
        s = s + x
    return s


@declarative
def _for_tensor(xs):
    s = xs[0] * 0.0
    for row in xs:
        s = s + row
    return s


@declarative
def _for_enumerate(xs):
    s = xs[0] * 0.0
    for i, row in enumerate(xs, 1):
        s = s + row * i
    return s


@declarative
def _while_break(x):
    i = 0
    s = x * 0.0
    while i < 10:
        s = s + x
        i = i + 1
        if i >= 3:
            break
    return s


@declarative
def _for_continue(n):
    s = 0
    for i in range(n):
        if i % 2 == 0:
            continue
        s = s + i
    return s


@declarative
def _return_in_while(x):
    i = 0
    while i < 100:
        x = x + 1.0
        if torch.sum(x) > 5:
            return x
        i = i + 1
    return x * 0.0


@declarative
def _for_else_break(n, limit):
    found = -1
    for i in range(n):
        if i == limit:
            found = i
            break
    else:
        found = -2
    return found


@declarative
def _nested_for_return(xs):
    for row in xs:
        for v in row:
            if v > 5.0:
                return v
    return torch.tensor(-1.0)


@declarative
def _while_break_traced(x, n):
    i = torch.tensor(0, dtype=torch.int32)
    s = x * 0.0
    while i < n:
        s = s + x
        if torch.sum(s) > 20.0:
            break
        i = i + 1
    return s


def _ar(*shape):
    a = np.arange(float(np.prod(shape)), dtype=np.float32).reshape(shape)
    return torch.from_numpy(a), jnp.asarray(a)


def test_for_range_static_and_jit():
    x, jx = _ar(4)
    same(_for_range(x, 3), J._for_range(jx, 3))


def test_for_traced_range_bound():
    x, jx = _ar(4)
    same(_for_traced_range(x), J._for_traced_range(jx))
    same(_for_traced_range(-x - 1), J._for_traced_range(-jx - 1))


def test_for_tensor_iteration():
    xs, jxs = _ar(3, 4)
    same(_for_tensor(xs), J._for_tensor(jxs))


def test_for_enumerate():
    xs, jxs = _ar(3, 4)
    same(_for_enumerate(xs), J._for_enumerate(jxs))


def test_while_break():
    x, jx = _ar(4)
    same(_while_break(x), J._while_break(jx))


def test_for_continue():
    assert _for_continue(7) == J._for_continue(7) == 9


def test_return_inside_while():
    x, jx = _ar(4)
    same(_return_in_while(x), J._return_in_while(jx))
    same(_return_in_while(x - 10), J._return_in_while(jx - 10))


def test_for_else_with_break():
    for n, limit in ((5, 2), (5, 9)):
        assert _for_else_break(n, limit) == J._for_else_break(n, limit)


def test_nested_for_with_return():
    xs, jxs = _ar(3, 4)
    same(_nested_for_return(xs), J._nested_for_return(jxs))
    same(_nested_for_return(xs * 0.0), J._nested_for_return(jxs * 0.0))


def test_while_break_on_traced_condition():
    x, jx = _ar(4)
    same(_while_break_traced(x, 50), J._while_break_traced(jx, 50))
    same(_while_break_traced(x, torch.tensor(2)),
         J._while_break_traced(jx, jnp.int32(2)))


def test_for_empty_concrete_sequence_leaves_target_unbound():
    @declarative
    def f(xs):
        out = 0.0
        for v in xs:
            out = out + v
        return out

    assert f([]) == 0.0
    assert f([1.0, 2.0]) == 3.0

    @declarative
    def g(xs):
        for v in xs:
            pass
        return v

    with pytest.raises(NameError, match="untaken branch"):
        g([]) + 1


def test_for_python_list_of_callables_unrolls():
    layers = [lambda x: x + 1.0, lambda x: x * 2.0]

    @declarative
    def f(x):
        for fn in layers:
            x = fn(x)
        return x

    x, jx = _ar(3)
    same(f(x), (jx + 1.0) * 2.0)


@declarative
def _loop_cond_assign_with_return(x):
    i = 0
    while i < 5:
        if torch.sum(x) > 100.0:
            found = x
        if torch.sum(x) > 1000.0:
            return found
        i = i + 1
    return x


def test_traced_loop_conditional_assignment_still_raises():
    x, jx = _ar(4)
    same(_loop_cond_assign_with_return(x), J._loop_cond_assign_with_return(jx))
    big, jbig = x * 100 + 100, jx * 100 + 100
    same(_loop_cond_assign_with_return(big),
         J._loop_cond_assign_with_return(jbig))


def test_the_transform_is_cached_and_keeps_the_function():
    assert _branchy._converted is dg.convert_to_static(_branchy._original)
    assert _branchy.__name__ == "_branchy"
