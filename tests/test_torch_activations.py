"""The unary ops, the reductions and ``elementwise_floordiv`` of the port
against the JAX package, on the CPU; and the repairs of ``pow`` /
``elementwise_pow`` (0^0) and ``scale`` (an integer X).

Each case builds the same one-op Program in both packages (``run_op``):
the inputs fed as data vars, the op appended as it is, and a loss that
sums every float output times a fed random weight of its shape, so each
output element carries its own cotangent; ``append_backward`` of that
loss gives X@GRAD. Forward outputs and gradients are held within rtol
1e-5 / atol 1e-6 (float32 elementwise math, transcendental functions
from two libraries); integer and bool outputs exactly. The tie and bound
cases (a clip-built activation at its bounds, ``leaky_relu`` / ``elu``
at 0, ``reduce_max`` over equal values) are held exactly.

``layers.fc(act=a)`` is trained one Adam step for every activation the
port lowers, from the JAX startup's parameters: the loss and every
persistable within rtol 2e-4 / atol 2e-5, as the other training parity
tests.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.core.framework import unique_name as jax_unique_name

import paddle_tpu_torch as fluid
from paddle_tpu_torch.io import load_scope_arrays

RTOL, ATOL = 1e-5, 1e-6
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5


def _names(pkg):
    return jax_unique_name if pkg is jfluid else fluid.unique_name


def _program(pkg, op_type, inputs, attrs, outs, grads, out_arrays=None):
    """The one-op Program: (main, startup, fetch names, feed names of the
    output weights)."""
    main, startup = pkg.Program(), pkg.Program()
    block = main.global_block()
    fetch, weights = [], []
    with pkg.program_guard(main, startup), _names(pkg).guard():
        ins = {}
        for slot, vals in inputs.items():
            arrs = vals if isinstance(vals, list) else [vals]
            ins[slot] = []
            for k, a in enumerate(arrs):
                a = np.asarray(a)
                ins[slot].append(pkg.layers.data(
                    f"{slot}_{k}", list(a.shape), append_batch_size=False,
                    dtype=str(a.dtype), stop_gradient=slot not in grads))
        out_vars = {s: [block.create_var(name=f"o_{s}_{k}")
                        for k in range(n)] for s, n in outs.items()}
        block.append_op(type=op_type, inputs=ins, outputs=out_vars,
                        attrs=dict(attrs))
        fetch = [v.name for s in outs for v in out_vars[s]]
        if out_arrays is not None and grads:
            terms = []
            for n in fetch:
                a = out_arrays[n]
                if a.dtype.kind != "f":
                    continue
                w = pkg.layers.data(f"w_{n}", list(a.shape),
                                    append_batch_size=False)
                weights.append(w.name)
                v = block.var(n)
                v.shape, v.dtype = tuple(a.shape), "float32"
                terms.append(pkg.layers.reduce_sum(
                    pkg.layers.elementwise_mul(v, w)))
            loss = terms[0] if len(terms) == 1 else pkg.layers.sums(terms)
            pkg.append_backward(loss)
            fetch += [f"{v.name}@GRAD" for s in grads for v in ins[s]]
    return main, startup, fetch, weights


def _feeds(inputs):
    return {f"{slot}_{k}": np.asarray(a) for slot, vals in inputs.items()
            for k, a in enumerate(vals if isinstance(vals, list) else [vals])}


def _exe(pkg):
    return pkg.Executor(pkg.CPUPlace())


def run_op(pkg, op_type, inputs, attrs=None, outs=None, grads=(), seed=0,
           out_arrays=None):
    """{fetch name: array} of one op in ``pkg``: every output and, for
    the ``grads`` input slots, their gradients of the weighted sum of
    the float outputs. ``out_arrays`` (the outputs of a forward-only
    run) size the weights; without it a forward-only run is made
    first."""
    attrs, outs = attrs or {}, outs or {"Out": 1}
    if out_arrays is None:
        main, _, fetch, _ = _program(pkg, op_type, inputs, attrs, outs, ())
        vals = _exe(pkg).run(main, feed=_feeds(inputs), fetch_list=fetch,
                             scope=pkg.Scope())
        out_arrays = {n: np.asarray(v) for n, v in zip(fetch, vals)}
        if not grads:
            return out_arrays
    main, startup, fetch, weights = _program(pkg, op_type, inputs, attrs,
                                             outs, grads, out_arrays)
    rng = np.random.RandomState(seed)
    feed = _feeds(inputs)
    for w in weights:
        feed[w] = np.asarray(rng.randn(*out_arrays[w[2:]].shape),
                             np.float32)
    vals = _exe(pkg).run(main, feed=feed, fetch_list=fetch,
                         scope=pkg.Scope())
    return {n: np.asarray(v) for n, v in zip(fetch, vals)}


def both(op_type, inputs, attrs=None, outs=None, grads=(), seed=0):
    """(JAX's results, the port's) of one op, the port's weights sized by
    JAX's forward outputs."""
    j = run_op(jfluid, op_type, inputs, attrs, outs, grads, seed)
    jf = {n: v for n, v in j.items() if not n.endswith("@GRAD")}
    t = run_op(fluid, op_type, inputs, attrs, outs, grads, seed,
               out_arrays=jf if grads else None)
    return j, t


def check(j, t, rtol=RTOL, atol=ATOL, exact=False):
    assert sorted(j) == sorted(t)
    for n in j:
        a, b = np.asarray(j[n]), np.asarray(t[n])
        assert a.shape == b.shape, (n, a.shape, b.shape)
        if a.dtype.kind in "biu" or b.dtype.kind in "biu":
            # JAX runs without x64: its int64 arrives as int32
            assert a.dtype.kind == b.dtype.kind, (n, a.dtype, b.dtype)
            np.testing.assert_array_equal(b, a, err_msg=n)
        elif exact:
            np.testing.assert_array_equal(b, a, err_msg=n)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                       err_msg=n)


def _f(*shape, seed=0, lo=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    return (np.abs(x) + lo).astype(np.float32) if lo is not None else x


# -- the 19 unary ops and the activations fc takes ----------------------------

UNARY = {
    "tanh": {}, "rsqrt": {"lo": 0.5}, "log": {"lo": 0.5}, "round": {},
    "softplus": {}, "softsign": {}, "relu6": {}, "leaky_relu": {},
    "elu": {}, "swish": {}, "hard_sigmoid": {}, "hard_swish": {},
    "logsigmoid": {}, "sin": {}, "erf": {}, "stanh": {},
    "thresholded_relu": {}, "hard_shrink": {}, "soft_relu": {},
    "relu": {}, "sigmoid": {}, "gelu": {}, "sqrt": {"lo": 0.5},
    "exp": {}, "abs": {}, "square": {}, "reciprocal": {"lo": 0.5},
    "floor": {}, "ceil": {}, "cos": {},
}

# the attrs of the sweep rows (``tests/test_op_sweep.py:37-60``) and
# other values than the defaults
ATTRS = {
    "elu": [{"alpha": 1.0}, {"alpha": 0.5}],
    "leaky_relu": [{}, {"alpha": 0.1}],
    "hard_shrink": [{"threshold": 0.5}],
    "hard_sigmoid": [{"slope": 0.2, "offset": 0.5}, {"slope": 0.3,
                                                     "offset": 0.4}],
    "stanh": [{"scale_a": 0.67, "scale_b": 1.7159}, {}],
    "swish": [{"beta": 1.0}, {"beta": 2.0}],
    "thresholded_relu": [{"threshold": 1.0}, {"threshold": 0.3}],
    "relu6": [{}, {"threshold": 2.0}],
    "hard_swish": [{}, {"offset": 2.0, "threshold": 5.0, "scale": 4.0}],
    "soft_relu": [{}, {"threshold": 1.0}],
    "gelu": [{}, {"approximate": True}],
}

CASES = [(op, i) for op in sorted(UNARY)
         for i in range(len(ATTRS.get(op, [{}])))]


@pytest.mark.parametrize("op,i", CASES)
def test_unary_op_matches_jax(op, i):
    x = _f(4, 7, seed=len(op), **UNARY[op]) * (3.0 if op in (
        "relu6", "hard_sigmoid", "hard_swish", "soft_relu") else 1.0)
    j, t = both(op, {"X": x}, ATTRS.get(op, [{}])[i], grads=["X"])
    check(j, t)


BOUNDS = {
    # clip-built: X@GRAD 0.5 where x sits on a bound, as jnp.clip's
    "relu6": (np.array([[-1.0, 0.0, 3.0, 6.0, 7.0]]), {}),
    "relu6_thr": (np.array([[-1.0, 0.0, 1.0, 2.0, 3.0]]),
                  {"threshold": 2.0}),
    # a slope that puts the clip points on exact floats: XLA:CPU fuses
    # 0.2 * x + 0.5 into an fma, so at x = -2.5 JAX lands 7e-9 below 0
    "hard_sigmoid": (np.array([[-3.0, -2.0, 0.0, 2.0, 3.0]]),
                     {"slope": 0.25, "offset": 0.5}),
    "hard_swish": (np.array([[-4.0, -3.0, 0.0, 3.0, 4.0]]), {}),
    "soft_relu": (np.array([[-41.0, -40.0, 0.0, 40.0, 41.0]]), {}),
    # the x >= 0 (x > 0) branch at 0
    "leaky_relu": (np.array([[-1.0, -0.0, 0.0, 1.0]]), {}),
    "elu": (np.array([[-1.0, -0.0, 0.0, 1.0]]), {"alpha": 0.5}),
    "thresholded_relu": (np.array([[0.5, 1.0, 1.5]]), {}),
    "hard_shrink": (np.array([[-0.5, 0.0, 0.5, 0.7]]), {}),
    "abs": (np.array([[-1.0, -0.0, 0.0, 1.0]]), {}),
    "softsign": (np.array([[-1.0, 0.0, 1.0]]), {}),
    # round half to even in both
    "round": (np.array([[-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5]]), {}),
}


@pytest.mark.parametrize("case", sorted(BOUNDS))
def test_activation_bounds_and_ties_match_jax_exactly(case):
    x, attrs = BOUNDS[case]
    op = case.split("_thr")[0]
    j, t = both(op, {"X": x.astype(np.float32)}, attrs, grads=["X"])
    if op in ("relu6", "hard_sigmoid", "hard_swish", "soft_relu"):
        # unit cotangents would show 0.5 directly; weighted, compare bits
        assert np.any(j["X_0@GRAD"] != 0)
    check(j, t, exact=op not in ("soft_relu", "hard_swish", "elu",
                                 "softsign"))
    if op not in ("round",):
        check(j, t)


def test_relu6_gradient_is_half_at_its_bounds():
    """Unit cotangents: d(sum relu6)/dx is 0.5 at 0 and at 6 in both;
    ``F.relu6`` would give 0."""
    x = np.array([0.0, 6.0, 3.0, -1.0, 7.0], np.float32)

    def grad(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), _names(pkg).guard():
            v = pkg.layers.data("x", [5], append_batch_size=False,
                                stop_gradient=False)
            loss = pkg.layers.reduce_sum(pkg.layers.relu6(v))
            pkg.append_backward(loss)
        return np.asarray(_exe(pkg).run(main, feed={"x": x},
                                        fetch_list=["x@GRAD"],
                                        scope=pkg.Scope())[0])

    np.testing.assert_array_equal(grad(fluid), grad(jfluid))
    np.testing.assert_array_equal(grad(fluid), [0.5, 0.5, 1.0, 0.0, 0.0])


# -- reductions ----------------------------------------------------------------

REDUCE = [
    ("reduce_mean", {"dim": [1]}), ("reduce_mean", {"reduce_all": True}),
    ("reduce_mean", {"dim": [0, 2], "keep_dim": True}),
    ("reduce_max", {"dim": [1]}), ("reduce_max", {"dim": [-1]}),
    ("reduce_max", {"reduce_all": True, "keep_dim": True}),
    ("reduce_min", {"dim": [1]}), ("reduce_min", {"dim": [0, 2]}),
    ("reduce_prod", {"dim": [1]}), ("reduce_prod", {"dim": [0, 2]}),
    ("reduce_prod", {"reduce_all": True}),
    ("reduce_sum", {"dim": [2], "keep_dim": True}),
]


@pytest.mark.parametrize("op,attrs", REDUCE,
                         ids=[f"{o}-{i}" for i, (o, _) in enumerate(REDUCE)])
def test_reduce_matches_jax(op, attrs):
    x = _f(3, 4, 5, seed=3)
    if op == "reduce_prod":
        x = (0.5 + np.abs(x)).astype(np.float32)
    j, t = both(op, {"X": x}, attrs, grads=["X"])
    check(j, t)


@pytest.mark.parametrize("op", ["reduce_max", "reduce_min"])
def test_reduce_max_min_split_ties_as_jax(op):
    """Equal extremes share the gradient evenly (``jnp.max``, and
    ``torch.amax``; ``torch.max(dim=)`` would send it to one)."""
    x = np.array([[1.0, -1.0, 1.0, 0.5], [2.0, 2.0, 2.0, 2.0],
                  [-3.0, 0.0, -3.0, 5.0]], np.float32)
    for attrs in ({"dim": [1]}, {"reduce_all": True}):
        j, t = both(op, {"X": x}, attrs, grads=["X"])
        check(j, t, exact=True)


def test_reduce_max_of_abs_splits_the_gradient():
    """max(|x|) over [1, -1, 0.5]: [0.5, -0.5, 0] in both, the path the
    fake-quantize scale takes."""
    x = np.array([[1.0, -1.0, 0.5]], np.float32)

    def grad(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), _names(pkg).guard():
            v = pkg.layers.data("x", [1, 3], append_batch_size=False,
                                stop_gradient=False)
            loss = pkg.layers.reduce_max(pkg.layers.abs(v))
            pkg.append_backward(loss)
        return np.asarray(_exe(pkg).run(main, feed={"x": x},
                                        fetch_list=["x@GRAD"],
                                        scope=pkg.Scope())[0])

    np.testing.assert_array_equal(grad(fluid), grad(jfluid))
    np.testing.assert_array_equal(grad(fluid), [[0.5, -0.5, 0.0]])


@pytest.mark.parametrize("op", ["reduce_all", "reduce_any"])
@pytest.mark.parametrize("attrs", [{"dim": [1]}, {"reduce_all": True},
                                   {"dim": [0], "keep_dim": True}])
def test_bool_reduce_matches_jax(op, attrs):
    x = np.random.RandomState(2).rand(3, 4) > 0.4
    x[1] = True
    check(*both(op, {"X": x}, attrs))


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32"])
def test_elementwise_floordiv_matches_jax(dtype):
    rng = np.random.RandomState(5)
    x = rng.randint(-20, 20, (3, 5)).astype(dtype)
    y = rng.randint(1, 6, (3, 5)).astype(dtype) * np.where(
        rng.rand(3, 5) > 0.5, 1, -1).astype(dtype)
    check(*both("elementwise_floordiv", {"X": x, "Y": y}))


# -- C1: pow / elementwise_pow at 0^0 -------------------------------------------


def test_pow_gradient_at_zero_to_the_zero_is_jax_nan():
    """JAX's X@GRAD of x ** factor is factor * x ** (factor - 1),
    unmasked: NaN at x = 0 when factor is 0, where torch's own
    backward gives 0; elsewhere both agree."""
    x = np.array([[0.0, 0.0, 2.0, -1.0, 0.5]], np.float32)
    for factor in (0.0, 1.0, 2.0, 0.5):
        j, t = both("pow", {"X": x}, {"factor": factor}, grads=["X"])
        check(j, t)
    j, t = both("pow", {"X": x}, {"factor": 0.0}, grads=["X"])
    assert np.isnan(t["X_0@GRAD"][0, :2]).all()
    assert np.isnan(j["X_0@GRAD"][0, :2]).all()


def test_elementwise_pow_gradients_at_zero_match_jax():
    x = np.array([[0.0, 0.0, 2.0, -1.0, 0.0, 3.0]], np.float32)
    y = np.array([[0.0, 1.0, 0.0, 0.0, 2.0, 0.5]], np.float32)
    j, t = both("elementwise_pow", {"X": x, "Y": y}, grads=["X", "Y"])
    check(j, t)
    assert np.isnan(t["X_0@GRAD"][0, 0]) and np.isnan(j["X_0@GRAD"][0, 0])
    assert t["Y_0@GRAD"][0, 0] == 0 and j["Y_0@GRAD"][0, 0] == 0
    # broadcast Y (a row against a matrix): the reduction of Y's gradient
    xs = (np.abs(_f(3, 4, seed=7)) + 0.2).astype(np.float32)
    check(*both("elementwise_pow", {"X": xs, "Y": _f(4, seed=8)},
                grads=["X", "Y"]))


def test_pow_docstring_states_the_gradient():
    from paddle_tpu_torch.ops import math as tmath

    doc = tmath._pow.__doc__
    assert "factor * x ** (factor - 1)" in doc and "NaN" in doc


# -- C2: scale of an integer X -----------------------------------------------------


@pytest.mark.parametrize("after", [True, False])
def test_scale_of_an_integer_tensor_casts_the_bias(after):
    x = np.array([-3, 2, 5], np.int64)
    attrs = {"scale": 2.5, "bias": 0.5, "bias_after_scale": after}
    j, t = both("scale", {"X": x}, attrs)
    np.testing.assert_array_equal(t["o_Out_0"], j["o_Out_0"])
    if after:
        np.testing.assert_array_equal(t["o_Out_0"], [-7.5, 5.0, 12.5])


def test_scale_of_a_bfloat16_tensor_rounds_the_bias_first():
    import torch

    from paddle_tpu_torch.core.registry import LoweringContext, get_op_def

    class Op:
        attrs = {"scale": 1.0, "bias": 1.0 + 2 ** -10}

    x = torch.zeros(2, dtype=torch.bfloat16)
    out = get_op_def("scale").lower(LoweringContext("cpu"), Op, {"X": [x]})
    assert out["Out"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["Out"][0].float().numpy(), [1.0, 1.0])


# -- fc(act=a) trains for every activation --------------------------------------

FC_ACTS = ["tanh", "rsqrt", "log", "round", "softplus", "softsign", "relu6",
           "leaky_relu", "elu", "swish", "hard_sigmoid", "hard_swish",
           "logsigmoid", "sin", "erf", "stanh", "thresholded_relu",
           "hard_shrink", "soft_relu", "gelu", "sigmoid", "relu", "softmax"]


def _persistables(program):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and not v.is_data)


def _fc_program(pkg, act):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), _names(pkg).guard():
        x = pkg.layers.data("x", [6])
        y = pkg.layers.data("y", [1], dtype="int64")
        # a positive pre-activation for log and rsqrt
        bias = (pkg.ParamAttr(initializer=pkg.initializer.ConstantInitializer(
            4.0)) if act in ("log", "rsqrt") else None)
        h = pkg.layers.fc(x, 8, act=act, bias_attr=bias)
        logits = pkg.layers.fc(h, 3)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        pkg.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


@pytest.fixture
def unfused():
    saved = (jfluid.get_flags("optimizer_fuse")["optimizer_fuse"],
             fluid.get_flags("optimizer_fuse")["optimizer_fuse"])
    jfluid.set_flags({"optimizer_fuse": "off"})
    fluid.set_flags({"optimizer_fuse": "off"})
    yield
    jfluid.set_flags({"optimizer_fuse": saved[0]})
    fluid.set_flags({"optimizer_fuse": saved[1]})


@pytest.mark.parametrize("act", FC_ACTS)
def test_fc_with_activation_trains_as_jax(act, unfused):
    rng = np.random.RandomState(1)
    feed = {"x": (rng.rand(5, 6) * 0.5).astype(np.float32),
            "y": rng.randint(0, 3, (5, 1)).astype(np.int64)}
    jmain, jstart, jloss = _fc_program(jfluid, act)
    tmain, _, tloss = _fc_program(fluid, act)
    assert tmain.to_dict() == jmain.to_dict()
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(jmain)}
        jl = [float(np.asarray(exe.run(jmain, feed=feed,
                                       fetch_list=[jloss])[0]))
              for _ in range(2)]
        jstate = {n: np.asarray(scope.find_var(n)) for n in init}
    tscope = fluid.Scope()
    load_scope_arrays(tscope, init, tmain, "cpu")
    texe = fluid.Executor(fluid.CPUPlace())
    tl = [float(texe.run(tmain, feed=feed, fetch_list=[tloss],
                         scope=tscope)[0]) for _ in range(2)]
    assert np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    for n, v in jstate.items():
        np.testing.assert_allclose(tscope.get_numpy(n), v, rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, err_msg=n)
