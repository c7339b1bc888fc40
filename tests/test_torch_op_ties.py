"""Ops at ties and bounds, the port against the JAX package, on the CPU.

Random inputs almost never tie or land on a bound, so the parity tests
of the other files cannot see what these cases hold:

(a) ``top_k`` gives equal values ``jax.lax.top_k``'s order, the lower
    index first (NaN above every number), and sends Out's gradient to
    the same columns; ``accuracy`` with k >= 2 counts the same hits over
    tied scores;
(b) ``clip``'s gradient is 0.5 where x equals min or max, as
    ``jnp.clip``'s;
(c) ``abs``'s gradient is 1 at 0 and at -0.0, as ``jnp.abs``'s, and
    |-0.0| is +0.0.

Each case builds the same one-op Program in both packages, feeds the
same numpy arrays and runs it through each package's Executor with
``append_backward`` of ``mean(Out * W)`` (W a fed random weight, so
every output element carries its own cotangent). Indices are compared
exactly, Out and X@GRAD within 1e-6 (``abs`` exactly, sign bit
included).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.core.framework import unique_name as jax_unique_name

import paddle_tpu_torch as fluid

TOL = 1e-6


def _names(pkg):
    return jax_unique_name if pkg is jfluid else fluid.unique_name


def _run(pkg, build, feeds):
    """One program of ``build(pkg, x)`` -> {name: fetched array}: Out,
    X@GRAD and whatever ``build`` returns beside Out."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), _names(pkg).guard():
        x = pkg.layers.data("x", list(feeds["x"].shape),
                            append_batch_size=False, stop_gradient=False)
        out, extra = build(pkg, x)
        w = pkg.layers.data("w", list(feeds["w"].shape),
                            append_batch_size=False)
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(out, w))
        pkg.append_backward(loss)
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup)
    names = ["out", "x_grad"] + sorted(extra)
    fetch = [out, "x@GRAD"] + [extra[n] for n in sorted(extra)]
    vals = exe.run(main, feed=feeds, fetch_list=fetch)
    return {n: np.asarray(v) for n, v in zip(names, vals)}


def _both(build, x, w_shape=None, seed=0):
    rng = np.random.RandomState(seed)
    out_shape = w_shape or x.shape
    feeds = {"x": x.astype(np.float32),
             "w": rng.randn(*out_shape).astype(np.float32)}
    return _run(jfluid, build, feeds), _run(fluid, build, feeds)


def _topk(k):
    def build(pkg, x):
        vals, idx = pkg.layers.topk(x, k)
        return vals, {"idx": idx}
    return build


TOPK_ROWS = {
    # every entry equal
    "all_equal": (np.zeros((3, 4)), 2),
    # ties at the k-th place, and ties inside the k largest
    "kth_place": (np.array([[3., 1., 2., 2., 0., 2.],
                            [5., 5., 1., 5., 0., 4.],
                            [-1., -1., -1., 7., 7., -1.]]), 3),
    # NaN ranks above every number in both, several NaNs in index order
    "nan": (np.array([[1., np.nan, 3., np.nan, 2.],
                      [np.nan, 2., 2., 1., -np.inf],
                      [0., 0., np.inf, np.nan, 0.]]), 3),
    # random values rounded to a few levels: many ties of each
    "levels": (np.round(np.random.RandomState(3).rand(16, 10) * 3), 4),
}


@pytest.mark.parametrize("case", sorted(TOPK_ROWS))
def test_top_k_ties_match_jax(case):
    x, k = TOPK_ROWS[case]
    j, t = _both(_topk(k), x, w_shape=x.shape[:-1] + (k,))
    np.testing.assert_array_equal(t["idx"], j["idx"].astype(np.int64))
    np.testing.assert_allclose(t["out"], j["out"], rtol=0, atol=TOL)
    np.testing.assert_allclose(t["x_grad"], j["x_grad"], rtol=0, atol=TOL)


def test_top_k_all_equal_row_picks_the_first_columns():
    j, t = _both(_topk(2), np.zeros((1, 4)), w_shape=(1, 2))
    np.testing.assert_array_equal(t["idx"], [[0, 1]])
    np.testing.assert_array_equal(j["idx"], [[0, 1]])
    assert np.all(t["x_grad"][:, 2:] == 0) and np.all(t["x_grad"][:, :2] != 0)


def _accuracy_program(pkg, scores, labels, k):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), _names(pkg).guard():
        x = pkg.layers.data("x", list(scores.shape), append_batch_size=False)
        y = pkg.layers.data("y", list(labels.shape), append_batch_size=False,
                            dtype="int64")
        acc = pkg.layers.accuracy(x, y, k=k)
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup)
    return float(np.asarray(exe.run(main, feed={"x": scores, "y": labels},
                                    fetch_list=[acc])[0]).reshape(-1)[0])


@pytest.mark.parametrize("k", [2, 3])
def test_accuracy_over_tied_scores_matches_jax(k):
    # rows of equal scores: the hit depends on which tied columns the
    # top k keep; labels sit at the first, middle and last columns
    scores = np.zeros((6, 5), np.float32)
    scores[3:] = [[1, 1, 1, 0, 0], [0, 2, 2, 2, 2], [1, 1, 1, 1, 1]]
    labels = np.array([[0], [2], [4], [2], [4], [3]], np.int64)
    want = _accuracy_program(jfluid, scores, labels, k)
    got = _accuracy_program(fluid, scores, labels, k)
    assert got == want


def _clip(lo, hi):
    def build(pkg, x):
        return pkg.layers.clip(x, lo, hi), {}
    return build


def test_clip_gradient_at_its_bounds_matches_jax():
    x = np.array([[-1., 0., 0.5, 1., 2.]])
    # unit cotangents: X@GRAD is d(sum clip)/dx times 1/numel
    j = _run(jfluid, _clip(0.0, 1.0), {"x": x.astype(np.float32),
                                       "w": np.ones_like(x, np.float32)})
    t = _run(fluid, _clip(0.0, 1.0), {"x": x.astype(np.float32),
                                      "w": np.ones_like(x, np.float32)})
    np.testing.assert_allclose(j["x_grad"] * x.size, [[0, .5, 1, .5, 0]],
                               atol=TOL)
    np.testing.assert_allclose(t["x_grad"], j["x_grad"], rtol=0, atol=TOL)
    np.testing.assert_allclose(t["out"], j["out"], rtol=0, atol=TOL)


def test_clip_random_tensor_with_bound_hits_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(8, 12)
    lo, hi = -0.5, 0.75
    hits = rng.rand(*x.shape)
    x[hits < 0.15] = lo
    x[hits > 0.85] = hi
    assert (x == lo).sum() > 5 and (x == hi).sum() > 5
    j, t = _both(_clip(lo, hi), x)
    np.testing.assert_allclose(t["out"], j["out"], rtol=0, atol=TOL)
    np.testing.assert_allclose(t["x_grad"], j["x_grad"], rtol=0, atol=TOL)


def _abs(pkg, x):
    return pkg.layers.abs(x), {}


def test_abs_gradient_at_zero_and_negative_zero_matches_jax():
    x = np.array([[-1.5, -0.0, 0.0, 2.0, 0.0, -0.0, -3.0]])
    j, t = _both(_abs, x)
    np.testing.assert_array_equal(t["out"], j["out"])
    np.testing.assert_array_equal(np.signbit(t["out"]), np.signbit(j["out"]))
    np.testing.assert_array_equal(t["x_grad"], j["x_grad"])
    # d|x|/dx = 1 at both zeros
    w = np.random.RandomState(0).randn(*x.shape).astype(np.float32)
    np.testing.assert_array_equal(np.sign(t["x_grad"][x == 0]),
                                  np.sign(w[x == 0]))
