"""Ops at the inputs where the port used to part from the JAX package:
sections with a -1, four-sided paddings, and NaN, +-inf and 0.

(a) ``split`` resolves one -1, the last section, to the rest of the
    axis (``[2, -1]`` and ``[1, 2, -1]`` over 6 columns): Out and X@GRAD
    equal JAX's. A -1 elsewhere, or sections that do not sum to the
    axis, raise ``ValueError``. JAX splits at ``np.cumsum(sections)[:-1]``
    (``paddle_tpu/ops/tensor.py:120-122``): over 6 columns ``[1, 2]``
    gives 1 and 5 there (Fluid refuses it), and ``[-1, 2]`` asks
    ``jnp.split`` for sizes -1 and 7, which it refuses (Fluid: 4 and 2).
    The port copies neither: it refuses both.
(b) ``conv2d`` with four paddings ``[top, bottom, left, right]`` pads H
    and W unevenly, as ``paddle_tpu/ops/nn.py:43-46`` does: Output and
    the Input / Filter gradients equal JAX's at ``test_torch_resnet``'s
    tolerances, NCHW and NHWC, stride 1 and 2.
(c) gradients at NaN, +-inf and 0: ``clip`` and ``elementwise_max`` /
    ``elementwise_min`` give JAX's (0 to both operands at a NaN, halves
    at a tie, the whole gradient to the larger operand otherwise);
    ``relu`` and max ``pool2d`` agree at +-inf and 0. At a NaN x their
    gradients differ from JAX's and stay so: the repair would cost the
    card an extra launch a call (ROADMAP, known non-faults).

Each case builds the same Program in both packages, feeds the same
numpy arrays and runs it through each package's Executor with
``append_backward`` of ``sum_i mean(Out_i * W_i)`` (W_i fed random
weights, so every output element carries its own cotangent). Out and
the gradients are compared within 1e-6 unless named (NaN in the same
places).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.core.framework import unique_name as jax_unique_name

import paddle_tpu_torch as fluid

TOL = 1e-6
CONV_RTOL, CONV_ATOL = 1e-4, 1e-5     # tests/test_torch_resnet.py RTOL / ATOL


def _names(pkg):
    return jax_unique_name if pkg is jfluid else fluid.unique_name


def _run(pkg, build, inputs, out_shapes, seed=0):
    """One program of ``build(pkg, *inputs) -> [Out_i]``; returns the
    outputs and the gradient of every input, as numpy arrays."""
    rng = np.random.RandomState(seed)
    feeds = {n: v.astype(np.float32) for n, v in inputs.items()}
    for i, shape in enumerate(out_shapes):
        feeds[f"w{i}"] = rng.randn(*shape).astype(np.float32)
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), _names(pkg).guard():
        xs = [pkg.layers.data(n, list(v.shape), append_batch_size=False,
                              stop_gradient=False) for n, v in inputs.items()]
        outs = build(pkg, *xs)
        terms = []
        for i, (out, shape) in enumerate(zip(outs, out_shapes)):
            w = pkg.layers.data(f"w{i}", list(shape), append_batch_size=False)
            terms.append(pkg.layers.mean(pkg.layers.elementwise_mul(out, w)))
        loss = terms[0]
        for t in terms[1:]:
            loss = pkg.layers.elementwise_add(loss, t)
        pkg.append_backward(loss)
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup)
    fetch = list(outs) + [f"{n}@GRAD" for n in inputs]
    vals = [np.asarray(v) for v in exe.run(main, feed=feeds,
                                           fetch_list=fetch)]
    return vals[:len(outs)], vals[len(outs):]


def _both(build, inputs, out_shapes):
    return (_run(jfluid, build, inputs, out_shapes),
            _run(fluid, build, inputs, out_shapes))


def _assert_same(t, j, rtol=0.0, atol=TOL):
    for tv, jv in zip(t, j):
        assert tv.shape == jv.shape
        np.testing.assert_allclose(tv, jv, rtol=rtol, atol=atol)


# -- (a) split ---------------------------------------------------------------

def _split(sections):
    def build(pkg, x):
        return pkg.layers.split(x, sections, dim=1)
    return build


@pytest.mark.parametrize("sections,sizes", [([2, -1], [2, 4]),
                                            ([1, 2, -1], [1, 2, 3])])
def test_split_resolves_a_last_minus_one(sections, sizes):
    x = np.random.RandomState(1).randn(3, 6)
    shapes = [(3, s) for s in sizes]
    (jout, jgrad), (tout, tgrad) = _both(_split(sections), {"x": x}, shapes)
    assert [o.shape for o in tout] == shapes
    _assert_same(tout, jout)
    _assert_same(tgrad, jgrad)
    np.testing.assert_array_equal(np.concatenate(tout, axis=1),
                                  x.astype(np.float32))


@pytest.mark.parametrize("sections,jax_sizes", [([1, 2], [1, 5]),
                                                ([4, 1], [4, 2]),
                                                ([-1, 2], None),
                                                ([2, -1, 1], None)])
def test_split_refuses_what_jax_resolves_by_cumsum(sections, jax_sizes):
    """JAX's sizes come from its cumsum, not from the sections: sections
    short of the axis give the last piece the rest (``[1, 2]`` -> 1, 5),
    and a -1 that is not last becomes a negative size that ``jnp.split``
    refuses (``[-1, 2]`` -> [-1, 7]). No caller asked for the first, so
    the port raises for both."""
    x = np.random.RandomState(2).randn(3, 6)
    shapes = [(3, s) for s in (jax_sizes or [1] * len(sections))]
    if jax_sizes is None:
        with pytest.raises(ValueError):
            _run(jfluid, _split(sections), {"x": x}, shapes)
    else:
        jout, _ = _run(jfluid, _split(sections), {"x": x}, shapes)
        assert [o.shape[1] for o in jout] == jax_sizes
    with pytest.raises(ValueError, match="split: sections"):
        _run(fluid, _split(sections), {"x": x}, shapes)


# -- (b) conv2d with four paddings ------------------------------------------------

def _conv_out(n, k, lo, hi, s):
    return (n + lo + hi - k) // s + 1


def _conv_run(pkg, x, pads, stride, fmt, shape, filt=None):
    """Output, X@GRAD and the filter's gradient of one conv2d; JAX's
    startup draws the filter, the port takes JAX's (``filt``)."""
    w = np.random.RandomState(4).randn(*shape).astype(np.float32)
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), _names(pkg).guard():
        xv = pkg.layers.data("x", list(x.shape), append_batch_size=False,
                             stop_gradient=False)
        out = pkg.layers.conv2d(xv, 4, 3, stride=stride, padding=pads,
                                bias_attr=False, data_format=fmt,
                                param_attr=pkg.ParamAttr(name="conv.w"))
        wv = pkg.layers.data("w", list(shape), append_batch_size=False)
        pkg.append_backward(pkg.layers.mean(pkg.layers.elementwise_mul(out,
                                                                       wv)))
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(scope):
        exe.run(startup)
        if filt is not None:
            import torch
            scope.set_var("conv.w", torch.tensor(filt))
        vals = exe.run(main, feed={"x": x.astype(np.float32), "w": w},
                       fetch_list=[out, "x@GRAD", "conv.w@GRAD"])
        filt = np.asarray(scope.find_var("conv.w"))
    return [np.asarray(v) for v in vals], filt


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("pads", [[1, 0, 2, 1], [0, 2, 1, 1]])
def test_conv2d_four_paddings_match_jax(fmt, stride, pads):
    rng = np.random.RandomState(3)
    H, W = 9, 8
    x = rng.randn(2, 3, H, W) if fmt == "NCHW" else rng.randn(2, H, W, 3)
    oh = _conv_out(H, 3, pads[0], pads[1], stride)
    ow = _conv_out(W, 3, pads[2], pads[3], stride)
    shape = (2, 4, oh, ow) if fmt == "NCHW" else (2, oh, ow, 4)
    jvals, jw = _conv_run(jfluid, x, pads, stride, fmt, shape)
    tvals, _ = _conv_run(fluid, x, pads, stride, fmt, shape, filt=jw)
    for what, t, j in zip(("Output", "Input@GRAD", "Filter@GRAD"), tvals,
                          jvals):
        assert t.shape == j.shape, what
        np.testing.assert_allclose(t, j, rtol=CONV_RTOL, atol=CONV_ATOL,
                                   err_msg=what)
    assert tvals[0].shape == shape


# -- (c) NaN, +-inf and 0 ---------------------------------------------------------

EDGES = np.array([[np.nan, 0., -0., np.inf, -np.inf, 1., -1., 2.],
                  [-2., 1., np.nan, 0.5, -0.5, np.inf, 3., 0.]])


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (0.0, 0.0), (-0.5, 2.0)])
def test_clip_gradient_at_nan_inf_and_bounds_matches_jax(lo, hi):
    def build(pkg, x):
        return [pkg.layers.clip(x, lo, hi)]

    (jout, jgrad), (tout, tgrad) = _both(build, {"x": EDGES}, [EDGES.shape])
    _assert_same(tout, jout)
    _assert_same(tgrad, jgrad)
    assert tgrad[0][0, 0] == 0 and tgrad[0][1, 2] == 0     # at the NaNs


# y against EDGES: NaN against numbers and NaN, ties (0 against -0.0,
# 1 against 1, inf against inf), and plain numbers
OTHER = np.array([[1., 0., 0., np.inf, 1., 1., np.nan, -3.],
                  [np.nan, 1., np.nan, -0.5, -0.5, 2., 3., -np.inf]])


@pytest.mark.parametrize("op", ["elementwise_max", "elementwise_min"])
def test_elementwise_max_min_gradients_at_nan_and_ties_match_jax(op):
    def build(pkg, x, y):
        return [getattr(pkg.layers, op)(x, y)]

    (jout, jgrad), (tout, tgrad) = _both(build, {"x": EDGES, "y": OTHER},
                                         [EDGES.shape])
    _assert_same(tout, jout)
    _assert_same(tgrad, jgrad)
    nan = np.isnan(EDGES) | np.isnan(OTHER)
    assert np.all(tgrad[0][nan] == 0) and np.all(tgrad[1][nan] == 0)


def test_elementwise_max_broadcast_gradient_matches_jax():
    """Y broadcast along X's axis 1: its gradient sums over the rest."""
    x = np.random.RandomState(5).randn(2, 3, 4)
    x[0, 1, 2] = np.nan
    y = np.array([0.5, np.nan, -0.25])

    def build(pkg, xv, yv):
        return [pkg.layers.elementwise_max(xv, yv, axis=1)]

    (jout, jgrad), (tout, tgrad) = _both(build, {"x": x, "y": y}, [x.shape])
    _assert_same(tout, jout)
    _assert_same(tgrad, jgrad)


FINITE_EDGES = np.where(np.isnan(EDGES), 7.0, EDGES)


def test_relu_gradient_at_inf_and_zero_matches_jax():
    def build(pkg, x):
        return [pkg.layers.relu(x)]

    (jout, jgrad), (tout, tgrad) = _both(build, {"x": FINITE_EDGES},
                                         [EDGES.shape])
    _assert_same(tout, jout)
    _assert_same(tgrad, jgrad)


def test_max_pool_gradient_at_inf_and_ties_matches_jax():
    """Windows holding +inf, -inf, ties of equal numbers and all -inf:
    the gradient goes to the window's first largest entry in both."""
    x = np.arange(32, dtype=np.float64).reshape(1, 2, 4, 4) % 5
    x[0, 0, 0, 0] = np.inf
    x[0, 0, 2:, 2:] = -np.inf
    x[0, 1, 1, 1] = -np.inf
    x[0, 1, 0, 2:] = 9.0

    def build(pkg, xv):
        return [pkg.layers.pool2d(xv, 2, "max", 2)]

    (jout, jgrad), (tout, tgrad) = _both(build, {"x": x}, [(1, 2, 2, 2)])
    _assert_same(tout, jout)
    _assert_same(tgrad, jgrad)
