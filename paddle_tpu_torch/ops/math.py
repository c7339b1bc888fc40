"""Math ops: elementwise (with Fluid's ``axis`` broadcast), the matmul
family, reductions and activations — torch lowerings with the semantics
of ``paddle_tpu/ops/math.py``. Large matrix products are
``torch.matmul``: the reference leaves them to XLA, outside any Pallas
kernel."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.executor import torch_dtype
from ..core.registry import register_op
from ..core.selected_rows import SelectedRows


def _broadcast_y(x, y, axis):
    """Reference elementwise_op_function.h: Y is broadcast against X
    with Y's dims aligned starting at ``axis``; -1 aligns trailing."""
    if axis is None or axis == -1 or x.dim() == y.dim():
        return y
    # trim trailing size-1 dims of y (reference does the same)
    yshape = list(y.shape)
    while yshape and yshape[-1] == 1:
        yshape.pop()
    pad_after = x.dim() - axis - len(yshape)
    if pad_after < 0:
        return y
    return y.reshape([1] * axis + yshape + [1] * pad_after)


def _promote(x, y):
    """Both operands in their common float dtype, as ``jnp`` promotes
    them: under AMP a bfloat16 matmul output meets a float32 bias or
    activation, and the result is float32. Torch would refuse a mixed
    matmul, and would keep bfloat16 against a 0-dim float32 tensor."""
    if (x.dtype != y.dtype and x.is_floating_point()
            and y.is_floating_point()):
        dt = torch.promote_types(x.dtype, y.dtype)
        return x.to(dt), y.to(dt)
    return x, y


def _register_elementwise(name, fn, stop_gradient=False):
    @register_op(name, inputs=("X", "Y"), outputs=("Out",),
                 stop_gradient=stop_gradient)
    def _lower(ctx, op, ins, _fn=fn):
        x, y = _promote(ins["X"][0], ins["Y"][0])
        y = _broadcast_y(x, y, int(op.attrs.get("axis", -1)))
        return {"Out": [_fn(x, y)]}


_register_elementwise("elementwise_add", lambda x, y: x + y)
_register_elementwise("elementwise_sub", lambda x, y: x - y)
_register_elementwise("elementwise_mul", lambda x, y: x * y)
_register_elementwise("elementwise_div", lambda x, y: x / y)
class _Extremum(torch.autograd.Function):
    """``torch.maximum`` / ``torch.minimum`` with ``lax.max`` /
    ``lax.min``'s gradient: each operand takes ``g * (operand == out) /
    (1 + (other == out))``, so a tie splits g in halves and a NaN (where
    out is NaN and neither operand equals it) sends 0 to both; torch's
    own backward passes g to both at a NaN. Eight kernels for both
    gradients where torch's formula takes ten."""

    @staticmethod
    def forward(ctx, x, y, fn):
        out = fn(x, y)
        ctx.save_for_backward(x, y, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, out = ctx.saved_tensors
        ex, ey = x == out, y == out
        gx = gy = None
        if ctx.needs_input_grad[0]:
            gx = g * ex / (1 + ey)
        if ctx.needs_input_grad[1]:
            gy = g * ey / (1 + ex)
        return gx, gy, None


def _maximum(x, y):
    x, y = torch.broadcast_tensors(x, y)
    return _Extremum.apply(x, y, torch.maximum)


def _minimum(x, y):
    x, y = torch.broadcast_tensors(x, y)
    return _Extremum.apply(x, y, torch.minimum)


_register_elementwise("elementwise_min", _minimum)
_register_elementwise("elementwise_max", _maximum)
# ``x ** y`` (``paddle_tpu/ops/math.py:53``), both gradients through
# autograd as JAX's vjp of ``lax.pow``
_register_elementwise("elementwise_pow", torch.pow)
# ``jnp.mod`` (``paddle_tpu/ops/math.py:54``): the sign of the divisor,
# as ``torch.remainder``
_register_elementwise("elementwise_mod", torch.remainder)


@register_op("matmul", inputs=("X", "Y"), outputs=("Out",))
def _matmul(ctx, op, ins):
    x, y = _promote(ins["X"][0], ins["Y"][0])
    if op.attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if op.attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = float(op.attrs.get("alpha", 1.0))
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register_op("mul", inputs=("X", "Y"), outputs=("Out",))
def _mul(ctx, op, ins):
    # reference mul_op.cc: flatten X to 2-D at x_num_col_dims, Y at
    # y_num_col_dims, matmul, then restore X's leading dims
    x, y = _promote(ins["X"][0], ins["Y"][0])
    xnc = int(op.attrs.get("x_num_col_dims", 1))
    ync = int(op.attrs.get("y_num_col_dims", 1))
    lead = tuple(x.shape[:xnc])
    x2 = x.reshape(int(np.prod(lead or (1,))), -1)
    y2 = y.reshape(int(np.prod(y.shape[:ync])), -1)
    return {"Out": [(x2 @ y2).reshape(lead + (y2.shape[1],))]}


@register_op("reduce_sum", inputs=("X",), outputs=("Out",))
def _reduce_sum(ctx, op, ins):
    """operators/reduce_ops (``paddle_tpu/ops/math.py:107-121``): over
    ``dim`` (negative counts from the end), or everything with
    ``reduce_all``, to a 0-dim tensor unless ``keep_dim``."""
    x = ins["X"][0]
    keep = bool(op.attrs.get("keep_dim", False))
    if op.attrs.get("reduce_all", False) or x.dim() == 0:
        out = torch.sum(x)
        if keep:
            out = out.reshape([1] * x.dim())
        return {"Out": [out]}
    dim = op.attrs.get("dim", [0])
    if isinstance(dim, int):
        dim = [dim]
    axes = tuple(sorted({int(d) % x.dim() for d in dim}))
    return {"Out": [torch.sum(x, dim=axes, keepdim=keep)]}


@register_op("cast", inputs=("X",), outputs=("Out",), no_grad=())
def _cast(ctx, op, ins):
    """``paddle_tpu/ops/math.py:249-254``; the automatic gradient casts
    the cotangent back to the input's dtype."""
    dt = torch_dtype(op.attrs.get("out_dtype", "float32"))
    return {"Out": [ins["X"][0].to(dt)]}


@register_op("mean", inputs=("X",), outputs=("Out",))
def _mean(ctx, op, ins):
    return {"Out": [torch.mean(ins["X"][0])]}


@register_op("sum", inputs=("X",), outputs=("Out",))
def _sum(ctx, op, ins):
    """Variadic add (gradient accumulation, Fluid's sum_op.cc;
    ``paddle_tpu/ops/math.py:138-148``): all-SelectedRows inputs
    concatenate their rows, a mix of sparse and dense densifies the
    sparse ones."""
    xs = ins["X"]
    if all(isinstance(x, SelectedRows) for x in xs):
        out = xs[0]
        for x in xs[1:]:
            out = out.concat(x)
        return {"Out": [out]}
    xs = [x.to_dense() if isinstance(x, SelectedRows) else x for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register_op("scale", inputs=("X",), outputs=("Out",))
def _scale(ctx, op, ins):
    x = ins["X"][0]
    s = float(op.attrs.get("scale", 1.0))
    b = float(op.attrs.get("bias", 0.0))
    if isinstance(x, SelectedRows):
        # a sparse gradient scales its slices (Fluid's scale_op.h
        # SelectedRows kernel, ``paddle_tpu/ops/math.py:226-234``); a
        # bias is undefined there
        if b:
            raise ValueError("scale with a bias is undefined for "
                             "SelectedRows")
        return {"Out": [x * s]}
    if op.attrs.get("bias_after_scale", True):
        out = x * s
        if b:
            out = out + b
    else:
        out = (x + b) * s if b else x * s
    return {"Out": [out]}


@register_op("gelu", inputs=("X",), outputs=("Out",))
def _gelu(ctx, op, ins):
    approximate = "tanh" if op.attrs.get("approximate", False) else "none"
    return {"Out": [F.gelu(ins["X"][0], approximate=approximate)]}


# -- activations and unary math (``paddle_tpu/ops/math.py:159-173``) ----------


class _Abs(torch.autograd.Function):
    """|x| with ``jnp.abs``'s gradient: ``sign`` taken as ``x >= 0``, so
    d|x|/dx is 1 at 0 and at -0.0 (``torch.abs`` gives 0 there); the
    value is torch.abs's, +0.0 for -0.0 as in JAX."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _register_unary(name, fn):
    @register_op(name, inputs=("X",), outputs=("Out",))
    def _lower(ctx, op, ins, _fn=fn):
        return {"Out": [_fn(ins["X"][0])]}


_register_unary("relu", F.relu)
_register_unary("sigmoid", torch.sigmoid)
_register_unary("sqrt", torch.sqrt)
_register_unary("square", torch.square)
_register_unary("abs", lambda x: _Abs.apply(x))
_register_unary("reciprocal", lambda x: 1.0 / x)
# the learning-rate schedules' unary ops (``paddle_tpu/ops/math.py``
# :171, :175-176, :200); floor and ceil pass no gradient, as in JAX
_register_unary("exp", torch.exp)
_register_unary("floor", torch.floor)
_register_unary("ceil", torch.ceil)
_register_unary("cos", torch.cos)


@register_op("pow", inputs=("X",), outputs=("Out",))
def _pow(ctx, op, ins):
    """``x ** factor`` (``paddle_tpu/ops/math.py:202``); the gradient
    ``factor * x ** (factor - 1)``."""
    return {"Out": [ins["X"][0] ** float(op.attrs.get("factor", 1.0))]}


# comparisons and logical ops (``paddle_tpu/ops/math.py:277-298``): no
# gradient
for _name, _fn in (("equal", torch.eq), ("not_equal", torch.ne),
                   ("less_than", torch.lt), ("less_equal", torch.le),
                   ("greater_than", torch.gt), ("greater_equal", torch.ge),
                   ("logical_and", torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_xor", torch.logical_xor)):
    _register_elementwise(_name, _fn, stop_gradient=True)


@register_op("logical_not", inputs=("X",), outputs=("Out",),
             stop_gradient=True)
def _logical_not(ctx, op, ins):
    return {"Out": [torch.logical_not(ins["X"][0])]}


@register_op("clip", inputs=("X",), outputs=("Out",))
def _clip(ctx, op, ins):
    """``paddle_tpu/ops/math.py:243``: jnp.clip(x, min, max), composed
    as jnp.clip is, ``minimum(maximum(x, min), max)``: where x equals a
    bound, maximum / minimum split the gradient in halves (X@GRAD 0.5),
    where ``torch.clamp`` would pass all of it, and a NaN x takes 0."""
    out = ins["X"][0]
    lo, hi = op.attrs.get("min"), op.attrs.get("max")
    if lo is not None:
        out = _maximum(out, out.new_full((), lo))
    if hi is not None:
        out = _minimum(out, out.new_full((), hi))
    return {"Out": [out]}
