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


class _Pow(torch.autograd.Function):
    """``x ** y`` with ``lax.pow``'s gradients: X's is ``g * (y * x **
    (y - 1))`` everywhere, so at x = 0 with y = 0 it is 0 * inf = NaN,
    where torch's own backward masks a zero exponent to 0; Y's is ``g *
    x ** y * log(x)``, 0 where x = 0 and y >= 0 (JAX replaces a zero x
    by 1 under the log). ``y`` is a tensor (``elementwise_pow``,
    broadcast with x) or a Python float (``pow``). X's gradient takes
    the kernels of torch's unmasked formula and no ``where``."""

    @staticmethod
    def forward(ctx, x, y):
        out = torch.pow(x, y)
        if isinstance(y, torch.Tensor):
            ctx.save_for_backward(x, y, out)
        else:
            ctx.save_for_backward(x)
            ctx.factor = y
        return out

    @staticmethod
    def backward(ctx, g):
        if len(ctx.saved_tensors) == 1:
            (x,) = ctx.saved_tensors
            y = ctx.factor
            return g * (y * x.pow(y - 1)), None
        x, y, out = ctx.saved_tensors
        gx = gy = None
        if ctx.needs_input_grad[0]:
            gx = g * (y * x.pow(y - 1))
        if ctx.needs_input_grad[1]:
            zero = torch.zeros((), dtype=out.dtype, device=out.device)
            gy = g * torch.where((x == 0) & (y >= 0), zero, out * torch.log(x))
        return gx, gy


def _pow_xy(x, y):
    x, y = torch.broadcast_tensors(x, y)
    if not x.is_floating_point():
        return torch.pow(x, y)
    return _Pow.apply(x, y)


# ``x ** y`` (``paddle_tpu/ops/math.py:53``) with ``lax.pow``'s gradients
_register_elementwise("elementwise_pow", _pow_xy)
# ``jnp.mod`` (``paddle_tpu/ops/math.py:54``): the sign of the divisor,
# as ``torch.remainder``
_register_elementwise("elementwise_mod", torch.remainder)
# ``jnp.floor_divide`` (``paddle_tpu/ops/math.py:55``): rounds toward
# minus infinity, as ``torch.floor_divide``
_register_elementwise("elementwise_floordiv", torch.floor_divide)


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


def _reduce_axes(op, x):
    """operators/reduce_ops (``paddle_tpu/ops/math.py:106-127``): the
    axes of ``dim`` (negative counts from the end), or None for every
    axis with ``reduce_all`` or a 0-dim input."""
    if op.attrs.get("reduce_all", False) or x.dim() == 0:
        return None
    dim = op.attrs.get("dim", [0])
    if isinstance(dim, int):
        dim = [dim]
    return tuple(sorted({int(d) % x.dim() for d in dim}))


def _prod(x, dim, keepdim):
    """``torch.prod`` takes one axis: the reduced axes move to the end
    and become one."""
    keep = [i for i in range(x.dim()) if i not in dim]
    y = x.permute(keep + list(dim)).reshape(
        [x.shape[i] for i in keep] + [-1])
    out = torch.prod(y, dim=-1)
    if keepdim:
        out = out.reshape([1 if i in dim else x.shape[i]
                           for i in range(x.dim())])
    return out


# each reduction as (x, axes, keep_dim) -> out. ``amax`` / ``amin``
# split the gradient evenly over ties, as ``jnp.max`` / ``jnp.min``
# do (``torch.max(dim=)`` sends it to one element)
_REDUCTIONS = {
    "reduce_sum": torch.sum,
    "reduce_mean": lambda x, dim, keepdim: torch.mean(
        x if x.is_floating_point() else x.float(), dim, keepdim),
    "reduce_max": torch.amax,
    "reduce_min": torch.amin,
    "reduce_prod": _prod,
    "reduce_all": torch.all,
    "reduce_any": torch.any,
}


def _register_reduce(name, fn):
    @register_op(name, inputs=("X",), outputs=("Out",))
    def _lower(ctx, op, ins, _fn=fn):
        """Over ``dim``, or everything with ``reduce_all``, to a 0-dim
        tensor unless ``keep_dim``."""
        x = ins["X"][0]
        keep = bool(op.attrs.get("keep_dim", False))
        axes = _reduce_axes(op, x)
        if axes is None:
            axes = tuple(range(x.dim()))
        if not axes:
            return {"Out": [x.clone()]}
        return {"Out": [_fn(x, axes, keep)]}


for _name, _fn in _REDUCTIONS.items():
    _register_reduce(_name, _fn)


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
    """``paddle_tpu/ops/math.py:226-240``: the bias is cast to X's dtype
    first, as ``jnp.asarray(bias, x.dtype)``, so an integer X takes a
    fractional bias truncated toward 0 (int64 [-3, 2, 5] * 2.5 + 0.5
    gives [-7.5, 5, 12.5]) and a bfloat16 X its bfloat16 rounding. The
    cast is a host scalar: no launch."""
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
    if b:
        b = torch.tensor(b).to(x.dtype).item()
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
    """``fn(x, attrs)``, as the reference's table
    (``paddle_tpu/ops/math.py:152-220``), defaults included."""
    @register_op(name, inputs=("X",), outputs=("Out",))
    def _lower(ctx, op, ins, _fn=fn):
        return {"Out": [_fn(ins["X"][0], op.attrs)]}


def _bounded(x, lo, hi):
    """``jnp.clip(x, lo, hi)`` as the ``clip`` op composes it: at a
    bound the gradient is 0.5, where ``torch.clamp``, ``F.relu6`` and
    ``F.hardsigmoid`` give 1 or 0."""
    x = _maximum(x, x.new_full((), lo))
    return _minimum(x, x.new_full((), hi))


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold past
    which it returns x (``F.softplus`` has one at 20)."""
    return torch.logaddexp(x, _zero(x))


def _attr(a, name, default):
    return float(a.get(name, default))


for _name, _fn in (
        ("relu", lambda x, a: F.relu(x)),
        ("sigmoid", lambda x, a: torch.sigmoid(x)),
        ("tanh", lambda x, a: torch.tanh(x)),
        ("sqrt", lambda x, a: torch.sqrt(x)),
        ("rsqrt", lambda x, a: torch.rsqrt(x)),
        ("exp", lambda x, a: torch.exp(x)),
        ("log", lambda x, a: torch.log(x)),
        ("square", lambda x, a: torch.square(x)),
        ("abs", lambda x, a: _Abs.apply(x)),
        # floor, ceil and round pass no gradient, as in JAX; round
        # takes half to even in both
        ("floor", lambda x, a: torch.floor(x)),
        ("ceil", lambda x, a: torch.ceil(x)),
        ("round", lambda x, a: torch.round(x)),
        ("reciprocal", lambda x, a: 1.0 / x),
        ("softplus", lambda x, a: _softplus(x)),
        ("softsign", lambda x, a: x / (_Abs.apply(x) + 1)),
        ("relu6", lambda x, a: _bounded(x, 0.0, _attr(a, "threshold", 6.0))),
        # jax.nn.leaky_relu / elu take the x >= 0 (x > 0) branch at 0
        ("leaky_relu", lambda x, a: torch.where(
            x >= 0, x, _attr(a, "alpha", 0.02) * x)),
        ("elu", lambda x, a: torch.where(
            x > 0, x, _attr(a, "alpha", 1.0)
            * torch.expm1(torch.where(x > 0, _zero(x), x)))),
        ("swish", lambda x, a: x * torch.sigmoid(_attr(a, "beta", 1.0) * x)),
        ("hard_sigmoid", lambda x, a: _bounded(
            _attr(a, "slope", 0.2) * x + _attr(a, "offset", 0.5), 0.0, 1.0)),
        # divided by a device tensor: CUDA turns a Python divisor into a
        # product with its reciprocal, one ulp off the CPU's quotient
        ("hard_swish", lambda x, a: x * _bounded(
            x + _attr(a, "offset", 3.0), 0.0, _attr(a, "threshold", 6.0))
            / x.new_full((), _attr(a, "scale", 6.0))),
        ("logsigmoid", lambda x, a: -_softplus(-x)),
        ("sin", lambda x, a: torch.sin(x)),
        ("cos", lambda x, a: torch.cos(x)),
        ("erf", lambda x, a: torch.erf(x)),
        ("stanh", lambda x, a: _attr(a, "scale_b", 1.7159)
            * torch.tanh(_attr(a, "scale_a", 0.67) * x)),
        ("thresholded_relu", lambda x, a: torch.where(
            x > _attr(a, "threshold", 1.0), x, _zero(x))),
        ("hard_shrink", lambda x, a: torch.where(
            _Abs.apply(x) > _attr(a, "threshold", 0.5), x, _zero(x))),
        ("soft_relu", lambda x, a: torch.log1p(torch.exp(_bounded(
            x, -_attr(a, "threshold", 40.0), _attr(a, "threshold", 40.0))))),
):
    _register_unary(_name, _fn)


@register_op("pow", inputs=("X",), outputs=("Out",))
def _pow(ctx, op, ins):
    """``x ** factor`` (``paddle_tpu/ops/math.py:202``) with JAX's
    gradient ``factor * x ** (factor - 1)``, unmasked: NaN at x = 0
    when factor is 0 (``_Pow``)."""
    x = ins["X"][0]
    factor = float(op.attrs.get("factor", 1.0))
    if not x.is_floating_point():
        return {"Out": [x ** factor]}
    return {"Out": [_Pow.apply(x, factor)]}


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


@register_op("log_softmax", inputs=("X",), outputs=("Out",))
def _log_softmax(ctx, op, ins):
    return {"Out": [torch.log_softmax(ins["X"][0],
                                      dim=int(op.attrs.get("axis", -1)))]}


@register_op("matmul_v2", inputs=("X", "Y"), outputs=("Out",))
def _matmul_v2(ctx, op, ins):
    """``paddle_tpu/ops/math.py:77``: ``trans_x`` / ``trans_y``, no
    alpha."""
    x, y = _promote(ins["X"][0], ins["Y"][0])
    if op.attrs.get("trans_x", False):
        x = x.transpose(-1, -2)
    if op.attrs.get("trans_y", False):
        y = y.transpose(-1, -2)
    return {"Out": [torch.matmul(x, y)]}


@register_op("isfinite", inputs=("X",), outputs=("Out",), stop_gradient=True)
def _isfinite(ctx, op, ins):
    """:291 (isfinite_op.cc): one 0-dim bool for the whole tensor."""
    return {"Out": [torch.isfinite(ins["X"][0]).all()]}


@register_op("isfinite_v2", inputs=("X",), outputs=("Out",),
             stop_gradient=True)
def _isfinite_v2(ctx, op, ins):
    """:297: elementwise."""
    return {"Out": [torch.isfinite(ins["X"][0])]}
