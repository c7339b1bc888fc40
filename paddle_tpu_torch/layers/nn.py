"""Neural-network layers: the port's copies of the functions of
``paddle_tpu/layers/nn.py`` that the training path calls (Fluid's
python/paddle/fluid/layers/nn.py). Each function emits ops into the
default main program and sets output shapes itself, exactly as the
reference does, so both packages build the same program.
"""

from __future__ import annotations

import numpy as np

from ..core.framework import Variable
from ..initializer import ConstantInitializer, XavierInitializer
from ..layer_helper import LayerHelper

__all__ = [
    "fc",
    "embedding",
    "layer_norm",
    "dropout",
    "softmax",
    "matmul",
    "elementwise_add",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "_elementwise_binary",
    "mean",
    "scale",
    "reshape",
    "transpose",
    "squeeze",
    "unsqueeze",
    "split",
    "reduce_sum",
]


def _out(helper, x, shape=None, dtype=None, stop_gradient=False):
    return helper.create_variable_for_type_inference(
        dtype=dtype or (x.dtype if isinstance(x, Variable) else "float32"),
        shape=shape if shape is not None else (x.shape if isinstance(x, Variable) else None),
        stop_gradient=stop_gradient,
    )


# --------------------------------------------------------------------------
# core layers
# --------------------------------------------------------------------------


def fc(
    input,
    size,
    num_flatten_dims=1,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
):
    """Reference layers/nn.py fc: W [prod(in[nfd:]), size], mul op +
    bias + activation."""
    helper = LayerHelper(
        "fc", param_attr=param_attr, bias_attr=bias_attr, act=act, name=name
    )
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for inp in inputs:
        in_features = int(np.prod(inp.shape[num_flatten_dims:]))
        w = helper.create_parameter(
            helper.param_attr, [in_features, size], inp.dtype
        )
        out_shape = tuple(inp.shape[:num_flatten_dims]) + (size,)
        tmp = _out(helper, inp, shape=out_shape)
        helper.append_op(
            type="mul",
            inputs={"X": [inp], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = _out(helper, mul_results[0], shape=mul_results[0].shape)
        helper.append_op(
            type="sum", inputs={"X": mul_results}, outputs={"Out": [pre_bias]}
        )
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(
    input,
    size,
    is_sparse=False,
    is_distributed=False,
    padding_idx=None,
    param_attr=None,
    dtype="float32",
):
    """Reference layers/nn.py embedding (lookup_table op). is_sparse is
    advisory: the port's gradient is a dense scatter-add."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(
        helper.param_attr, list(size), dtype, default_initializer=XavierInitializer()
    )
    ids_shape = tuple(input.shape) if input.shape else (-1,)
    if len(ids_shape) >= 2 and ids_shape[-1] == 1:
        out_shape = ids_shape[:-1] + (size[1],)
    else:
        out_shape = ids_shape + (size[1],)
    out = _out(helper, input, shape=out_shape, dtype=dtype)
    helper.append_op(
        type="lookup_table",
        inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={
            "padding_idx": -1 if padding_idx is None else int(padding_idx),
            "is_sparse": is_sparse,
            "is_distributed": is_distributed,
        },
    )
    return out


def layer_norm(
    input,
    scale=True,
    shift=True,
    begin_norm_axis=1,
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
):
    helper = LayerHelper(
        "layer_norm", param_attr=param_attr, bias_attr=bias_attr, act=act, name=name
    )
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            helper.param_attr,
            norm_shape,
            input.dtype,
            default_initializer=ConstantInitializer(1.0),
        )
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(
            helper.bias_attr, norm_shape, input.dtype, is_bias=True
        )
        inputs["Bias"] = [b]
    lead = int(np.prod([d for d in input.shape[:begin_norm_axis]])) if all(
        d is not None and d > 0 for d in input.shape[:begin_norm_axis]
    ) else -1
    out = _out(helper, input, shape=input.shape)
    mean = _out(helper, input, shape=(lead,), stop_gradient=True)
    var = _out(helper, input, shape=(lead,), stop_gradient=True)
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
        attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon},
    )
    return helper.append_activation(out)


def dropout(
    x,
    dropout_prob,
    is_test=False,
    seed=None,
    name=None,
    dropout_implementation="downgrade_in_infer",
):
    helper = LayerHelper("dropout", name=name)
    out = _out(helper, x, shape=x.shape)
    mask = _out(helper, x, shape=x.shape, dtype="uint8", stop_gradient=True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "seed": seed or 0,
            "dropout_implementation": dropout_implementation,
        },
    )
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    out = _out(helper, input, shape=input.shape)
    helper.append_op(
        type="softmax", inputs={"X": [input]}, outputs={"Out": [out]}, attrs={"axis": axis}
    )
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    xs = list(x.shape) if x.shape else []
    ys = list(y.shape) if y.shape else []
    shape = None
    if len(xs) >= 2 and len(ys) >= 2:
        m = xs[-1] if transpose_x else xs[-2]
        n = ys[-2] if transpose_y else ys[-1]
        lead = xs[:-2] if len(xs) >= len(ys) else ys[:-2]
        shape = tuple(lead) + (m, n)
    out = _out(helper, x, shape=shape)
    helper.append_op(
        type="matmul",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y, "alpha": alpha},
    )
    return out


# --------------------------------------------------------------------------
# elementwise / misc math
# --------------------------------------------------------------------------


def _make_elementwise(op_type):
    def ew_fn(x, y, axis=-1, act=None, name=None):
        return _elementwise_binary(x, y, op_type, axis=axis, act=act, name=name)

    ew_fn.__name__ = op_type
    return ew_fn


def _elementwise_binary(x, y, op_type, axis=-1, act=None, name=None, reverse=False):
    helper = LayerHelper(op_type, act=act, name=name)
    # scalar operands -> scale-op shortcuts (keeps graphs small)
    if not isinstance(y, Variable):
        c = float(y)
        if not reverse:
            if op_type == "elementwise_add":
                return scale(x, scale=1.0, bias=c)
            if op_type == "elementwise_sub":
                return scale(x, scale=1.0, bias=-c)
            if op_type == "elementwise_mul":
                return scale(x, scale=c)
            if op_type == "elementwise_div":
                return scale(x, scale=1.0 / c)
        elif op_type == "elementwise_sub":
            return scale(x, scale=-1.0, bias=c)
        raise NotImplementedError(
            f"{op_type} with a scalar {'left' if reverse else 'right'} "
            "operand needs fill_constant_batch_size_like, not ported yet")
    xs, ys = x.shape, y.shape
    shape = xs if (xs and ys and len(xs) >= len(ys)) else ys
    out = _out(helper, x, shape=shape)
    helper.append_op(
        type=op_type,
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"axis": axis},
    )
    return helper.append_activation(out)


elementwise_add = _make_elementwise("elementwise_add")
elementwise_sub = _make_elementwise("elementwise_sub")
elementwise_mul = _make_elementwise("elementwise_mul")
elementwise_div = _make_elementwise("elementwise_div")


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    """Reference layers/nn.py reduce_sum: over ``dim`` (an int or a
    list), or over everything when ``dim`` is None."""
    helper = LayerHelper("reduce_sum", name=name)
    if dim is None:
        attrs = {"reduce_all": True, "keep_dim": keep_dim}
        shape = ()
    else:
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        attrs = {"dim": list(dims), "keep_dim": keep_dim, "reduce_all": False}
        if input.shape:
            nd = len(input.shape)
            dd = {d % nd for d in dims}
            if keep_dim:
                shape = tuple(1 if i in dd else s
                              for i, s in enumerate(input.shape))
            else:
                shape = tuple(s for i, s in enumerate(input.shape)
                              if i not in dd)
        else:
            shape = None
    out = _out(helper, input, shape=shape)
    helper.append_op(
        type="reduce_sum", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs=attrs
    )
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = _out(helper, x, shape=())
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = _out(helper, x, shape=x.shape)
    helper.append_op(
        type="scale",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"scale": float(scale), "bias": float(bias), "bias_after_scale": bias_after_scale},
    )
    return helper.append_activation(out)


# --------------------------------------------------------------------------
# shape manipulation
# --------------------------------------------------------------------------


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    coerced = []
    for s in shape:
        try:
            coerced.append(int(s))
        except (TypeError, ValueError):
            raise NotImplementedError(
                "reshape: Variable entries in `shape` are unsupported in "
                "the static-shape build; pass python ints (got "
                f"{type(s).__name__})")
    shape = coerced
    helper = LayerHelper("reshape2", act=act, name=name)
    new_shape = []
    for i, s in enumerate(shape):
        if s == 0:
            new_shape.append(x.shape[i] if x.shape else -1)
        else:
            new_shape.append(s)
    out = _out(helper, x, shape=tuple(new_shape))
    xshape = _out(helper, x, shape=(0,), stop_gradient=True)
    helper.append_op(
        type="reshape2",
        inputs={"X": [x]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"shape": list(shape)},
    )
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    shp = tuple(x.shape[p] for p in perm) if x.shape else None
    out = _out(helper, x, shape=shp)
    xshape = _out(helper, x, shape=(0,), stop_gradient=True)
    helper.append_op(
        type="transpose2",
        inputs={"X": [x]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"axis": list(perm)},
    )
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", name=name)
    shp = list(input.shape or ())
    for a in sorted([a % len(shp) for a in axes], reverse=True):
        shp.pop(a)
    out = _out(helper, input, shape=tuple(shp))
    xshape = _out(helper, input, shape=(0,), stop_gradient=True)
    helper.append_op(
        type="squeeze2",
        inputs={"X": [input]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"axes": list(axes)},
    )
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    shp = list(input.shape or ())
    for a in sorted(axes):
        shp.insert(a if a >= 0 else a + len(shp) + 1, 1)
    out = _out(helper, input, shape=tuple(shp))
    xshape = _out(helper, input, shape=(0,), stop_gradient=True)
    helper.append_op(
        type="unsqueeze2",
        inputs={"X": [input]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"axes": list(axes)},
    )
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    shp = list(input.shape or ())
    d = dim % len(shp) if shp else dim
    if isinstance(num_or_sections, int):
        n = num_or_sections
        sections = []
        sizes = [shp[d] // n] * n if shp and shp[d] > 0 else [-1] * n
    else:
        sections = list(num_or_sections)
        n = len(sections)
        sizes = sections
    outs = []
    for i in range(n):
        s = list(shp)
        if s:
            s[d] = sizes[i]
        outs.append(_out(helper, input, shape=tuple(s)))
    helper.append_op(
        type="split",
        inputs={"X": [input]},
        outputs={"Out": outs},
        attrs={"axis": dim, "sections": sections, "num": 0 if sections else n},
    )
    return outs
