"""Neural-network layers: the port's copies of the functions of
``paddle_tpu/layers/nn.py`` (Fluid's python/paddle/fluid/layers/nn.py):
fc, embedding, the image layers (``conv2d``, ``conv2d_transpose``,
``pool2d``, ``adaptive_pool2d``, ``batch_norm``), the activations and
unary math, the elementwise ops (a scalar operand on either side), the
reductions, the shape and indexing layers (``flatten`` ... ``cumsum``)
and the layers of ``paddle_tpu/layers/auto.py`` over the ops the port
lowers (``sign``, ``logical_*``, ``sum``, ``mul``, ...). Each function
emits ops into the default main program and sets output shapes itself,
exactly as the reference does, so both packages build the same program.
"""

from __future__ import annotations

import numpy as np

from ..core.framework import Variable, convert_dtype
from ..initializer import (ConstantInitializer, NormalInitializer,
                           XavierInitializer)
from ..layer_helper import LayerHelper

__all__ = [
    "fc", "embedding", "conv2d", "conv2d_transpose", "pool2d",
    "adaptive_pool2d", "batch_norm", "layer_norm", "dropout", "softmax",
    "matmul",
    # activations and unary math
    "relu", "sigmoid", "tanh", "sqrt", "rsqrt", "exp", "log", "square",
    "abs", "gelu", "leaky_relu", "elu", "relu6", "softplus", "softsign",
    "swish", "hard_sigmoid", "hard_swish", "logsigmoid", "erf", "floor",
    "ceil", "round", "reciprocal", "sin", "cos", "stanh",
    "thresholded_relu", "hard_shrink", "soft_relu", "pow",
    # elementwise, reductions and misc math
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
    "_elementwise_binary", "fill_constant_like", "reduce_sum",
    "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
    "reduce_all", "reduce_any", "mean", "scale", "clip", "clip_by_norm",
    "cast", "one_hot", "topk", "argmax", "argmin", "argsort", "where",
    "sign", "logical_and", "logical_or", "logical_xor", "logical_not",
    "sum", "mul", "merge_selected_rows", "get_tensor_from_selected_rows",
    # shape manipulation and indexing
    "reshape", "transpose", "flatten", "squeeze", "unsqueeze", "split",
    "slice", "strided_slice", "shape", "pad", "gather", "gather_nd",
    "scatter", "expand", "expand_as", "stack", "unstack", "cumsum",
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
    """Reference layers/nn.py embedding (lookup_table op). With
    ``is_sparse`` the table's gradient is a SelectedRows of the looked-up
    rows (``core/selected_rows.py``), else a dense scatter-add."""
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


def _conv_out_size(i, k, p, s, d=1):
    if i is None or i < 0:
        return -1
    ke = d * (k - 1) + 1
    return (i + 2 * p - ke) // s + 1


def conv2d(
    input,
    num_filters,
    filter_size,
    stride=1,
    padding=0,
    dilation=1,
    groups=1,
    param_attr=None,
    bias_attr=None,
    use_cudnn=True,
    act=None,
    name=None,
    data_format="NCHW",
):
    """Reference layers/nn.py conv2d: filter [num_filters, C / groups,
    kh, kw] with He-normal init, an optional bias added on the channel
    axis, then the activation."""
    helper = LayerHelper(
        "conv2d", param_attr=param_attr, bias_attr=bias_attr, act=act, name=name
    )
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"conv2d: data_format must be NCHW/NHWC, "
                         f"got {data_format!r}")
    if data_format == "NCHW":
        n, c, h, w_ = input.shape
    else:
        n, h, w_, c = input.shape
    fs = filter_size if isinstance(filter_size, (list, tuple)) else [filter_size] * 2
    st = stride if isinstance(stride, (list, tuple)) else [stride] * 2
    pd = padding if isinstance(padding, (list, tuple)) else [padding] * 2
    dl = dilation if isinstance(dilation, (list, tuple)) else [dilation] * 2
    filter_shape = [num_filters, c // groups, fs[0], fs[1]]
    std = (2.0 / (fs[0] * fs[1] * c)) ** 0.5
    filt = helper.create_parameter(
        helper.param_attr,
        filter_shape,
        input.dtype,
        default_initializer=NormalInitializer(0.0, std),
    )
    oh = _conv_out_size(h, fs[0], pd[0], st[0], dl[0])
    ow = _conv_out_size(w_, fs[1], pd[1], st[1], dl[1])
    out_shape = ((n, num_filters, oh, ow) if data_format == "NCHW"
                 else (n, oh, ow, num_filters))
    out = _out(helper, input, shape=out_shape)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [filt]},
        outputs={"Output": [out]},
        attrs={
            "strides": list(st),
            "paddings": list(pd),
            "dilations": list(dl),
            "groups": groups,
            "data_format": data_format,
        },
    )
    if helper.bias_attr is not False:
        b = helper.create_parameter(
            helper.bias_attr, [num_filters], input.dtype, is_bias=True
        )
        out2 = _out(helper, out, shape=out.shape)
        helper.append_op(
            type="elementwise_add",
            inputs={"X": [out], "Y": [b]},
            outputs={"Out": [out2]},
            attrs={"axis": 1 if data_format == "NCHW" else 3},
        )
        out = out2
    return helper.append_activation(out)


def conv2d_transpose(
    input,
    num_filters,
    output_size=None,
    filter_size=None,
    padding=0,
    stride=1,
    dilation=1,
    groups=1,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
    data_format="NCHW",
):
    """Reference layers/nn.py conv2d_transpose: filter [C, num_filters /
    groups, kh, kw]; without ``filter_size`` the kernel comes from
    ``output_size``, and an ``output_size`` picks the output within
    [formula, formula + stride - 1]."""
    helper = LayerHelper(
        "conv2d_transpose", param_attr=param_attr, bias_attr=bias_attr, act=act, name=name
    )
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"conv2d_transpose: data_format must be "
                         f"NCHW/NHWC, got {data_format!r}")
    if data_format == "NCHW":
        n, c, h, w_ = input.shape
    else:
        n, h, w_, c = input.shape
    st = stride if isinstance(stride, (list, tuple)) else [stride] * 2
    pd = padding if isinstance(padding, (list, tuple)) else [padding] * 2
    dl = dilation if isinstance(dilation, (list, tuple)) else [dilation] * 2
    os_ = None
    if output_size is not None:
        os_ = (list(output_size) if isinstance(output_size, (list, tuple))
               else [output_size] * 2)
    if filter_size is None:
        # k_eff = out - (in - 1) * stride + 2 * pad
        if os_ is None:
            raise ValueError("conv2d_transpose: provide filter_size or "
                             "output_size")
        if h is None or h < 0 or w_ is None or w_ < 0:
            raise ValueError(
                "conv2d_transpose: deriving filter_size from output_size "
                "needs static input spatial dims")
        fs = [(os_[0] - (h - 1) * st[0] + 2 * pd[0] - 1) // dl[0] + 1,
              (os_[1] - (w_ - 1) * st[1] + 2 * pd[1] - 1) // dl[1] + 1]
        if fs[0] <= 0 or fs[1] <= 0:
            raise ValueError(
                f"conv2d_transpose: output_size {os_} too small for "
                f"input ({h}, {w_}) with stride {st} / padding {pd} "
                f"(derived kernel {fs})")
    else:
        fs = (filter_size if isinstance(filter_size, (list, tuple))
              else [filter_size] * 2)
    filter_shape = [c, num_filters // groups, fs[0], fs[1]]
    filt = helper.create_parameter(helper.param_attr, filter_shape, input.dtype)

    def _o(i, k, p, s, d):
        ke = d * (k - 1) + 1
        return -1 if (i is None or i < 0) else (i - 1) * s - 2 * p + ke

    oh = _o(h, fs[0], pd[0], st[0], dl[0])
    ow = _o(w_, fs[1], pd[1], st[1], dl[1])
    if os_ is not None and filter_size is None:
        # the derived kernel's floor division can leave the formula
        # short of output_size; the op pads up to it
        oh, ow = os_
    elif os_ is not None:
        for i, (o_want, o_have, s_i) in enumerate(
                zip(os_, (oh, ow), st)):
            if o_have >= 0 and not (0 <= o_want - o_have < s_i):
                raise ValueError(
                    f"conv2d_transpose: output_size[{i}]={o_want} not in "
                    f"[{o_have}, {o_have + s_i - 1}]")
        oh, ow = os_
    out_shape = ((n, num_filters, oh, ow) if data_format == "NCHW"
                 else (n, oh, ow, num_filters))
    out = _out(helper, input, shape=out_shape)
    helper.append_op(
        type="conv2d_transpose",
        inputs={"Input": [input], "Filter": [filt]},
        outputs={"Output": [out]},
        attrs={"strides": list(st), "paddings": list(pd),
               "dilations": list(dl), "groups": groups,
               "data_format": data_format,
               **({"output_size": list(os_)} if os_ is not None else {})},
    )
    if helper.bias_attr is not False:
        b = helper.create_parameter(
            helper.bias_attr, [num_filters], input.dtype, is_bias=True
        )
        out2 = _out(helper, out, shape=out.shape)
        helper.append_op(
            type="elementwise_add",
            inputs={"X": [out], "Y": [b]},
            outputs={"Out": [out2]},
            attrs={"axis": 1 if data_format == "NCHW" else 3},
        )
        out = out2
    return helper.append_activation(out)


def pool2d(
    input,
    pool_size=-1,
    pool_type="max",
    pool_stride=1,
    pool_padding=0,
    global_pooling=False,
    use_cudnn=True,
    ceil_mode=False,
    name=None,
    exclusive=True,
    data_format="NCHW",
):
    helper = LayerHelper("pool2d", name=name)
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"pool2d: data_format must be NCHW/NHWC, "
                         f"got {data_format!r}")
    if data_format == "NCHW":
        n, c, h, w_ = input.shape
    else:
        n, h, w_, c = input.shape
    ks = pool_size if isinstance(pool_size, (list, tuple)) else [pool_size] * 2
    st = pool_stride if isinstance(pool_stride, (list, tuple)) else [pool_stride] * 2
    pd = pool_padding if isinstance(pool_padding, (list, tuple)) else [pool_padding] * 2
    if global_pooling:
        out_shape = (n, c, 1, 1) if data_format == "NCHW" else (n, 1, 1, c)
    else:
        oh = _conv_out_size(h, ks[0], pd[0], st[0])
        ow = _conv_out_size(w_, ks[1], pd[1], st[1])
        out_shape = ((n, c, oh, ow) if data_format == "NCHW"
                     else (n, oh, ow, c))
    out = _out(helper, input, shape=out_shape)
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "pooling_type": pool_type,
            "ksize": list(ks),
            "strides": list(st),
            "paddings": list(pd),
            "global_pooling": global_pooling,
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
            "data_format": data_format,
        },
    )
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", name=None):
    """Reference layers/nn.py adaptive_pool2d: ``pool_size`` is the
    output's (NCHW) plane; the op needs the input plane to divide."""
    helper = LayerHelper("adaptive_pool2d", name=name)
    n, c = input.shape[0], input.shape[1]
    ks = pool_size if isinstance(pool_size, (list, tuple)) else [pool_size] * 2
    out = _out(helper, input, shape=(n, c, ks[0], ks[1]))
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": list(ks), "adaptive": True},
    )
    return out


def batch_norm(
    input,
    act=None,
    is_test=False,
    momentum=0.9,
    epsilon=1e-5,
    param_attr=None,
    bias_attr=None,
    data_layout="NCHW",
    name=None,
    moving_mean_name=None,
    moving_variance_name=None,
    do_model_average_for_mean_and_var=False,
    use_global_stats=False,
):
    """Reference layers/nn.py batch_norm: scale and bias parameters,
    running mean and variance as persistables that the op's MeanOut and
    VarianceOut write back in place (same names)."""
    helper = LayerHelper(
        "batch_norm", param_attr=param_attr, bias_attr=bias_attr, act=act, name=name
    )
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        helper.param_attr, [c], input.dtype, default_initializer=ConstantInitializer(1.0)
    )
    bias = helper.create_parameter(helper.bias_attr, [c], input.dtype, is_bias=True)
    from ..core.framework import unique_name

    mean_name = moving_mean_name or unique_name.generate(f"{helper.name}.mean")
    var_name = moving_variance_name or unique_name.generate(f"{helper.name}.var")
    gb = helper.main_program.global_block()
    mean = gb.create_var(
        name=mean_name, shape=[c], dtype=input.dtype, persistable=True, stop_gradient=True
    )
    variance = gb.create_var(
        name=var_name, shape=[c], dtype=input.dtype, persistable=True, stop_gradient=True
    )
    helper.set_variable_initializer(mean, ConstantInitializer(0.0))
    helper.set_variable_initializer(variance, ConstantInitializer(1.0))
    saved_mean = _out(helper, input, shape=(c,), stop_gradient=True)
    saved_var = _out(helper, input, shape=(c,), stop_gradient=True)
    out = _out(helper, input, shape=input.shape)
    helper.append_op(
        type="batch_norm",
        inputs={
            "X": [input],
            "Scale": [scale],
            "Bias": [bias],
            "Mean": [mean],
            "Variance": [variance],
        },
        outputs={
            "Y": [out],
            "MeanOut": [mean],
            "VarianceOut": [variance],
            "SavedMean": [saved_mean],
            "SavedVariance": [saved_var],
        },
        attrs={
            "momentum": momentum,
            "epsilon": epsilon,
            "is_test": is_test,
            "data_layout": data_layout,
            "use_global_stats": use_global_stats,
        },
    )
    return helper.append_activation(out)


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
    """A Python number on the right takes a ``scale`` / ``pow`` shortcut
    where one exists, and otherwise a constant of the other operand's
    shape (``fill_constant_like``, batch-size-like for a dynamic batch),
    as in the reference."""
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
            if op_type == "elementwise_pow":
                return pow(x, factor=c)
        else:
            if op_type == "elementwise_sub":
                return scale(x, scale=-1.0, bias=c)
            if op_type == "elementwise_div":
                y_var = fill_constant_like(x, c)
                return _elementwise_binary(y_var, x, "elementwise_div")
        y = fill_constant_like(x, c)
    if not isinstance(x, Variable):
        x = fill_constant_like(y, float(x))
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
elementwise_max = _make_elementwise("elementwise_max")
elementwise_min = _make_elementwise("elementwise_min")
elementwise_pow = _make_elementwise("elementwise_pow")
elementwise_mod = _make_elementwise("elementwise_mod")
elementwise_floordiv = _make_elementwise("elementwise_floordiv")


def _make_activation(op_type, extra_defaults=None):
    def act_fn(x, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name)
        attrs = dict(extra_defaults or {})
        for k, v in kwargs.items():
            attrs[k] = v
        out = _out(helper, x, shape=x.shape)
        helper.append_op(
            type=op_type, inputs={"X": [x]}, outputs={"Out": [out]}, attrs=attrs
        )
        return out

    act_fn.__name__ = op_type
    return act_fn


relu = _make_activation("relu")
sigmoid = _make_activation("sigmoid")
tanh = _make_activation("tanh")
sqrt = _make_activation("sqrt")
rsqrt = _make_activation("rsqrt")
exp = _make_activation("exp")
log = _make_activation("log")
square = _make_activation("square")
abs = _make_activation("abs")
gelu = _make_activation("gelu")
leaky_relu = _make_activation("leaky_relu", {"alpha": 0.02})
elu = _make_activation("elu", {"alpha": 1.0})
relu6 = _make_activation("relu6", {"threshold": 6.0})
softplus = _make_activation("softplus")
softsign = _make_activation("softsign")
swish = _make_activation("swish", {"beta": 1.0})
hard_sigmoid = _make_activation("hard_sigmoid", {"slope": 0.2, "offset": 0.5})
hard_swish = _make_activation("hard_swish")
logsigmoid = _make_activation("logsigmoid")
erf = _make_activation("erf")
floor = _make_activation("floor")
ceil = _make_activation("ceil")
round = _make_activation("round")
reciprocal = _make_activation("reciprocal")
sin = _make_activation("sin")
cos = _make_activation("cos")
stanh = _make_activation("stanh")
thresholded_relu = _make_activation("thresholded_relu", {"threshold": 1.0})
hard_shrink = _make_activation("hard_shrink", {"threshold": 0.5})
soft_relu = _make_activation("soft_relu", {"threshold": 40.0})


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", name=name)
    out = _out(helper, x, shape=x.shape)
    helper.append_op(type="pow", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"factor": factor})
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = convert_dtype(dtype)
    out = _out(helper, x, shape=x.shape, dtype=dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"out_dtype": dtype, "in_dtype": x.dtype})
    return out


def where(condition, x, y, name=None):
    helper = LayerHelper("where", name=name)
    out = _out(helper, x, shape=x.shape)
    helper.append_op(type="where",
                     inputs={"Condition": [condition], "X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def fill_constant_like(x, value):
    """A constant of x's shape and dtype; batch-size-like when a dim is
    dynamic."""
    from .tensor import fill_constant, fill_constant_batch_size_like

    if x.shape and any(d in (-1, None) for d in x.shape):
        return fill_constant_batch_size_like(x, list(x.shape), x.dtype, value)
    return fill_constant(list(x.shape or ()), x.dtype, value)


def _make_reduce(op_type):
    def red_fn(input, dim=None, keep_dim=False, name=None):
        """Over ``dim`` (an int or a list), or over everything when
        ``dim`` is None."""
        helper = LayerHelper(op_type, name=name)
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
                    shape = tuple(1 if i in dd else s for i, s in enumerate(input.shape))
                else:
                    shape = tuple(s for i, s in enumerate(input.shape) if i not in dd)
            else:
                shape = None
        out = _out(helper, input, shape=shape)
        helper.append_op(
            type=op_type, inputs={"X": [input]}, outputs={"Out": [out]}, attrs=attrs
        )
        return out

    red_fn.__name__ = op_type
    return red_fn


reduce_sum = _make_reduce("reduce_sum")
reduce_mean = _make_reduce("reduce_mean")
reduce_max = _make_reduce("reduce_max")
reduce_min = _make_reduce("reduce_min")
reduce_prod = _make_reduce("reduce_prod")


def _make_bool_reduce(op_type):
    def red_fn(input, dim=None, keep_dim=False, name=None):
        """Reference layers/extras.py: a bool output, no shape; dim None
        reduces every element."""
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(
            dtype="bool", stop_gradient=True)
        attrs = ({"reduce_all": True, "keep_dim": keep_dim} if dim is None
                 else {"dim": list(dim) if isinstance(dim, (list, tuple))
                       else [dim], "keep_dim": keep_dim})
        helper.append_op(type=op_type, inputs={"X": [input]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    red_fn.__name__ = op_type
    return red_fn


reduce_all = _make_bool_reduce("reduce_all")
reduce_any = _make_bool_reduce("reduce_any")


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


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = _out(helper, x, shape=x.shape)
    helper.append_op(
        type="clip", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"min": min, "max": max}
    )
    return out


def clip_by_norm(x, max_norm, name=None):
    """Composite, as the reference: x * min(1, max_norm / ||x||)."""
    norm_sq = reduce_sum(square(x))
    norm = sqrt(norm_sq)
    factor = elementwise_min(
        scale(reciprocal(elementwise_max(norm, fill_constant_like(norm, 1e-12))), scale=float(max_norm)),
        fill_constant_like(norm, 1.0),
    )
    return elementwise_mul(x, factor, axis=-1)


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    shp = tuple(input.shape or ())
    out_shape = shp[:-1] + (k,) if shp else None
    vals = _out(helper, input, shape=out_shape)
    idx = _out(helper, input, shape=out_shape, dtype="int64", stop_gradient=True)
    helper.append_op(
        type="top_k",
        inputs={"X": [input]},
        outputs={"Out": [vals], "Indices": [idx]},
        attrs={"k": k},
    )
    return vals, idx


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


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", name=name)
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    rest = int(np.prod(x.shape[axis:]))
    out = _out(helper, x, shape=(lead if lead > 0 else -1, rest))
    xshape = _out(helper, x, shape=(0,), stop_gradient=True)
    helper.append_op(
        type="flatten2",
        inputs={"X": [x]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"axis": axis},
    )
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    shp = list(input.shape or ())
    for a, s, e in zip(axes, starts, ends):
        if shp and shp[a] and shp[a] > 0:
            lo = max(s if s >= 0 else shp[a] + s, 0)
            hi = min(e if e >= 0 else shp[a] + e, shp[a])
            shp[a] = max(hi - lo, 0)
    out = _out(helper, input, shape=tuple(shp))
    helper.append_op(
        type="slice",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"axes": list(axes), "starts": list(starts), "ends": list(ends)},
    )
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = _out(
        helper, input, shape=(len(input.shape or ()),), dtype="int32", stop_gradient=True
    )
    helper.append_op(type="shape", inputs={"Input": [input]}, outputs={"Out": [out]})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    shp = list(x.shape or ())
    pairs = list(zip(paddings[::2], paddings[1::2]))
    for i, (lo, hi) in enumerate(pairs):
        if shp and shp[i] and shp[i] > 0:
            shp[i] += lo + hi
    out = _out(helper, x, shape=tuple(shp))
    helper.append_op(
        type="pad",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"paddings": list(paddings), "pad_value": pad_value},
    )
    return out


def one_hot(input, depth, allow_out_of_range=False):
    helper = LayerHelper("one_hot")
    shp = tuple(input.shape or ())
    if len(shp) >= 2 and shp[-1] == 1:
        out_shape = shp[:-1] + (depth,)
    else:
        out_shape = shp + (depth,)
    out = _out(helper, input, shape=out_shape, dtype="float32", stop_gradient=True)
    helper.append_op(
        type="one_hot", inputs={"X": [input]}, outputs={"Out": [out]}, attrs={"depth": depth}
    )
    return out


def _arg_reduce(op_type, x, axis, name):
    helper = LayerHelper(op_type, name=name)
    shp = tuple(x.shape or ())
    out_shape = tuple(s for i, s in enumerate(shp) if i != axis % len(shp)) if shp else None
    out = _out(helper, x, shape=out_shape, dtype="int64", stop_gradient=True)
    helper.append_op(
        type=op_type, inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"axis": axis}
    )
    return out


def argmax(x, axis=0, name=None):
    return _arg_reduce("arg_max", x, axis, name)


def argmin(x, axis=0, name=None):
    return _arg_reduce("arg_min", x, axis, name)


def argsort(x, axis=-1, descending=False, name=None):
    helper = LayerHelper("argsort", name=name)
    out = _out(helper, x, shape=x.shape)
    idx = _out(helper, x, shape=x.shape, dtype="int64", stop_gradient=True)
    helper.append_op(
        type="argsort",
        inputs={"X": [x]},
        outputs={"Out": [out], "Indices": [idx]},
        attrs={"axis": axis, "descending": descending},
    )
    return out, idx


def gather(input, index, name=None):
    helper = LayerHelper("gather", name=name)
    shp = (index.shape[0] if index.shape else -1,) + tuple(input.shape[1:] or ())
    out = _out(helper, input, shape=shp)
    helper.append_op(
        type="gather", inputs={"X": [input], "Index": [index]}, outputs={"Out": [out]}
    )
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", name=name)
    k = index.shape[-1] if index.shape else 1
    shp = tuple(index.shape[:-1] or ()) + tuple(input.shape[k:] or ())
    out = _out(helper, input, shape=shp)
    helper.append_op(
        type="gather_nd", inputs={"X": [input], "Index": [index]}, outputs={"Out": [out]}
    )
    return out


def scatter(input, index, updates, overwrite=True, name=None):
    """With ``overwrite`` a repeated index takes its last update (the
    op's definition, the same on every device)."""
    helper = LayerHelper("scatter", name=name)
    out = _out(helper, input, shape=input.shape)
    helper.append_op(
        type="scatter",
        inputs={"X": [input], "Ids": [index], "Updates": [updates]},
        outputs={"Out": [out]},
        attrs={"overwrite": overwrite},
    )
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    shp = tuple(
        (s * t if s and s > 0 else -1) for s, t in zip(x.shape, expand_times)
    ) if x.shape else None
    out = _out(helper, x, shape=shp)
    helper.append_op(
        type="expand",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"expand_times": list(expand_times)},
    )
    return out


def expand_as(x, target_tensor, name=None):
    helper = LayerHelper("expand_as", name=name)
    out = _out(helper, x, shape=target_tensor.shape)
    helper.append_op(
        type="expand_as",
        inputs={"X": [x], "target_tensor": [target_tensor]},
        outputs={"Out": [out]},
    )
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack")
    xs = x if isinstance(x, (list, tuple)) else [x]
    shp = list(xs[0].shape or ())
    shp.insert(axis if axis >= 0 else axis + len(shp) + 1, len(xs))
    out = _out(helper, xs[0], shape=tuple(shp))
    helper.append_op(
        type="stack", inputs={"X": list(xs)}, outputs={"Y": [out]}, attrs={"axis": axis}
    )
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    shp = list(x.shape or ())
    n = num or shp[axis]
    oshp = tuple(s for i, s in enumerate(shp) if i != axis % len(shp))
    outs = [_out(helper, x, shape=oshp) for _ in range(n)]
    helper.append_op(
        type="unstack", inputs={"X": [x]}, outputs={"Y": outs}, attrs={"axis": axis, "num": n}
    )
    return outs


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    helper = LayerHelper("cumsum")
    out = _out(helper, x, shape=x.shape)
    helper.append_op(
        type="cumsum",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"axis": axis, "exclusive": exclusive, "reverse": reverse},
    )
    return out


# -- the table-driven layers of ``paddle_tpu/layers/auto.py`` -----------------


def _emit(op_type, ins, attrs, out_slots, stop_gradient):
    """One op over ``ins`` ({slot: var or list}, None skipped); each
    output's shape and dtype come from running the op's own lowering on
    ``meta`` tensors of the inputs' shapes, a dynamic dim taken as 1, as
    the reference infers them (``layer_helper.infer_op_shapes``). An
    input without a shape leaves the outputs without one."""
    helper = LayerHelper(op_type)
    ins = {s: list(v) if isinstance(v, (list, tuple)) else [v]
           for s, v in ins.items() if v is not None}
    inferred = _infer_shapes(op_type, ins, attrs, out_slots)
    outs = {}
    for slot in out_slots:
        shape, dtype = inferred.get(slot, (None, None))
        outs[slot] = [helper.create_variable_for_type_inference(
            dtype=dtype or "float32", shape=shape,
            stop_gradient=stop_gradient)]
    helper.append_op(type=op_type, inputs=ins, outputs=outs, attrs=attrs)
    ret = [outs[s][0] for s in out_slots]
    return ret[0] if len(ret) == 1 else tuple(ret)


def _infer_shapes(op_type, ins, attrs, out_slots):
    import torch

    from ..core.executor import torch_dtype
    from ..core.registry import LoweringContext, get_op_def

    meta = {}
    for slot, vs in ins.items():
        if any(getattr(v, "shape", None) is None for v in vs):
            return {}
        meta[slot] = [torch.empty(
            tuple(1 if (d is None or int(d) < 0) else int(d) for d in v.shape),
            dtype=torch_dtype(v.dtype or "float32"), device="meta")
            for v in vs]

    class _Op:
        type = op_type
        inputs = {s: [v.name for v in vs] for s, vs in ins.items()}
        outputs = {s: [f"{op_type}_o"] for s in out_slots}

    _Op.attrs = dict(attrs, op_ident=0)
    try:
        res = get_op_def(op_type).lower(LoweringContext("meta"), _Op, meta)
    except (RuntimeError, NotImplementedError, ValueError, TypeError):
        return {}
    return {s: (tuple(res[s][0].shape),
                str(res[s][0].dtype).replace("torch.", ""))
            for s in out_slots if res.get(s)}


def sign(x, name=None):
    return _emit("sign", {"X": x}, {}, ["Out"], False)


def logical_and(x, y, name=None):
    return _emit("logical_and", {"X": x, "Y": y}, {}, ["Out"], True)


def logical_or(x, y, name=None):
    return _emit("logical_or", {"X": x, "Y": y}, {}, ["Out"], True)


def logical_xor(x, y, name=None):
    return _emit("logical_xor", {"X": x, "Y": y}, {}, ["Out"], True)


def logical_not(x, name=None):
    return _emit("logical_not", {"X": x}, {}, ["Out"], True)


def sum(x, name=None):
    return _emit("sum", {"X": x}, {}, ["Out"], False)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    return _emit("mul", {"X": x, "Y": y},
                 {"x_num_col_dims": x_num_col_dims,
                  "y_num_col_dims": y_num_col_dims}, ["Out"], False)


def strided_slice(input, axes=[], starts=[], ends=[], strides=[], name=None):
    return _emit("strided_slice", {"Input": input},
                 {"axes": axes, "starts": starts, "ends": ends,
                  "strides": strides}, ["Out"], False)


def merge_selected_rows(x, name=None):
    return _emit("merge_selected_rows", {"X": x}, {}, ["Out"], True)


def get_tensor_from_selected_rows(x, name=None):
    return _emit("get_tensor_from_selected_rows", {"X": x}, {}, ["Out"], True)
