"""Tensor-creation layers: the port's copies of the functions of
``paddle_tpu/layers/tensor.py``."""

from __future__ import annotations

import numpy as np

from ..core.framework import (Variable, convert_dtype, default_main_program,
                              default_startup_program, unique_name)
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

__all__ = ["create_tensor", "create_global_var", "create_parameter",
           "assign", "fill_constant", "fill_constant_batch_size_like", "sums",
           "concat", "zeros", "ones", "zeros_like", "ones_like", "range",
           "linspace", "uniform_random", "gaussian_random"]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.main_block.create_var(
        name=name or helper.name, dtype=dtype, persistable=persistable
    )


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False, default_initializer=None):
    helper = LayerHelper("create_parameter", param_attr=attr, name=name)
    pa = helper.param_attr
    if name is not None and pa.name is None:
        pa.name = name
    return helper.create_parameter(pa, shape, dtype, is_bias, default_initializer)


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    name = name or unique_name.generate("global_var")
    var = default_main_program().global_block().create_var(
        name=name, shape=shape, dtype=dtype, persistable=persistable, stop_gradient=True
    )
    sgb = default_startup_program().global_block()
    sv = sgb.create_var(name=name, shape=shape, dtype=dtype, persistable=persistable)
    ConstantInitializer(value)(sv, sgb)
    default_startup_program()._bump()
    return var


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=input.dtype, shape=input.shape
            )
        helper.append_op(
            type="assign", inputs={"X": [input]}, outputs={"Out": [output]}
        )
    else:
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=str(arr.dtype), shape=arr.shape
            )
        helper.append_op(
            type="assign_value",
            outputs={"Out": [output]},
            attrs={
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "values": arr.reshape(-1).tolist(),
            },
        )
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    dtype = convert_dtype(dtype)
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=dtype, shape=tuple(shape), stop_gradient=True
        )
    helper.append_op(
        type="fill_constant",
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value)},
    )
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    xs = list(input)
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=xs[0].dtype, shape=xs[0].shape
        )
    helper.append_op(type="sum", inputs={"X": xs}, outputs={"Out": [out]})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    xs = list(input)
    shp = list(xs[0].shape or ())
    if shp:
        tot = 0
        for v in xs:
            d = (v.shape or [None] * len(shp))[axis]
            if d is None or d < 0:
                tot = -1
                break
            tot += d
        shp[axis] = tot
    out = helper.create_variable_for_type_inference(
        dtype=xs[0].dtype, shape=tuple(shp) if shp else None
    )
    helper.append_op(
        type="concat", inputs={"X": xs}, outputs={"Out": [out]}, attrs={"axis": axis}
    )
    return out


def zeros(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def fill_constant_batch_size_like(
    input, shape, dtype, value, input_dim_idx=0, output_dim_idx=0
):
    """A constant of ``shape`` whose ``output_dim_idx`` takes input's
    ``input_dim_idx`` at run time (the batch)."""
    helper = LayerHelper("fill_constant_batch_size_like")
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(
        dtype=dtype, shape=tuple(shape), stop_gradient=True
    )
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={
            "shape": list(shape),
            "dtype": dtype,
            "value": float(value),
            "input_dim_idx": input_dim_idx,
            "output_dim_idx": output_dim_idx,
        },
    )
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=x.dtype, shape=x.shape, stop_gradient=True
        )
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def ones_like(x, out=None):
    from .nn import scale

    return scale(zeros_like(x), scale=1.0, bias=1.0)


def range(start, end, step, dtype="float32"):
    """Python-scalar bounds, folded into an ``assign_value`` as the
    reference does (the output's length depends on them)."""
    return assign(np.arange(start, end, step).astype(convert_dtype(dtype)))


def linspace(start, stop, num, dtype="float32"):
    return assign(np.linspace(start, stop, int(num)).astype(convert_dtype(dtype)))


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(
        dtype=convert_dtype(dtype), shape=tuple(shape), stop_gradient=True
    )
    helper.append_op(
        type="uniform_random",
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": convert_dtype(dtype), "min": min, "max": max, "seed": seed},
    )
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(
        dtype=convert_dtype(dtype), shape=tuple(shape), stop_gradient=True
    )
    helper.append_op(
        type="gaussian_random",
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": convert_dtype(dtype), "mean": mean, "std": std, "seed": seed},
    )
    return out
