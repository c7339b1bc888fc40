"""Tensor-creation layers: the port's copies of the functions of
``paddle_tpu/layers/tensor.py`` that the training path calls."""

from __future__ import annotations

import numpy as np

from ..core.framework import (Variable, convert_dtype, default_main_program,
                              default_startup_program, unique_name)
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

__all__ = ["create_global_var", "assign", "fill_constant", "sums", "concat",
           "zeros", "ones"]


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
