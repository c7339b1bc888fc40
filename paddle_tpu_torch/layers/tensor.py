"""Tensor-creation layers: the port's copies of the functions of
``paddle_tpu/layers/tensor.py`` that the training path calls."""

from __future__ import annotations

import numpy as np

from ..core.framework import (Variable, default_main_program,
                              default_startup_program, unique_name)
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

__all__ = ["create_global_var", "assign"]


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
