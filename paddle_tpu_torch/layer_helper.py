"""LayerHelper — shared plumbing for layer functions.

The port's copy of ``paddle_tpu/layer_helper.py`` (Fluid's
python/paddle/fluid/layer_helper.py): creates parameters in both the
startup program (with init ops) and the main program, creates temp
output vars, and appends bias and activation ops. The layers the port
has set their output shapes themselves, so the reference's
``infer_op_shapes`` (abstract evaluation of a lowering) is not needed.
"""

from __future__ import annotations

from typing import Optional

from .core.framework import Parameter, Variable, default_main_program, default_startup_program, unique_name
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def main_block(self):
        return self.main_program.current_block()

    @property
    def param_attr(self) -> ParamAttr:
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        ba = self.kwargs.get("bias_attr")
        if ba is False:
            return False
        return ParamAttr._to_attr(ba)

    def multiple_param_attr(self, length):
        pa = self.param_attr
        if isinstance(pa, ParamAttr):
            pa = [pa] + [ParamAttr(**pa.__dict__.copy()) for _ in range(length - 1)]
        return pa

    def create_parameter(
        self,
        attr: Optional[ParamAttr],
        shape,
        dtype="float32",
        is_bias: bool = False,
        default_initializer=None,
        stop_gradient: bool = False,
    ) -> Parameter:
        attr = ParamAttr._to_attr(attr)
        if attr.name is None:
            attr.name = unique_name.generate(f"{self.name}.w" if not is_bias else f"{self.name}.b")
        init = attr.initializer or default_initializer
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()

        main_gb = self.main_program.global_block()
        from .core.framework import Parameter as _Param

        if isinstance(main_gb.vars.get(attr.name), _Param):
            # weight sharing: return the existing param WITHOUT another
            # startup init op (a second layer's initializer would
            # silently overwrite the first's at startup)
            return main_gb.create_parameter(attr.name, shape, dtype)
        param = main_gb.create_parameter(
            attr.name,
            shape,
            dtype,
            trainable=attr.trainable,
            regularizer=attr.regularizer,
            gradient_clip_attr=attr.gradient_clip,
            optimize_attr={"learning_rate": attr.learning_rate},
            stop_gradient=stop_gradient,
        )
        if getattr(attr, "logical_axes", None):
            if len(attr.logical_axes) != len(shape):
                raise ValueError(
                    f"param {attr.name!r}: logical_axes "
                    f"{attr.logical_axes} has {len(attr.logical_axes)} "
                    f"entries for a rank-{len(shape)} parameter")
            param.logical_axes = tuple(attr.logical_axes)
        # mirror into startup program + init op
        startup_gb = self.startup_program.global_block()
        sp = startup_gb.create_parameter(
            attr.name,
            shape,
            dtype,
            trainable=attr.trainable,
        )
        init(sp, startup_gb)
        self.startup_program._bump()
        self.main_program._bump()
        return param

    def create_variable_for_type_inference(
        self, dtype="float32", stop_gradient=False, shape=None
    ) -> Variable:
        # Unlike the reference (which runs C++ InferShape lazily), layer
        # functions set output shapes eagerly so downstream layers can
        # size their parameters; -1 marks the dynamic batch dim.
        return self.main_block.create_var(
            name=unique_name.generate(f"{self.name}.tmp"),
            dtype=dtype,
            stop_gradient=stop_gradient,
            shape=shape,
        )

    def create_variable(self, *args, **kwargs):
        return self.main_block.create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, **kwargs):
        return self.main_program.global_block().create_var(
            name=unique_name.generate(f"{self.name}.global"),
            persistable=persistable,
            **kwargs,
        )

    def set_variable_initializer(self, var, initializer):
        """Declare var in startup program + attach its init op there."""
        startup_gb = self.startup_program.global_block()
        sv = startup_gb.create_var(
            name=var.name,
            shape=var.shape,
            dtype=var.dtype,
            persistable=True,
        )
        initializer(sv, startup_gb)
        self.startup_program._bump()
        return sv

    def append_op(self, **kwargs):
        op = self.main_block.append_op(**kwargs)
        self.main_program._bump()
        return op

    def append_bias_op(self, input_var: Variable, dim_start=1, dim_end=None) -> Variable:
        size = list(input_var.shape[dim_start:dim_end]) if input_var.shape else None
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        b = self.create_parameter(
            bias_attr, shape=size or [1], dtype=input_var.dtype, is_bias=True
        )
        tmp = self.create_variable_for_type_inference(
            dtype=input_var.dtype, shape=input_var.shape
        )
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start},
        )
        return tmp

    def append_activation(self, input_var: Variable) -> Variable:
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(
            dtype=input_var.dtype, shape=input_var.shape
        )
        self.append_op(
            type=act_type,
            inputs={"X": [input_var]},
            outputs={"Out": [tmp]},
            attrs=act,
        )
        return tmp

    def input(self, name="input"):
        inp = self.kwargs.get(name)
        if inp is None:
            raise ValueError(f"layer {self.layer_type} missing input {name!r}")
        return inp

    @property
    def act(self):
        return self.kwargs.get("act")
