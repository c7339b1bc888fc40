"""AMP decorator: the port's copy of
``paddle_tpu/contrib/mixed_precision/decorator.py`` (reference
contrib/mixed_precision/decorator.py:27, OptimizerWithMixedPrecision,
and fp16_utils.py's cast insertion): rewrite the forward ops, casting
white-list op inputs to the reduced dtype (bfloat16 by default) and
black-list op inputs back to float32; scale the loss; unscale and check
the gradients (``ops/control.py``). The master weights are the float32
parameters themselves: the casts are per use, so the optimizer updates
float32 parameters with float32 gradients.
"""

from __future__ import annotations

from ...core.framework import OpRole, Operator, unique_name
from .fp16_lists import AutoMixedPrecisionLists


def _insert_cast_ops(block, amp_lists, dest_dtype="bfloat16"):
    """Rewrite: for each white-list op, cast its float32 inputs to
    dest_dtype (cast ops inserted before it), and record that its
    outputs are dest_dtype. Black-list consumers of low-precision vars
    get cast-backs."""
    low_vars = set()
    new_ops = []
    cast_cache = {}

    def cast_var(name, to_dtype, before_ops):
        key = (name, to_dtype)
        if key in cast_cache:
            return cast_cache[key]
        out_name = unique_name.generate(f"{name}.cast_{to_dtype}")
        v = block._find_var_recursive(name)
        block.create_var(
            name=out_name,
            shape=v.shape if v is not None else None,
            dtype=to_dtype,
            stop_gradient=v.stop_gradient if v is not None else False,
        )
        op = Operator(
            block,
            "cast",
            inputs={"X": [name]},
            outputs={"Out": [out_name]},
            attrs={"out_dtype": to_dtype, "op_role": OpRole.Forward},
        )
        before_ops.append(op)
        cast_cache[key] = out_name
        return out_name

    def var_is_float(name):
        v = block._find_var_recursive(name)
        return v is None or v.dtype in ("float32", "float16", "bfloat16")

    for op in block.ops:
        role = int(op.attrs.get("op_role", 0))
        if role & (OpRole.Backward | OpRole.Optimize):
            new_ops.append(op)
            continue
        if op.type in amp_lists.white_list:
            pre = []
            for slot, names in op.inputs.items():
                casted = []
                for n in names:
                    if var_is_float(n) and n not in low_vars:
                        casted.append(cast_var(n, dest_dtype, pre))
                    else:
                        casted.append(n)
                op.inputs[slot] = casted
            new_ops.extend(pre)
            new_ops.append(op)
            for names in op.outputs.values():
                low_vars.update(names)
        elif op.type in amp_lists.black_list:
            pre = []
            for slot, names in op.inputs.items():
                casted = []
                for n in names:
                    if n in low_vars:
                        casted.append(cast_var(n, "float32", pre))
                    else:
                        casted.append(n)
                op.inputs[slot] = casted
            new_ops.extend(pre)
            new_ops.append(op)
        else:
            # gray: propagate low precision transparently (lowerings are
            # dtype-polymorphic)
            new_ops.append(op)
            if any(n in low_vars for names in op.inputs.values() for n in names):
                for names in op.outputs.values():
                    low_vars.update(names)
    block.ops = new_ops
    block.program._bump()


class OptimizerWithMixedPrecision:
    def __init__(
        self,
        optimizer,
        amp_lists: AutoMixedPrecisionLists,
        init_loss_scaling: float = 2.0**15,
        use_dynamic_loss_scaling: bool = True,
        incr_every_n_steps: int = 1000,
        decr_every_n_nan_or_inf: int = 2,
        incr_ratio: float = 2.0,
        decr_ratio: float = 0.8,
        dest_dtype: str = "bfloat16",
    ):
        self._optimizer = optimizer
        self._amp_lists = amp_lists
        self._init_loss_scaling = init_loss_scaling
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._dest_dtype = dest_dtype
        self._loss_scaling = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def backward(self, loss, startup_program=None, parameter_list=None, no_grad_set=None,
                 callbacks=None):
        from ...layers.tensor import create_global_var
        from ... import layers

        program = loss.block.program
        _insert_cast_ops(program.global_block(), self._amp_lists, self._dest_dtype)

        self._loss_scaling = create_global_var(
            [1], self._init_loss_scaling, "float32", persistable=True,
            name=unique_name.generate("loss_scaling"),
        )
        scaled_loss = layers.elementwise_mul(loss, self._loss_scaling)
        params_grads = self._optimizer.backward(
            scaled_loss, startup_program, parameter_list, no_grad_set
        )
        self._scaled_loss = scaled_loss
        return params_grads

    def apply_gradients(self, params_grads):
        from ...layer_helper import LayerHelper
        from ...layers.tensor import create_global_var
        from ...core.framework import default_main_program

        block = default_main_program().global_block()
        helper = LayerHelper("amp")
        grads = [g for _, g in params_grads]
        found_inf = helper.create_variable_for_type_inference(
            dtype="bool", shape=(), stop_gradient=True
        )
        unscaled = [
            helper.create_variable_for_type_inference(dtype="float32", shape=g.shape,
                                                      stop_gradient=True)
            for g in grads
        ]
        helper.append_op(
            type="check_finite_and_unscale",
            inputs={"X": grads, "Scale": [self._loss_scaling]},
            outputs={"Out": unscaled, "FoundInfinite": [found_inf]},
            attrs={"op_role": OpRole.Backward},
        )
        if self._use_dynamic:
            good = create_global_var([1], 0, "int32", persistable=True,
                                     name=unique_name.generate("good_steps"))
            bad = create_global_var([1], 0, "int32", persistable=True,
                                    name=unique_name.generate("bad_steps"))
            outs2 = [
                helper.create_variable_for_type_inference(
                    dtype="float32", shape=g.shape, stop_gradient=True
                )
                for g in grads
            ]
            helper.append_op(
                type="update_loss_scaling",
                inputs={
                    "X": unscaled,
                    "FoundInfinite": [found_inf],
                    "PrevLossScaling": [self._loss_scaling],
                    "InGoodSteps": [good],
                    "InBadSteps": [bad],
                },
                outputs={
                    "Out": outs2,
                    "LossScaling": [self._loss_scaling],
                    "OutGoodSteps": [good],
                    "OutBadSteps": [bad],
                },
                attrs={
                    "incr_every_n_steps": self._incr_every,
                    "decr_every_n_nan_or_inf": self._decr_every,
                    "incr_ratio": self._incr_ratio,
                    "decr_ratio": self._decr_ratio,
                    "op_role": OpRole.Backward,
                },
            )
            unscaled = outs2
        new_pgs = [(p, g) for (p, _), g in zip(params_grads, unscaled)]
        return self._optimizer.apply_gradients(new_pgs)

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        self._optimizer._create_global_learning_rate()
        pgs = self.backward(loss, startup_program, parameter_list, no_grad_set)
        ops = self.apply_gradients(pgs)
        return ops, pgs

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


def decorate(
    optimizer,
    amp_lists=None,
    init_loss_scaling=2.0**15,
    use_dynamic_loss_scaling=True,
    incr_every_n_steps=1000,
    decr_every_n_nan_or_inf=2,
    incr_ratio=2.0,
    decr_ratio=0.8,
    dest_dtype="bfloat16",
):
    """Reference contrib/mixed_precision/decorator.py:218 decorate()."""
    return OptimizerWithMixedPrecision(
        optimizer,
        amp_lists or AutoMixedPrecisionLists(),
        init_loss_scaling,
        use_dynamic_loss_scaling,
        incr_every_n_steps,
        decr_every_n_nan_or_inf,
        incr_ratio,
        decr_ratio,
        dest_dtype,
    )
