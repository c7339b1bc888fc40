"""Quantization-aware training: the port's copy of
``paddle_tpu/contrib/slim/quantization.py`` (Fluid's
contrib/slim/quantization/quantization_pass.py).

``QuantizationTransformPass.apply(program)`` puts fake-quantize ops
(``ops/quant.py``) on the weight and activation inputs of each
quantizable op (conv2d, depthwise_conv2d, mul, matmul): weights by
their abs-max, activations by a moving-average abs-max (or abs-max, or
the sliding-window range abs-max) whose state rides persistable vars
initialised in the startup program. It runs after ``minimize``, on a
Program that already holds its backward: the grad ops still name the
original inputs, and the Executor takes their gradients there
(``core/executor.py`` ``_Plan._retraced``), as the JAX package does.
``QuantizationFreezePass`` switches the fake-quantize ops to their
``is_test`` form for deployment.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ...core.framework import OpRole, Operator, Program, unique_name
from ...initializer import ConstantInitializer

__all__ = ["QuantizationTransformPass", "QuantizationFreezePass",
           "quant_aware"]

_QUANTIZABLE = {"conv2d", "depthwise_conv2d", "mul", "matmul", "matmul_v2"}
_WEIGHT_SLOTS = {"Filter", "Y"}  # conv weight slot / mul-matmul rhs
# the range_abs_max window of batch maxima
_WINDOW = 10000


class QuantizationTransformPass:
    def __init__(
        self,
        scope=None,
        place=None,
        weight_bits: int = 8,
        activation_bits: int = 8,
        activation_quantize_type: str = "moving_average_abs_max",
        weight_quantize_type: str = "abs_max",
        moving_rate: float = 0.9,
        quantizable_op_type: Optional[Sequence[str]] = None,
        startup_program: Optional[Program] = None,
    ):
        self._weight_bits = weight_bits
        self._act_bits = activation_bits
        self._act_type = activation_quantize_type
        self._weight_type = weight_quantize_type
        self._moving_rate = moving_rate
        self._ops = set(quantizable_op_type or _QUANTIZABLE)
        self._startup_program = startup_program

    def apply(self, program: Program) -> Program:
        """Rewrite ``program`` in place (and return it): each input is
        quantized once, before its first forward consumer."""
        block = program.global_block()
        new_ops = []
        quantized: Dict[str, str] = {}

        def quant_var(name: str, is_weight: bool, out_ops):
            if name in quantized:
                return quantized[name]
            src = block._find_var_recursive(name)
            qname = unique_name.generate(f"{name}.quantized")
            block.create_var(
                name=qname,
                shape=src.shape if src is not None else None,
                dtype=src.dtype if src is not None else "float32",
                stop_gradient=False,
            )
            scale_name = unique_name.generate(f"{name}.scale")
            block.create_var(name=scale_name, shape=(1,), stop_gradient=True)
            bits = self._weight_bits if is_weight else self._act_bits
            if is_weight or self._act_type == "abs_max":
                out_ops.append(Operator(
                    block, "fake_quantize_abs_max",
                    inputs={"X": [name]},
                    outputs={"Out": [qname], "OutScale": [scale_name]},
                    attrs={"bit_length": bits, "op_role": OpRole.Forward}))
            elif self._act_type == "range_abs_max":
                # the window and the step counter are persistables the op
                # reads and writes each step; the seed scale is small, so
                # the first real batch sets the scale
                in_scale = self._persistable_scalar(
                    block, f"{name}.q_scale", 0.001)
                it = self._persistable_scalar(block, f"{name}.q_iter", 0.0)
                scales = self._persistable_scalar(
                    block, f"{name}.q_scales", 0.0, shape=(_WINDOW,))
                out_ops.append(Operator(
                    block, "fake_quantize_range_abs_max",
                    inputs={"X": [name], "InScale": [in_scale.name],
                            "Iter": [it.name], "InScales": [scales.name]},
                    outputs={"Out": [qname], "OutScale": [in_scale.name],
                             "OutScales": [scales.name]},
                    attrs={"bit_length": bits, "window_size": _WINDOW,
                           "op_role": OpRole.Forward}))
                out_ops.append(Operator(
                    block, "increment", inputs={"X": [it.name]},
                    outputs={"Out": [it.name]},
                    attrs={"step": 1.0, "op_role": OpRole.Forward}))
            else:
                state = self._persistable_scalar(block, f"{name}.q_state", 1.0)
                accum = self._persistable_scalar(block, f"{name}.q_accum", 1.0)
                in_scale = self._persistable_scalar(block, f"{name}.q_scale", 1.0)
                out_ops.append(Operator(
                    block, "fake_quantize_dequantize_moving_average_abs_max",
                    inputs={"X": [name], "InScale": [in_scale.name],
                            "InAccum": [accum.name],
                            "InState": [state.name]},
                    outputs={"Out": [qname], "OutScale": [in_scale.name],
                             "OutAccum": [accum.name],
                             "OutState": [state.name]},
                    attrs={"bit_length": bits,
                           "moving_rate": self._moving_rate,
                           "op_role": OpRole.Forward}))
            quantized[name] = qname
            return qname

        for op in block.ops:
            role = int(op.attrs.get("op_role", 0))
            if op.type not in self._ops or role & (OpRole.Backward | OpRole.Optimize):
                new_ops.append(op)
                continue
            pre = []
            for slot, names in op.inputs.items():
                is_weight = slot in _WEIGHT_SLOTS
                # the activation input and the weight only (not Bias)
                if not is_weight and slot not in ("Input", "X"):
                    continue
                op.inputs[slot] = [quant_var(n, is_weight, pre) for n in names]
            new_ops.extend(pre)
            new_ops.append(op)
        block.ops = new_ops
        program._bump()
        return program

    def _persistable_scalar(self, block, name, value, shape=(1,)):
        name = unique_name.generate(name)
        v = block.create_var(name=name, shape=shape, persistable=True, stop_gradient=True)
        sp = self._startup_program
        if sp is not None:
            sv = sp.global_block().create_var(
                name=name, shape=shape, persistable=True
            )
            ConstantInitializer(value)(sv, sp.global_block())
            sp._bump()
        return v


class QuantizationFreezePass:
    """After QAT, for deployment: the fake-quantize ops take their
    ``is_test`` form (quantize by the learned scales, no state update).
    They already emit dequantized values, so the frozen Program's
    forward equals the fake-quantized one; an int8 export is a matter
    of serialization."""

    def __init__(self, scope, place, weight_bits=8, activation_bits=8):
        self._scope = scope
        self._weight_bits = weight_bits

    def apply(self, program: Program) -> Program:
        for blk in program.blocks:
            for op in blk.ops:
                if op.type.startswith("fake_quantize"):
                    op.attrs["is_test"] = True
        program._bump()
        return program


def quant_aware(program: Program, startup_program: Program, scope=None,
                weight_bits=8, activation_bits=8) -> Program:
    """One call: ``QuantizationTransformPass(...).apply(program)``."""
    p = QuantizationTransformPass(
        scope=scope, weight_bits=weight_bits, activation_bits=activation_bits,
        startup_program=startup_program,
    )
    return p.apply(program)
