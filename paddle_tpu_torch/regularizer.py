"""Weight-decay regularizers: the port's copy of
``paddle_tpu/regularizer.py`` (Fluid's python/paddle/fluid/regularizer.py).
``append_regularization_ops`` adds ``grad + coeff * penalty'(param)`` ops
before the optimizer update, with the reference's op types, var names
and ``op_role``: L2 a ``scale`` and a ``sum``; L1 the sign as
``param / (|param| + 1e-12)`` (``abs``, ``scale``, ``elementwise_div``)
then the same ``scale`` and ``sum``. A regularizer set on a parameter
(``ParamAttr(regularizer=...)``) overrides the optimizer's."""

from __future__ import annotations

from .core.framework import OpRole, unique_name

__all__ = ["WeightDecayRegularizer", "L1DecayRegularizer",
           "L2DecayRegularizer", "L1Decay", "L2Decay",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


def _decayed_grad(param, grad, block, penalty, coeff):
    """decay = coeff * penalty; grad + decay as a new var."""
    decay = block.create_var(
        name=unique_name.generate(f"{param.name}.{penalty[1]}"),
        stop_gradient=True)
    block.append_op(
        type="scale", inputs={"X": [penalty[0]]}, outputs={"Out": [decay]},
        attrs={"scale": coeff, "op_role": OpRole.Backward})
    new_grad = block.create_var(
        name=unique_name.generate(f"{param.name}.grad_reg"),
        stop_gradient=True)
    block.append_op(
        type="sum", inputs={"X": [grad, decay]}, outputs={"Out": [new_grad]},
        attrs={"op_role": OpRole.Backward})
    return new_grad


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = float(regularization_coeff)

    def __call__(self, param, grad, block):
        # decay = coeff * param; grad = grad + decay
        return _decayed_grad(param, grad, block, (param, "l2decay"),
                             self._coeff)


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = float(regularization_coeff)

    def __call__(self, param, grad, block):
        sign = block.create_var(
            name=unique_name.generate(f"{param.name}.sign"), stop_gradient=True)
        # sign(x) = x / (|x| + eps), as the reference writes it
        absx = block.create_var(
            name=unique_name.generate(f"{param.name}.abs"), stop_gradient=True)
        block.append_op(
            type="abs", inputs={"X": [param]}, outputs={"Out": [absx]},
            attrs={"op_role": OpRole.Backward})
        shifted = block.create_var(
            name=unique_name.generate(f"{param.name}.abs_eps"),
            stop_gradient=True)
        block.append_op(
            type="scale", inputs={"X": [absx]}, outputs={"Out": [shifted]},
            attrs={"scale": 1.0, "bias": 1e-12, "op_role": OpRole.Backward})
        block.append_op(
            type="elementwise_div", inputs={"X": [param], "Y": [shifted]},
            outputs={"Out": [sign]}, attrs={"op_role": OpRole.Backward})
        return _decayed_grad(param, grad, block, (sign, "l1decay"),
                             self._coeff)


# reference aliases
L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    out = []
    for param, grad in params_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if reg is None:
            out.append((param, grad))
            continue
        block = param.block.program.global_block()
        out.append((param, reg(param, grad, block)))
    return out
