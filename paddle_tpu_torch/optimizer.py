"""Optimizers: the port's copy of ``Optimizer``, ``SGDOptimizer``,
``MomentumOptimizer`` and ``AdamOptimizer`` of ``paddle_tpu/optimizer.py``
(:66-366, :500-592; Fluid's python/paddle/fluid/optimizer.py). Each
optimizer appends per-parameter update ops plus state-accumulator vars
initialized in the startup program, with the same names and attrs as
the reference. Adam and Momentum emit the one-pass ``fused_adam`` /
``fused_momentum`` (kernels K10 / K10m on CUDA) or the unfused chain
exactly when the reference does (the ``optimizer_fuse`` flag).

``apply_gradients`` has the reference's clip / regularization seam
(:167-210): with the fused op active, a ``GradientClipByGlobalNorm``
(the optimizer's ``grad_clip`` or ``clip.set_gradient_clip``'s), no
per-parameter clip and no regularizer, the global-norm factor folds
into the fused op's ``ClipScale`` operand; otherwise the clip ops
(``clip.py``) and the weight-decay ops (``regularizer.py``) rewrite the
gradients first and the update consumes the rewritten ones.

Not ported yet (ROADMAP A1): the other optimizer classes (Adagrad,
Adamax, RMSProp, Lamb, LarsMomentum, ...), refused by name, and the
dygraph path.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import clip as clip_mod
from .core.backward import append_backward
from .core.framework import (
    OpRole,
    Parameter,
    Variable,
    default_main_program,
    unique_name,
)
from .flags import optimizer_fuse_enabled
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adam", "AdamOptimizer"]

# the reference's other optimizer classes (paddle_tpu/optimizer.py
# __all__), refused by name until they are ported
_NOT_PORTED = ("Adagrad", "Adamax", "Dpsgd", "DecayedAdagrad", "Adadelta",
               "RMSProp", "Ftrl", "Lamb", "LarsMomentum")


def __getattr__(name):
    base = name[:-len("Optimizer")] if name.endswith("Optimizer") else name
    if base in _NOT_PORTED or name in ("DGCMomentumOptimizer",
                                       "ExponentialMovingAverage",
                                       "ModelAverage", "RecomputeOptimizer",
                                       "LookaheadOptimizer",
                                       "PipelineOptimizer"):
        raise NotImplementedError(
            f"optimizer.{name} is not ported to paddle_tpu_torch yet "
            "(ROADMAP A1: the other optimizer classes)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class Optimizer:
    def __init__(
        self,
        learning_rate,
        regularization=None,
        name=None,
        grad_clip=None,
    ):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name
        self._accumulators: Dict[str, Dict[str, Variable]] = defaultdict(dict)
        self._lr_var: Optional[Variable] = None
        self._fuse_active = False
        self._fused_clip_scale: Optional[Variable] = None
        self.type = getattr(self, "type", "sgd")
        self.helper = None

    # -- learning rate --------------------------------------------------------
    def _create_global_learning_rate(self):
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return
        if self._lr_var is not None:
            return
        from .layers.tensor import create_global_var

        self._lr_var = create_global_var(
            shape=[1],
            value=float(self._learning_rate),
            dtype="float32",
            persistable=True,
            name=unique_name.generate("learning_rate"),
        )

    def _global_learning_rate(self) -> Variable:
        return self._lr_var

    def _create_param_lr(self, param: Parameter) -> Variable:
        base = self._lr_var
        plr = float(param.optimize_attr.get("learning_rate", 1.0)) if param.optimize_attr else 1.0
        if plr == 1.0:
            return base
        from .layers.nn import scale

        return scale(base, scale=plr)

    # -- accumulators ---------------------------------------------------------
    def _add_accumulator(
        self, name: str, param: Parameter, dtype=None, fill_value=0.0, shape=None
    ) -> Variable:
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        helper = LayerHelper(self.type)
        var_name = unique_name.generate(f"{param.name}_{name}")
        gb = default_main_program().global_block()
        var = gb.create_var(
            name=var_name,
            shape=shape if shape is not None else param.shape,
            dtype=dtype or param.dtype,
            persistable=True,
            stop_gradient=True,
        )
        # structural tags, serialized with the program as the
        # reference's are
        var.is_accumulator = True
        var.accumulator_owner = param.name
        helper.set_variable_initializer(var, ConstantInitializer(fill_value))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name: str, param: Parameter) -> Variable:
        return self._accumulators[name][param.name]

    # -- hooks subclasses implement -------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, params_grads):
        pass

    # -- reference API --------------------------------------------------------
    def backward(
        self, loss, startup_program=None, parameter_list=None, no_grad_set=None,
        callbacks=None,
    ):
        return append_backward(loss, parameter_list, no_grad_set)

    def _fusion_active(self, params_grads) -> bool:
        # exact optimizer classes whose update the fused one-pass op can
        # replace — exact, not isinstance, as in the reference
        if type(self).__name__ not in ("AdamOptimizer", "MomentumOptimizer"):
            return False
        return optimizer_fuse_enabled()

    def apply_gradients(self, params_grads) -> List:
        params_grads = sorted(params_grads, key=lambda pg: pg[0].name)
        # fused one-pass update: a global-norm clip with nothing else
        # rewriting the grads folds into the fused ops' ClipScale (the
        # norm reduction stays ops; the per-grad multiply moves inside
        # the K10 / K10m pass). Any other rewrite (per-param clip attrs,
        # regularizers) keeps the clip/reg chain, and the fused op then
        # consumes the rewritten grads as the unfused one does.
        self._fuse_active = self._fusion_active(params_grads)
        self._fused_clip_scale = None
        effective_clip = self._grad_clip or clip_mod._global_clip
        can_fold_clip = (
            self._fuse_active
            and isinstance(effective_clip, clip_mod.GradientClipByGlobalNorm)
            and not any(getattr(p, "gradient_clip_attr", None)
                        for p, _ in params_grads)
            and self.regularization is None
            and not any(getattr(p, "regularizer", None)
                        for p, _ in params_grads)
        )
        if can_fold_clip:
            self._fused_clip_scale = effective_clip._append_scale_op(
                params_grads)
        else:
            params_grads = clip_mod.append_gradient_clip_ops(
                params_grads, self._grad_clip)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)

        block = default_main_program().global_block()
        self._create_accumulators(block, [pg[0] for pg in params_grads])
        opt_ops = []
        for pg in params_grads:
            op = self._append_optimize_op(block, pg)
            if op is not None:
                op.attrs["op_role"] = OpRole.Optimize
                opt_ops.append(op)
        self._finish_update(block, params_grads)
        default_main_program()._bump()
        return opt_ops

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(
        self, loss, startup_program=None, parameter_list=None, no_grad_set=None,
        grad_clip=None,
    ) -> Tuple[List, List[Tuple[Variable, Variable]]]:
        if grad_clip is not None:
            self._grad_clip = grad_clip
        self._create_global_learning_rate()
        params_grads = self.backward(loss, startup_program, parameter_list, no_grad_set)
        opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads


class SGDOptimizer(Optimizer):
    type = "sgd"

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p]},
        )


class MomentumOptimizer(Optimizer):
    type = "momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        inputs = {"Param": [p], "Grad": [g], "Velocity": [v],
                  "LearningRate": [self._create_param_lr(p)]}
        if self._fuse_active:
            # the one-pass update (K10m on CUDA) over the same velocity
            if self._fused_clip_scale is not None:
                inputs["ClipScale"] = [self._fused_clip_scale]
            op_type = "fused_momentum"
        else:
            op_type = "momentum"
        return block.append_op(
            type=op_type,
            inputs=inputs,
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class AdamOptimizer(Optimizer):
    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1, shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        inputs = {
            "Param": [p],
            "Grad": [g],
            "LearningRate": [self._create_param_lr(p)],
            "Moment1": [m1],
            "Moment2": [m2],
            "Beta1Pow": [b1p],
            "Beta2Pow": [b2p],
        }
        # the one-pass fused update (the K10 kernel on CUDA) runs over
        # the SAME accumulator vars as the unfused op, with the folded
        # global-norm clip as its ClipScale
        if self._fuse_active and self._fused_clip_scale is not None:
            inputs["ClipScale"] = [self._fused_clip_scale]
        return block.append_op(
            type="fused_adam" if self._fuse_active else "adam",
            inputs=inputs,
            outputs={
                "ParamOut": [p],
                "Moment1Out": [m1],
                "Moment2Out": [m2],
                "Beta1PowOut": [b1p],
                "Beta2PowOut": [b2p],
            },
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
        )


# reference-compatible aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
