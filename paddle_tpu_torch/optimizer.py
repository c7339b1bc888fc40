"""Optimizers: the port's copy of ``Optimizer``, ``SGDOptimizer``,
``MomentumOptimizer``, ``AdamOptimizer`` and the other update rules of
``paddle_tpu/optimizer.py`` (:66-403, :472-838: LarsMomentum, Adagrad,
Adamax, Dpsgd, DecayedAdagrad, Adadelta, RMSProp, Ftrl and Lamb; Fluid's
python/paddle/fluid/optimizer.py). Each
optimizer appends per-parameter update ops plus state-accumulator vars
initialized in the startup program, with the same names and attrs as
the reference. Adam and Momentum emit the one-pass ``fused_adam`` /
``fused_momentum`` (kernels K10 / K10m on CUDA) or the unfused chain
exactly when the reference does (the ``optimizer_fuse`` flag); the
choice is by exact class, so Lamb (an Adam subclass) stays unfused.

``apply_gradients`` has the reference's clip / regularization seam
(:167-210): with the fused op active, a ``GradientClipByGlobalNorm``
(the optimizer's ``grad_clip`` or ``clip.set_gradient_clip``'s), no
per-parameter clip and no regularizer, the global-norm factor folds
into the fused op's ``ClipScale`` operand; otherwise the clip ops
(``clip.py``) and the weight-decay ops (``regularizer.py``) rewrite the
gradients first and the update consumes the rewritten ones.

Not ported yet, refused by name with the ROADMAP item that holds each
(``_NOT_PORTED``): the meta-optimizers, and the dygraph path.
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
           "MomentumOptimizer", "LarsMomentum", "LarsMomentumOptimizer",
           "Adagrad", "AdagradOptimizer", "Adam", "AdamOptimizer",
           "Adamax", "AdamaxOptimizer", "Dpsgd", "DpsgdOptimizer",
           "DecayedAdagrad", "DecayedAdagradOptimizer", "Adadelta",
           "AdadeltaOptimizer", "RMSProp", "RMSPropOptimizer", "Ftrl",
           "FtrlOptimizer", "Lamb", "LambOptimizer"]

# the reference's meta-optimizers (paddle_tpu/optimizer.py __all__),
# refused by name with what each waits for
_NOT_PORTED = {
    "DGCMomentumOptimizer": "ROADMAP A10: its sparsified gradient rides "
                            "the data-parallel collectives",
    "ExponentialMovingAverage": "ROADMAP A1, after core/control_flow.py",
    "ModelAverage": "ROADMAP A1, after core/control_flow.py",
    "RecomputeOptimizer": "ROADMAP A1, after core/control_flow.py "
                          "(recompute segments)",
    "LookaheadOptimizer": "ROADMAP A1, after core/control_flow.py",
    "GradientMergeOptimizer": "ROADMAP A1, after core/control_flow.py",
    "PipelineOptimizer": "ROADMAP A10: pipeline parallelism",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer.{name} is not ported to paddle_tpu_torch yet "
            f"({_NOT_PORTED[name]})")
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


class LarsMomentumOptimizer(Optimizer):
    """Reference optimizer.py:1442: momentum with a layer-wise lr."""

    type = "lars_momentum"

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay},
        )


class AdagradOptimizer(Optimizer):
    type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"epsilon": self._epsilon},
        )


class AdamaxOptimizer(Optimizer):
    type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p,
                                  fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        u = self._get_accumulator("inf_norm", p)
        return block.append_op(
            type="adamax",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(p)],
                    "Moment": [m], "InfNorm": [u],
                    "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)]},
            outputs={"ParamOut": [p], "MomentOut": [m], "InfNormOut": [u]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
        )

    def _finish_update(self, block, params_grads):
        # beta1_pow *= beta1 once a step (reference adamax semantics)
        for p, _ in params_grads:
            b1p = self._get_accumulator("beta1_pow_acc", p)
            block.append_op(
                type="scale", inputs={"X": [b1p]}, outputs={"Out": [b1p]},
                attrs={"scale": self._beta1, "op_role": OpRole.Optimize},
            )


class DpsgdOptimizer(Optimizer):
    type = "dpsgd"

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0,
                 sigma=1.0, **kw):
        super().__init__(learning_rate, **kw)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            type="dpsgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p]},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma},
        )


class DecayedAdagradOptimizer(Optimizer):
    type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class AdadeltaOptimizer(Optimizer):
    type = "adadelta"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("__avg_squared_grad", p)
            self._add_accumulator("__avg_squared_update", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        asg = self._get_accumulator("__avg_squared_grad", p)
        asu = self._get_accumulator("__avg_squared_update", p)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [asg],
                    "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [asg],
                     "AvgSquaredUpdateOut": [asu]},
            attrs={"epsilon": self._epsilon, "rho": self._rho},
        )


class RMSPropOptimizer(Optimizer):
    type = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        mom = self._get_accumulator("momentum", p)
        ms = self._get_accumulator("mean_square", p)
        mg = self._get_accumulator("mean_grad", p)
        return block.append_op(
            type="rmsprop",
            inputs={"Param": [p], "Grad": [g], "Moment": [mom],
                    "MeanSquare": [ms], "MeanGrad": [mg],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p], "MomentOut": [mom],
                     "MeanSquareOut": [ms], "MeanGradOut": [mg]},
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum, "centered": self._centered},
        )


class FtrlOptimizer(Optimizer):
    type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [p], "SquaredAccumulator": [sq],
                    "LinearAccumulator": [lin], "Grad": [g],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power},
        )


class LambOptimizer(AdamOptimizer):
    """Reference optimizer.py:2699: Adam's moments with a layer-wise
    trust ratio; ``exclude_from_weight_decay_fn(param)`` true takes the
    parameter's weight decay to 0."""

    type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, block, pg):
        p, g = pg
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            type="lamb",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(p)],
                    "Moment1": [m1], "Moment2": [m2],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            outputs={"ParamOut": [p], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "weight_decay": wd},
        )


# reference-compatible aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Dpsgd = DpsgdOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
