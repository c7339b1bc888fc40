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

The meta-optimizers (:839-1157): ``ExponentialMovingAverage`` and
``ModelAverage`` append in-graph averaging ops, and their ``apply()``
context swaps the averaged values into the scope and back;
``RecomputeOptimizer`` differentiates through
``append_backward_with_recompute``; ``LookaheadOptimizer`` keeps slow
weights (a copy of the parameters made by the startup program) and syncs
them every k steps in-graph; ``GradientMergeOptimizer`` marks the
Program, and the Executor's bound step runs it as k microbatches and
one update (``runtime/dispatch.py``).

``DGCMomentumOptimizer`` (:404-470) is momentum with deep gradient
compression: the ``dgc`` op sparsifies the momentum-corrected residual
and plain ``sgd`` applies it; under data parallelism the gradient it
reads is already the cross-replica mean. ``apply_gradients`` plans the
gradient collectives when the ``collective_*`` flags ask
(``parallel.collectives.ensure_planned``, as the reference's seam at
:215-221 does).

``PipelineOptimizer`` (:1160-1234) stamps the pipeline cuts, the
microbatch count and the schedule on the Program; a ``CompiledProgram.
with_pipeline`` step runs it a stage a rank (``core/pipeline_program.
py``).

The eager (dygraph) path (:228-295): ``minimize(loss_varbase,
parameter_list=...)`` applies each parameter's update through the
optimizer's own unfused op lowering (``self.type``: ``sgd``,
``momentum``, ``adam``, ``lamb``) with the state kept per parameter,
after ``loss.backward()``. The learning rate is a float, a VarBase or a
``dygraph.LearningRateDecay`` (stepped once a call). SGD, Momentum,
Adam and Lamb have an eager path, as in JAX; every other optimizer
raises ``NotImplementedError`` naming itself (JAX's default eager
inputs fail with ``KeyError: 'Moment'`` for Adagrad, RMSProp and
Adamax). ``regularization`` and ``grad_clip`` raise ``ValueError`` in
eager mode (JAX drops them without a word). Lamb's eager update takes
its ``lamb_weight_decay`` and ``exclude_from_weight_decay_fn`` (JAX's
takes the op's default 0.01).
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import clip as clip_mod
from .core.backward import append_backward, append_backward_with_recompute
from .core.executor import global_scope
from .core.framework import (
    OpRole,
    Parameter,
    Variable,
    default_main_program,
    default_startup_program,  # noqa: F401  (JAX's optimizer re-exports it)
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
           "FtrlOptimizer", "Lamb", "LambOptimizer",
           "ExponentialMovingAverage", "ModelAverage", "RecomputeOptimizer",
           "LookaheadOptimizer", "GradientMergeOptimizer",
           "DGCMomentumOptimizer", "PipelineOptimizer"]

def __getattr__(name):
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
        # replace — exact, not isinstance, as in the reference; a class
        # that keeps its base's update names it in ``_update_type``
        # (contrib.extend_optimizer)
        name = getattr(type(self), "_update_type", type(self).__name__)
        if name not in ("AdamOptimizer", "MomentumOptimizer"):
            return False
        return optimizer_fuse_enabled()

    def apply_gradients(self, params_grads) -> List:
        params_grads = sorted(params_grads, key=lambda pg: pg[0].name)
        # the raw backward grads, before clip and regularization rewrite
        # them: the collective planner buckets exactly these
        raw_params_grads = list(params_grads)
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
        # flag-gated (collective_bucket_mb / collective_quantization):
        # bucket the data-parallel gradient all-reduce and repoint the
        # clip, regularization and optimizer ops at the reduced values;
        # a no-op with the flags off
        from .parallel.collectives import ensure_planned

        ensure_planned(default_main_program(),
                       params_grads=raw_params_grads)
        default_main_program()._bump()
        return opt_ops

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(
        self, loss, startup_program=None, parameter_list=None, no_grad_set=None,
        grad_clip=None,
    ) -> Tuple[List, List[Tuple[Variable, Variable]]]:
        from .dygraph.base import VarBase

        if isinstance(loss, VarBase):
            return self._eager_minimize(loss, parameter_list, grad_clip)
        if grad_clip is not None:
            self._grad_clip = grad_clip
        self._create_global_learning_rate()
        params_grads = self.backward(loss, startup_program, parameter_list, no_grad_set)
        opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads

    # -- eager (dygraph) path -------------------------------------------------
    # the optimizers with an eager state (_eager_inputs / _eager_writeback)
    _eager = False

    def _eager_minimize(self, loss, parameter_list, grad_clip=None):
        from .core.registry import LoweringContext, get_op_def
        from .dygraph.base import _PseudoOp

        if not self._eager:
            raise NotImplementedError(
                f"{type(self).__name__} has no eager (dygraph) update in "
                "paddle_tpu_torch: use SGD, Momentum, Adam or Lamb, or "
                "build a Program")
        refused = [n for n, v in (("regularization", self.regularization),
                                  ("grad_clip", grad_clip or self._grad_clip))
                   if v is not None]
        if refused:
            raise ValueError(
                f"{type(self).__name__}.minimize in dygraph mode does not "
                f"apply {' or '.join(refused)}: remove "
                f"{'them' if len(refused) > 1 else 'it'} or build a Program")
        if parameter_list is None:
            raise ValueError("dygraph minimize requires parameter_list")
        lr = self._eager_lr()
        lr_on = {}      # the rate on each parameter's device, copied once
        opdef = get_op_def(self.type)
        states = self.__dict__.setdefault("_eager_states", {})
        for p in parameter_list:
            g = p.grad
            if g is None or p.stop_gradient:
                continue
            state = states.setdefault(id(p), {})
            param = p.value.detach()
            if param.device not in lr_on:
                lr_on[param.device] = lr.to(param.device)
            ins = self._eager_inputs(p, param, g.detach(), state,
                                     lr_on[param.device])
            pseudo = _PseudoOp(self.type, self._eager_attrs(p))
            with torch.no_grad():
                outs = opdef.lower(LoweringContext(param.device), pseudo, ins)
            self._eager_writeback(p, state, outs)
        return [], []

    def _eager_lr(self) -> torch.Tensor:
        lr = self._learning_rate
        if hasattr(lr, "value"):
            return lr.value.detach().float().reshape(1)
        if callable(lr):
            lr = lr()
        return torch.tensor([float(lr)], dtype=torch.float32)

    def _eager_attrs(self, p):
        return {}

    def _eager_inputs(self, p, param, grad, state, lr):
        return {"Param": [param], "Grad": [grad], "LearningRate": [lr]}

    def _eager_writeback(self, p, state, outs):
        p.set_value(outs["ParamOut"][0])


class SGDOptimizer(Optimizer):
    type = "sgd"
    _eager = True

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
    _eager = True

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _eager_attrs(self, p):
        return {"mu": self._momentum, "use_nesterov": self._use_nesterov}

    def _eager_inputs(self, p, param, grad, state, lr):
        if "velocity" not in state:
            state["velocity"] = torch.zeros_like(param)
        return {"Param": [param], "Grad": [grad],
                "Velocity": [state["velocity"]], "LearningRate": [lr]}

    def _eager_writeback(self, p, state, outs):
        p.set_value(outs["ParamOut"][0])
        state["velocity"] = outs["VelocityOut"][0]

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


class DGCMomentumOptimizer(MomentumOptimizer):
    """Reference optimizer.py:1042, the JAX package's :404-470: momentum
    with deep gradient compression. Each parameter keeps U (the
    momentum-corrected accumulator) and V (the local residual); each
    step the ``dgc`` op ships the top share of |V| (``sparsity``, per
    rampup stage) as the gradient and keeps the rest, and the update is
    plain ``sgd`` on it. Before ``rampup_begin_step`` the gradient
    passes dense (momentum)."""

    type = "dgc_momentum"
    _eager = False

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 **kw):
        super().__init__(learning_rate, momentum, use_nesterov, **kw)
        self._rampup_begin_step = rampup_begin_step
        self._rampup_step = rampup_step
        self._sparsity = list(sparsity)
        self._dgc_step_var = None

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("dgc_u", p)
            self._add_accumulator("dgc_v", p)
        if self._dgc_step_var is None:
            from .layers.tensor import create_global_var

            self._dgc_step_var = create_global_var(
                [1], 0.0, "float32", persistable=True,
                name=unique_name.generate("dgc_step"))

    def _append_optimize_op(self, block, pg):
        p, g = pg
        u = self._get_accumulator("dgc_u", p)
        v = self._get_accumulator("dgc_v", p)
        enc = block.create_var(
            name=unique_name.generate(f"{p.name}.dgc_enc"),
            shape=p.shape, dtype=p.dtype, stop_gradient=True)
        block.append_op(
            type="dgc",
            inputs={"U": [u], "V": [v], "Grad": [g],
                    "CurrentStep": [self._dgc_step_var]},
            outputs={"UOut": [u], "VOut": [v], "EncodeGrad": [enc]},
            attrs={"m": float(self._momentum),
                   "use_nesterov": self._use_nesterov,
                   "rampup_begin_step": float(self._rampup_begin_step),
                   "rampup_step": float(self._rampup_step),
                   "sparsity": self._sparsity,
                   "op_role": OpRole.Optimize})
        return block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [enc],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p]},
            attrs={"op_role": OpRole.Optimize})

    def _finish_update(self, block, params_grads):
        block.append_op(
            type="increment",
            inputs={"X": [self._dgc_step_var]},
            outputs={"Out": [self._dgc_step_var]},
            attrs={"step": 1.0, "op_role": OpRole.Optimize})


class AdamOptimizer(Optimizer):
    type = "adam"
    _eager = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _eager_attrs(self, p):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}

    def _eager_inputs(self, p, param, grad, state, lr):
        if "m1" not in state:
            state["m1"] = torch.zeros_like(param)
            state["m2"] = torch.zeros_like(param)
            state["b1p"] = torch.full((1,), self._beta1, dtype=torch.float32,
                                      device=param.device)
            state["b2p"] = torch.full((1,), self._beta2, dtype=torch.float32,
                                      device=param.device)
        return {"Param": [param], "Grad": [grad], "LearningRate": [lr],
                "Moment1": [state["m1"]], "Moment2": [state["m2"]],
                "Beta1Pow": [state["b1p"]], "Beta2Pow": [state["b2p"]]}

    def _eager_writeback(self, p, state, outs):
        p.set_value(outs["ParamOut"][0])
        state["m1"] = outs["Moment1Out"][0]
        state["m2"] = outs["Moment2Out"][0]
        state["b1p"] = outs["Beta1PowOut"][0]
        state["b2p"] = outs["Beta2PowOut"][0]

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

    def _eager_attrs(self, p):
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        return dict(super()._eager_attrs(p), weight_decay=wd)

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


# --------------------------------------------------------------------------
# meta-optimizers (paddle_tpu/optimizer.py:839-1157)
# --------------------------------------------------------------------------


def _first(value) -> float:
    return float(np.asarray(value.detach().cpu() if isinstance(
        value, torch.Tensor) else value).reshape(-1)[0])


@contextlib.contextmanager
def _swapped(values: Dict[str, object], need_restore: bool):
    """Put ``values`` ({param name: tensor}) into the global scope for
    the block, then the parameters' own tensors back."""
    scope = global_scope()
    saved = {n: scope.find_var(n) for n in values}
    for n, v in values.items():
        scope.set_var(n, v)
    try:
        yield
    finally:
        if need_restore:
            for n, v in saved.items():
                scope.set_var(n, v)


def _divided(v, d: float):
    # a division, as JAX's ``jnp.asarray(sv) / d``, through a tensor of
    # the value's dtype (torch divides by a Python float through its
    # reciprocal)
    return v / torch.tensor(d, dtype=v.dtype, device=v.device)


class ExponentialMovingAverage:
    """Reference optimizer.py:3166: shadow vars updated every step by
    in-graph ops; ``apply()`` swaps the bias-corrected averages
    (shadow / (1 - decay^t)) in for evaluation."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or ""
        self._shadows: Dict[str, Variable] = {}
        self._counter: Optional[Variable] = None

    def update(self):
        from .layers.control_flow import increment
        from .layers.tensor import create_global_var

        helper = LayerHelper("ema")
        block = default_main_program().global_block()
        if self._counter is None:
            self._counter = create_global_var(
                [1], 0, "float32", persistable=True,
                name=unique_name.generate("ema_step"))
        increment(self._counter, 1.0)
        for p in default_main_program().all_parameters():
            if not p.trainable:
                continue
            shadow = block.create_var(
                name=unique_name.generate(f"{p.name}.ema"), shape=p.shape,
                dtype=p.dtype, persistable=True, stop_gradient=True)
            helper.set_variable_initializer(shadow, ConstantInitializer(0.0))
            self._shadows[p.name] = shadow
            # shadow = decay * shadow + (1 - decay) * param
            block.append_op(type="scale", inputs={"X": [shadow]},
                            outputs={"Out": [shadow]},
                            attrs={"scale": self._decay,
                                   "op_role": OpRole.Optimize})
            tmp = block.create_var(
                name=unique_name.generate(f"{p.name}.ema_tmp"),
                stop_gradient=True)
            block.append_op(type="scale", inputs={"X": [p]},
                            outputs={"Out": [tmp]},
                            attrs={"scale": 1 - self._decay,
                                   "op_role": OpRole.Optimize})
            block.append_op(type="sum", inputs={"X": [shadow, tmp]},
                            outputs={"Out": [shadow]},
                            attrs={"op_role": OpRole.Optimize})
        default_main_program()._bump()

    def apply(self, executor=None, need_restore=True):
        scope = global_scope()
        cnt = (scope.find_var(self._counter.name)
               if self._counter is not None else None)
        t = _first(cnt) if cnt is not None else 0.0
        correction = 1.0 - self._decay ** t if t > 0 else 1.0
        values = {}
        for pname, shadow in self._shadows.items():
            sv = scope.find_var(shadow.name)
            if sv is not None and correction > 0:
                values[pname] = _divided(sv, correction)
        return _swapped(values, need_restore)

    def restore(self, executor=None):
        pass


class ModelAverage(Optimizer):
    """Reference optimizer.py:2862: a running sum of the parameters over
    the trajectory; ``apply()`` swaps sum / count in for evaluation.
    Construction appends the accumulation ops to the current main
    program, as the reference does."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kw):
        super().__init__(0.0, **kw)
        self._window = max_average_window
        self._sums: Dict[str, Variable] = {}
        self._count: Optional[Variable] = None
        self._attach()

    def _attach(self):
        from .layers.control_flow import increment
        from .layers.tensor import create_global_var

        helper = LayerHelper("model_average")
        block = default_main_program().global_block()
        params = [p for p in default_main_program().all_parameters()
                  if p.trainable]
        if not params:
            return
        self._count = create_global_var(
            [1], 0, "float32", persistable=True,
            name=unique_name.generate("avg_count"))
        increment(self._count, 1.0)
        for p in params:
            s = block.create_var(
                name=unique_name.generate(f"{p.name}.avg_sum"),
                shape=p.shape, dtype=p.dtype, persistable=True,
                stop_gradient=True)
            helper.set_variable_initializer(s, ConstantInitializer(0.0))
            self._sums[p.name] = s
            block.append_op(type="sum", inputs={"X": [s, p]},
                            outputs={"Out": [s]},
                            attrs={"op_role": OpRole.Optimize})
        default_main_program()._bump()

    def apply(self, executor=None, need_restore=True):
        scope = global_scope()
        cnt = (scope.find_var(self._count.name)
               if self._count is not None else None)
        count = _first(cnt) if cnt is not None else 0.0
        values = {}
        for pname, svar in self._sums.items():
            sv = scope.find_var(svar.name)
            if sv is not None and count > 0:
                values[pname] = _divided(sv, count)
        return _swapped(values, need_restore)

    def restore(self, executor=None):
        pass


class RecomputeOptimizer(Optimizer):
    """Reference optimizer.py:3714: wraps an optimizer; with checkpoints
    set, the backward is one ``recompute_segment_grad`` op a
    checkpoint-delimited segment (``append_backward_with_recompute``),
    which reruns the segment's forward instead of keeping its
    activations (``core/control_flow.py``)."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        if self._checkpoints:
            return append_backward_with_recompute(
                loss, self._checkpoints, parameter_list, no_grad_set)
        return self._optimizer.backward(loss, startup_program,
                                        parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        self._optimizer._create_global_learning_rate()
        pgs = self.backward(loss, startup_program, parameter_list,
                            no_grad_set)
        ops = self.apply_gradients(pgs)
        return ops, pgs

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


class LookaheadOptimizer:
    """Reference optimizer.py:4007: fast and slow weights; every k steps
    slow += alpha * (fast - slow) and fast = slow, in-graph."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None):
        from .layers.control_flow import equal, increment
        from .layers.nn import (elementwise_add, elementwise_mod,
                                elementwise_sub)
        from .layers.nn import scale as scale_layer
        from .layers.nn import where as where_layer
        from .layers.tensor import create_global_var, fill_constant

        opt_ops, params_grads = self.inner_optimizer.minimize(
            loss, startup_program)
        helper = LayerHelper("lookahead")
        block = default_main_program().global_block()
        step = create_global_var([1], 0, "float32", persistable=True,
                                 name=unique_name.generate("lookahead_step"))
        increment(step, 1.0)
        kvar = fill_constant([1], "float32", float(self.k))
        rem = elementwise_mod(step, kvar)
        sync = equal(rem, fill_constant([1], "float32", 0.0))
        for p, g in params_grads:
            slow = block.create_var(
                name=unique_name.generate(f"{p.name}.slow"), shape=p.shape,
                dtype=p.dtype, persistable=True, stop_gradient=True)
            # the slow weights start AS the parameters (the reference
            # assigns slow = param in startup): zeros would scale every
            # parameter by alpha at the first sync
            startup_gb = helper.startup_program.global_block()
            startup_gb.create_var(name=slow.name, shape=p.shape,
                                  dtype=p.dtype, persistable=True)
            startup_gb.append_op(type="assign", inputs={"X": [p.name]},
                                 outputs={"Out": [slow.name]})
            helper.startup_program._bump()
            # new_slow = slow + alpha * (p - slow) when syncing, else slow
            upd = elementwise_add(slow, scale_layer(elementwise_sub(p, slow),
                                                    scale=self.alpha))
            new_slow = where_layer(_bcast_cond(sync, p), upd, slow)
            new_fast = where_layer(_bcast_cond(sync, p), upd, p)
            block.append_op(type="assign", inputs={"X": [new_slow]},
                            outputs={"Out": [slow]},
                            attrs={"op_role": OpRole.Optimize})
            block.append_op(type="assign", inputs={"X": [new_fast]},
                            outputs={"Out": [p]},
                            attrs={"op_role": OpRole.Optimize})
        default_main_program()._bump()
        return opt_ops, params_grads


def _bcast_cond(cond_var, template):
    """A [1] bool broadcast to the template's shape, for ``where``."""
    from .layers.nn import cast, elementwise_mul
    from .layers.tensor import ones as ones_layer

    c = cast(cond_var, "float32")
    if not (template.shape and all(d and d > 0 for d in template.shape)):
        raise NotImplementedError("lookahead needs static param shapes")
    b = elementwise_mul(ones_layer(list(template.shape), "float32"), c)
    return cast(b, "bool")


class GradientMergeOptimizer:
    """Gradient accumulation over k microbatches with one optimizer
    apply (reference ir/multi_batch_merge_pass.cc). Marks the Program;
    the Executor's bound step splits each feed into k microbatches, runs
    the forward and backward once each, accumulates what the optimizer
    reads (averaged with ``avg``), then runs the optimizer ops once
    (``runtime.dispatch._MergePlan``). k must divide the batch."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self.inner_optimizer = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = bool(avg)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .parallel.collectives import suppress_planning

        # the merge loop owns the gradient flow: the flag-gated planner
        # must not bucket it (the reference's :1188-1191)
        with suppress_planning():
            out = self.inner_optimizer.minimize(loss, startup_program,
                                                parameter_list, no_grad_set)
        program = loss.block.program
        program._gradient_merge_k = self.k_steps
        program._gradient_merge_avg = self.avg
        program._bump()
        return out

    def __getattr__(self, item):
        return getattr(self.inner_optimizer, item)


class PipelineOptimizer:
    """The reference's PipelineOptimizer (optimizer.py:3414): ``cut_list``
    marks where the program's forward splits into stages. Run through
    ``CompiledProgram(...).with_pipeline()`` on a world of one rank a
    stage, the step runs the GPipe or 1F1B schedule over the ``pp``
    axis (``core/pipeline_program.py``); run plainly, the program
    trains unpipelined. ``num_microbatches`` splits each feed's batch;
    ``schedule`` is "gpipe" or "1f1b". A forward that writes
    persistable vars (train-mode batch norm's running statistics) is
    refused at ``minimize``: a per-microbatch write on one stage has no
    merged value."""

    def __init__(self, optimizer, cut_list=None, place_list=None,
                 concurrency_list=None, queue_size=30, sync_steps=1,
                 start_cpu_core_id=0, num_microbatches=4,
                 schedule="gpipe"):
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"schedule must be 'gpipe' or '1f1b', got {schedule!r}")
        self._optimizer = optimizer
        self._cut_list = cut_list
        self._num_microbatches = int(num_microbatches)
        self._schedule = schedule

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .parallel.collectives import suppress_planning

        # the schedule owns the gradient flow: the flag-gated planner
        # must not bucket a program whose cuts are stamped after this
        with suppress_planning():
            out = self._optimizer.minimize(loss, startup_program,
                                           parameter_list, no_grad_set)
        cuts = []
        for c in self._cut_list or []:
            for v in (c if isinstance(c, (list, tuple)) else [c]):
                n = v.name if isinstance(v, Variable) else str(v)
                if n not in cuts:
                    cuts.append(n)
        if cuts:
            program = loss.block.program
            blk = loss.block
            bad = sorted({
                n for op in blk.ops
                if int(op.attrs.get("op_role", 0))
                & (OpRole.Backward | OpRole.Optimize | OpRole.LRSched) == 0
                for n in op.output_arg_names
                if blk.has_var(n) and getattr(blk.var(n), "persistable",
                                              False)})
            if bad:
                raise NotImplementedError(
                    f"PipelineOptimizer: the forward writes persistable "
                    f"vars {bad} — per-microbatch state writes (e.g. "
                    "train-mode batch_norm running stats) are not "
                    "supported under pipelining; use "
                    "batch_norm(use_global_stats=True) or move the op "
                    "out of the pipelined region")
            program._pipeline_cuts = cuts
            program._pipeline_microbatches = self._num_microbatches
            program._pipeline_schedule = self._schedule
            program._bump()
        return out

    def __getattr__(self, item):
        return getattr(self._optimizer, item)
