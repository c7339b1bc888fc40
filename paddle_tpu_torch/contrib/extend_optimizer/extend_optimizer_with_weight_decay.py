"""Decoupled weight decay as an optimizer mixin: the port's copy of
``paddle_tpu/contrib/extend_optimizer/extend_optimizer_with_weight_decay.py``
(reference python/paddle/fluid/contrib/extend_optimizer/
extend_optimizer_with_weight_decay.py:20,102). It wraps any Optimizer
subclass so that parameters decay by coeff * param before the base
update (AdamW-style), not through the gradient.

The shrink is two ops before the update (``scale``, then an in-place
``elementwise_sub`` on the parameter); the update stays the base
optimizer's own. Where the base is Adam or Momentum and the
``optimizer_fuse`` flag is on (the default on a card), that update is
the one-pass ``fused_adam`` / ``fused_momentum`` op (K10 / K10m), as for
the base class itself: the extended class fuses where its base would.
"""

from __future__ import annotations

from ... import optimizer as _optimizer_module


class DecoupledWeightDecay:
    """Mixin (reference :20). The extended class's __init__ takes
    weight_decay first, then the base optimizer's arguments."""

    def __init__(self, coeff=0.0, apply_decay_param_fun=None, **kwargs):
        if not isinstance(coeff, (float, int)):
            raise TypeError("coeff should be float or int")
        self._coeff = float(coeff)
        self._apply_decay_param_fun = apply_decay_param_fun
        super().__init__(**kwargs)

    def _scale_parameters(self, params_and_grads):
        """``param * coeff`` for every decayed parameter (reference
        :30)."""
        if self._coeff == 0.0:
            return []
        from ...layers import scale

        scaled = []
        for p, g in params_and_grads:
            if g is None:
                continue
            if (self._apply_decay_param_fun is not None
                    and not self._apply_decay_param_fun(p.name)):
                continue
            scaled.append((p, scale(p, scale=self._coeff)))
        return scaled

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        # the base minimize() creates the learning-rate var; composing
        # backward and apply_optimize directly must too
        self._create_global_learning_rate()
        params_grads = self.backward(
            loss, startup_program=startup_program,
            parameter_list=parameter_list, no_grad_set=no_grad_set)
        scaled = self._scale_parameters(params_grads)
        if scaled:
            from ...layer_helper import LayerHelper

            helper = LayerHelper("decoupled_weight_decay")
            for p, decay in scaled:
                # p <- p - coeff * p, decoupled from the gradient path
                helper.append_op(
                    type="elementwise_sub",
                    inputs={"X": [p], "Y": [decay]},
                    outputs={"Out": [p]},
                    attrs={"axis": -1},
                )
        opt_ops = self.apply_optimize(
            loss, startup_program=startup_program,
            params_grads=params_grads)
        return opt_ops, params_grads

    def __str__(self):
        return f"{self.__class__.__name__} (coeff={self._coeff})"


def extend_with_decoupled_weight_decay(base_optimizer):
    """Reference :102: a class whose minimize() also applies decoupled
    weight decay.

        AdamW = extend_with_decoupled_weight_decay(fluid.optimizer.Adam)
        optimizer = AdamW(weight_decay=0.01, learning_rate=1e-3)
    """
    if not issubclass(base_optimizer, _optimizer_module.Optimizer):
        raise TypeError(
            "The input(base_optimizer) should be a derived class of "
            "Optimizer.")

    class OptimizerWithDecoupledWeightDecay(DecoupledWeightDecay,
                                            base_optimizer):
        # the update is the base's: fuse it where the base's would be
        _update_type = base_optimizer.__name__

        def __init__(self, weight_decay, apply_decay_param_fun=None,
                     **kwargs):
            super().__init__(weight_decay, apply_decay_param_fun, **kwargs)

    OptimizerWithDecoupledWeightDecay.__name__ = (
        f"{base_optimizer.__name__}WithDecoupledWeightDecay")
    return OptimizerWithDecoupledWeightDecay
