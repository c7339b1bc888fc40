"""Gradient clipping: the port's copy of ``paddle_tpu/clip.py``
(Fluid's python/paddle/fluid/clip.py): ``GradientClipByValue``,
``GradientClipByNorm``, ``GradientClipByGlobalNorm``,
``ErrorClipByValue``, ``set_gradient_clip`` and
``append_gradient_clip_ops``, emitting the reference's ops.
``GradientClipByGlobalNorm._append_scale_op`` emits only the
global-norm factor, which the fused optimizer ops take as their
``ClipScale`` operand (the multiply then happens inside the K10 / K10m
pass)."""

from __future__ import annotations

__all__ = ["BaseGradientClipAttr", "GradientClipByValue",
           "GradientClipByNorm", "GradientClipByGlobalNorm",
           "ErrorClipByValue",
           "set_gradient_clip",
           "append_gradient_clip_ops"]

_global_clip = None


class BaseGradientClipAttr:
    def _append_clip_op(self, params_grads):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _append_clip_op(self, params_grads):
        from .layers.nn import clip as clip_layer

        return [(p, clip_layer(g, self.min, self.max)) for p, g in params_grads]


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _append_clip_op(self, params_grads):
        from .layers.nn import clip_by_norm

        return [(p, clip_by_norm(g, self.clip_norm)) for p, g in params_grads]


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _append_scale_op(self, params_grads):
        """Emit ONLY the global-norm scale factor, a scalar var:
        clip_norm / max(||g||, clip_norm) over every gradient."""
        from .layers.nn import (elementwise_div, elementwise_max,
                                reduce_sum, sqrt, square)
        from .layers.tensor import fill_constant, sums

        sq_sums = [reduce_sum(square(g)) for _, g in params_grads]
        total = sums(sq_sums) if len(sq_sums) > 1 else sq_sums[0]
        global_norm = sqrt(total)
        max_norm = fill_constant([], "float32", self.clip_norm)
        denom = elementwise_max(global_norm, max_norm)
        return elementwise_div(max_norm, denom)

    def _append_clip_op(self, params_grads):
        from .layers.nn import elementwise_mul

        factor = self._append_scale_op(params_grads)
        return [(p, elementwise_mul(g, factor, axis=-1)) for p, g in params_grads]


class ErrorClipByValue:
    """Clips the gradient of one variable (reference clip.py
    ``ErrorClipByValue``), attached as ``var.error_clip``.
    ``append_backward`` appends a ``clip`` op on the var's ``@GRAD`` right
    after the op that produces it, as the reference's
    ``error_clip_callback`` does, so the clipped error is what flows on
    to the ops before it. JAX's class is accepted and then ignored
    (``paddle_tpu/clip.py:72-79``: nothing reads ``error_clip``); the
    port does not copy that."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _append_clip_op(self, block, grad_name):
        from .core.framework import OpRole

        block.append_op(type="clip", inputs={"X": [grad_name]},
                        outputs={"Out": [grad_name]},
                        attrs={"min": self.min, "max": self.max,
                               "op_role": OpRole.Backward})


def set_gradient_clip(clip, param_list=None, program=None):
    """Set the clip every optimizer without its own ``grad_clip`` uses;
    with ``param_list``, also tag those parameters with it."""
    global _global_clip
    _global_clip = clip
    if param_list:
        for p in param_list:
            p.gradient_clip_attr = clip


def append_gradient_clip_ops(params_grads, optimizer_clip=None):
    clip = optimizer_clip or _global_clip
    # per-param attrs override the global clip
    per_attr = [getattr(p, "gradient_clip_attr", None) for p, _ in params_grads]
    if clip is None and not any(per_attr):
        return params_grads
    if clip is not None and not any(per_attr):
        return clip._append_clip_op(params_grads)
    out = []
    for (p, g), attr in zip(params_grads, per_attr):
        c = attr or clip
        if c is None:
            out.append((p, g))
        else:
            out.extend(c._append_clip_op([(p, g)]))
    return out
