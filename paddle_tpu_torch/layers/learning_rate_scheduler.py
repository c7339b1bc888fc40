"""LR schedules as in-graph ops over a persistable step counter (the
port's copy of ``paddle_tpu/layers/learning_rate_scheduler.py``).

Reference: python/paddle/fluid/layers/learning_rate_scheduler.py — each
schedule creates a global step counter var `@LR_DECAY_COUNTER@`
(created at 0, incremented once per executor run before it is read, so
the first step sees 1) and computes the lr from it with ops, so the
schedule travels with the Program (and with checkpoints).
"""

from __future__ import annotations

import math

from ..core.framework import default_main_program
from .control_flow import increment, less_than
from .nn import cast, ceil
from .nn import cos as cos_layer
from .nn import (elementwise_div, elementwise_max, elementwise_min,
                 elementwise_mul, exp, floor)
from .nn import pow as pow_layer
from .nn import scale, where
from .tensor import create_global_var, fill_constant

__all__ = [
    "noam_decay",
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
    "cosine_decay",
    "linear_lr_warmup",
]

_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _global_step():
    prog = default_main_program()
    gb = prog.global_block()
    if gb.has_var(_COUNTER_NAME):
        # counter already created+incremented this program
        return cast(gb.var(_COUNTER_NAME), "float32")
    counter = create_global_var(
        [1], 0, "float32", persistable=True, name=_COUNTER_NAME
    )
    increment(counter, value=1.0, in_place=True)
    return cast(counter, "float32")


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    step = _global_step()
    a = pow_layer(step, -0.5)
    b = elementwise_mul(step, fill_constant([1], "float32", warmup_steps ** -1.5))
    lr = scale(
        elementwise_min(a, b), scale=float(learning_rate) * (d_model ** -0.5)
    )
    return lr


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step()
    ratio = scale(step, scale=1.0 / decay_steps)
    if staircase:
        ratio = floor(ratio)
    return scale(elementwise_pow_const(decay_rate, ratio), scale=float(learning_rate))


def elementwise_pow_const(base, exponent_var):
    # base^x = exp(x * ln base)
    return exp(scale(exponent_var, scale=math.log(base)))


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step()
    ratio = scale(step, scale=1.0 / decay_steps)
    if staircase:
        ratio = floor(ratio)
    return scale(exp(scale(ratio, scale=-decay_rate)), scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _global_step()
    ratio = scale(step, scale=1.0 / decay_steps)
    if staircase:
        ratio = floor(ratio)
    denom = scale(ratio, scale=decay_rate, bias=1.0, bias_after_scale=True)
    return elementwise_div(fill_constant([1], "float32", learning_rate), denom)


def polynomial_decay(
    learning_rate, decay_steps, end_learning_rate=0.0001, power=1.0, cycle=False
):
    step = _global_step()
    if cycle:
        div = ceil(scale(step, scale=1.0 / decay_steps))
        div = elementwise_max(div, fill_constant([1], "float32", 1.0))
        decay_steps_var = scale(div, scale=float(decay_steps))
        frac = elementwise_div(step, decay_steps_var)
    else:
        capped = elementwise_min(step, fill_constant([1], "float32", decay_steps))
        frac = scale(capped, scale=1.0 / decay_steps)
    one_minus = scale(frac, scale=-1.0, bias=1.0)
    poly = pow_layer(one_minus, factor=power)
    return scale(poly, scale=learning_rate - end_learning_rate, bias=end_learning_rate)


def piecewise_decay(boundaries, values):
    step = _global_step()
    lr = fill_constant([1], "float32", values[-1])
    # select backwards so earlier boundaries win
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        c = less_than(step, fill_constant([1], "float32", float(b)))
        lr = where(c, fill_constant([1], "float32", v), lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _global_step()
    epoch = floor(scale(step, scale=1.0 / step_each_epoch))
    frac = scale(epoch, scale=math.pi / epochs)
    return scale(
        scale(cos_layer(frac), scale=0.5, bias=0.5, bias_after_scale=True),
        scale=float(learning_rate),
    )


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _global_step()
    warm_lr = scale(
        step, scale=(end_lr - start_lr) / warmup_steps, bias=start_lr
    )
    if not hasattr(learning_rate, "name"):
        learning_rate = fill_constant([1], "float32", float(learning_rate))
    c = less_than(step, fill_constant([1], "float32", float(warmup_steps)))
    return where(c, warm_lr, learning_rate)
