"""Dygraph learning-rate schedulers: the port's copy of
``paddle_tpu/dygraph/learning_rate_scheduler.py`` (pure Python).

Reference: python/paddle/fluid/dygraph/learning_rate_scheduler.py —
LearningRateDecay objects passed as `learning_rate=` to an optimizer;
each optimizer step calls the scheduler, which advances its internal
step counter and returns the current rate. The static-graph analogues
live in layers/learning_rate_scheduler.py (in-graph ops); eager mode
computes the rate host-side, matching the reference split.
"""

from __future__ import annotations

import math

__all__ = [
    "LearningRateDecay", "PiecewiseDecay", "NaturalExpDecay",
    "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
    "CosineDecay", "NoamDecay",
]


class LearningRateDecay:
    def __init__(self, begin=0, step=1):
        self.step_num = begin
        self.step_size = step

    def __call__(self):
        lr = self.step()
        self.step_num += self.step_size
        return float(lr)

    def step(self):
        raise NotImplementedError


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin=0, step=1):
        super().__init__(begin, step)
        self.boundaries = list(boundaries)
        self.values = list(values)

    def step(self):
        for b, v in zip(self.boundaries, self.values):
            if self.step_num < b:
                return v
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        t = self.step_num / self.decay_steps
        if self.staircase:
            t = math.floor(t)
        return self.lr * math.exp(-self.decay_rate * t)


class ExponentialDecay(NaturalExpDecay):
    def step(self):
        t = self.step_num / self.decay_steps
        if self.staircase:
            t = math.floor(t)
        return self.lr * (self.decay_rate ** t)


class InverseTimeDecay(NaturalExpDecay):
    def step(self):
        t = self.step_num / self.decay_steps
        if self.staircase:
            t = math.floor(t)
        return self.lr / (1.0 + self.decay_rate * t)


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=1e-4,
                 power=1.0, cycle=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr = learning_rate
        self.decay_steps = decay_steps
        self.end_lr = end_learning_rate
        self.power = power
        self.cycle = cycle

    def step(self):
        t = self.step_num
        steps = self.decay_steps
        if self.cycle:
            mult = max(1.0, math.ceil(t / steps) if t > 0 else 1.0)
            steps = steps * mult
        else:
            t = min(t, steps)
        frac = (1.0 - t / steps) ** self.power
        return (self.lr - self.end_lr) * frac + self.end_lr


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs,
                 begin=0, step=1):
        super().__init__(begin, step)
        self.lr = learning_rate
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs

    def step(self):
        epoch = math.floor(self.step_num / self.step_each_epoch)
        return self.lr * 0.5 * (math.cos(epoch * math.pi / self.epochs) + 1)


class NoamDecay(LearningRateDecay):
    def __init__(self, d_model, warmup_steps, begin=1, step=1):
        super().__init__(begin, step)
        self.d_model = d_model
        self.warmup_steps = warmup_steps

    def step(self):
        n = max(self.step_num, 1)
        a = n ** -0.5
        b = self.warmup_steps ** -1.5 * n
        return (self.d_model ** -0.5) * min(a, b)
