"""Probability distributions over Program variables: the port's copy of
``paddle_tpu/layers/distributions.py``.

Reference: python/paddle/fluid/layers/distributions.py:28-640
(Distribution / Uniform / Normal / Categorical / MultivariateNormalDiag),
Python classes composing graph ops; here over the port's layers. The
methods return Variables, so sampling, entropy and KL take part in the
Program like any other op (``Categorical.sample`` is ``sampling_id``,
drawn from the op's generator).
"""

from __future__ import annotations

import math

import numpy as np

from ..core.framework import Variable
from . import nn
from . import tensor as tensor_layers
from .control_flow import less_than
from .tensor import uniform_random, gaussian_random


def _to_var(v, like=None):
    if isinstance(v, Variable):
        return v
    arr = np.asarray(v, dtype="float32")
    return tensor_layers.assign(arr)


class Distribution:
    """Reference distributions.py:28."""

    def sample(self, shape, seed=0):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError


class Uniform(Distribution):
    """U(low, high); reference distributions.py:113."""

    def __init__(self, low, high):
        self.low = _to_var(low)
        self.high = _to_var(high)

    def sample(self, shape, seed=0):
        u = uniform_random(list(shape), min=0.0, max=1.0, seed=seed)
        return nn.elementwise_add(
            nn.elementwise_mul(u, nn.elementwise_sub(self.high, self.low)),
            self.low,
        )

    def log_prob(self, value):
        rng = nn.elementwise_sub(self.high, self.low)
        lb = nn.cast(less_than(self.low, value), "float32")
        ub = nn.cast(less_than(value, self.high), "float32")
        return nn.log(nn.elementwise_div(nn.elementwise_mul(lb, ub), rng))

    def entropy(self):
        return nn.log(nn.elementwise_sub(self.high, self.low))


class Normal(Distribution):
    """N(loc, scale); reference distributions.py:247."""

    def __init__(self, loc, scale):
        self.loc = _to_var(loc)
        self.scale = _to_var(scale)

    def sample(self, shape, seed=0):
        z = gaussian_random(list(shape), mean=0.0, std=1.0, seed=seed)
        return nn.elementwise_add(nn.elementwise_mul(z, self.scale), self.loc)

    def entropy(self):
        c = 0.5 + 0.5 * math.log(2.0 * math.pi)
        return nn.scale(nn.log(self.scale), scale=1.0, bias=c)

    def log_prob(self, value):
        var = nn.elementwise_mul(self.scale, self.scale)
        d = nn.elementwise_sub(value, self.loc)
        return nn.scale(
            nn.elementwise_add(
                nn.elementwise_div(nn.elementwise_mul(d, d), nn.scale(var, 2.0)),
                nn.scale(nn.log(self.scale), 1.0, bias=0.5 * math.log(2.0 * math.pi)),
            ),
            -1.0,
        )

    def kl_divergence(self, other):
        # KL(self || other), reference distributions.py:382
        var_ratio = nn.elementwise_div(self.scale, other.scale)
        var_ratio = nn.elementwise_mul(var_ratio, var_ratio)
        d = nn.elementwise_div(
            nn.elementwise_sub(self.loc, other.loc), other.scale
        )
        t1 = nn.elementwise_mul(d, d)
        return nn.scale(
            nn.elementwise_sub(
                nn.elementwise_add(var_ratio, t1),
                nn.scale(nn.log(var_ratio), 1.0, bias=1.0),
            ),
            0.5,
        )


class Categorical(Distribution):
    """Categorical over logits; reference distributions.py:400."""

    def __init__(self, logits):
        self.logits = logits

    def _probs(self):
        return nn.softmax(self.logits)

    def entropy(self):
        p = self._probs()
        logp = nn.log(nn.elementwise_add(p, tensor_layers.fill_constant(
            [1], "float32", 1e-12)))
        neg = nn.reduce_sum(nn.elementwise_mul(p, logp), dim=-1)
        return nn.scale(neg, -1.0)

    def log_prob(self, value):
        ls = nn.log_softmax(self.logits)
        depth = int(self.logits.shape[-1])
        oh = nn.one_hot(value, depth)
        return nn.reduce_sum(nn.elementwise_mul(ls, oh), dim=-1)

    def kl_divergence(self, other):
        p = self._probs()
        eps = tensor_layers.fill_constant([1], "float32", 1e-12)
        logp = nn.log(nn.elementwise_add(p, eps))
        logq = nn.log(nn.elementwise_add(other._probs(), eps))
        return nn.reduce_sum(
            nn.elementwise_mul(p, nn.elementwise_sub(logp, logq)), dim=-1
        )

    def sample(self, shape=None, seed=0):
        return nn.sampling_id(self._probs(), seed=seed)


class MultivariateNormalDiag(Distribution):
    """Diagonal-covariance multivariate normal; reference
    distributions.py:503 (loc [k], scale diag matrix [k, k])."""

    def __init__(self, loc, scale):
        self.loc = _to_var(loc)
        self.scale = _to_var(scale)  # [k, k] diagonal matrix

    def _diag(self):
        k = self.scale.shape[-1]
        eye = tensor_layers.assign(np.eye(k, dtype="float32"))
        return nn.reduce_sum(nn.elementwise_mul(self.scale, eye), dim=-1)

    def entropy(self):
        d = self._diag()
        k = float(self.scale.shape[-1])
        logdet = nn.reduce_sum(nn.log(d), dim=-1)
        return nn.scale(logdet, 0.5, bias=0.5 * k * (1.0 + math.log(2.0 * math.pi)))

    def kl_divergence(self, other):
        d1, d2 = self._diag(), other._diag()
        k = float(self.scale.shape[-1])
        tr = nn.reduce_sum(nn.elementwise_div(d1, d2), dim=-1)
        dl = nn.elementwise_sub(other.loc, self.loc)
        maha = nn.reduce_sum(
            nn.elementwise_div(nn.elementwise_mul(dl, dl), d2), dim=-1
        )
        logdet = nn.elementwise_sub(
            nn.reduce_sum(nn.log(d2), dim=-1), nn.reduce_sum(nn.log(d1), dim=-1)
        )
        return nn.scale(
            nn.elementwise_add(nn.elementwise_add(tr, maha),
                               nn.scale(logdet, 1.0, bias=-k)),
            0.5,
        )
