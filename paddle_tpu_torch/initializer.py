"""Parameter initializers.

The port's copy of the initializers of ``paddle_tpu/initializer.py``
(Fluid's python/paddle/fluid/initializer.py): each appends an init op
(fill_constant / uniform_random / gaussian_random /
truncated_gaussian_random / assign_value) for the parameter into the
*startup program*; running the
startup program once materializes all parameters. The ops draw from a
per-op generator seeded from the op's identity (core/registry.py), so
two builds of one program initialize alike.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np

from .core.framework import Variable


class Initializer:
    def __call__(self, var: Variable, block) -> None:
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def __call__(self, var, block):
        block.append_op(
            type="fill_constant",
            outputs={"Out": [var]},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "value": self.value},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = float(low), float(high), int(seed)

    def __call__(self, var, block):
        block.append_op(
            type="uniform_random",
            outputs={"Out": [var]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "min": self.low,
                "max": self.high,
                "seed": self.seed,
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = float(loc), float(scale), int(seed)

    def __call__(self, var, block):
        block.append_op(
            type="gaussian_random",
            outputs={"Out": [var]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": self.loc,
                "std": self.scale,
                "seed": self.seed,
            },
        )


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = float(loc), float(scale), int(seed)

    def __call__(self, var, block):
        block.append_op(
            type="truncated_gaussian_random",
            outputs={"Out": [var]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": self.loc,
                "std": self.scale,
                "seed": self.seed,
            },
        )


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    elif len(shape) >= 3:
        rf = int(np.prod(shape[2:]))
        fan_in, fan_out = shape[1] * rf, shape[0] * rf
    else:
        fan_in = fan_out = int(np.prod(shape))
    return fan_in, fan_out


class XavierInitializer(Initializer):
    """Glorot. Reference initializer.py XavierInitializer."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.fan_out = fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """He/Kaiming. Reference initializer.py MSRAInitializer."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.seed = seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fi)
            NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """For upsampling deconv weights (reference BilinearInitializer):
    exact values, written by ``NumpyArrayInitializer``."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("BilinearInitializer expects 4-D weights")
        c_out, c_in, h, w = shape
        f = math.ceil(w / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype="float32")
        for i in range(int(np.prod(shape))):
            x = i % w
            y = (i // w) % h
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        NumpyArrayInitializer(weight)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value: np.ndarray):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op(
            type="assign_value",
            outputs={"Out": [var]},
            attrs={
                "shape": list(self.value.shape),
                "dtype": var.dtype,
                "values": self.value.reshape(-1).tolist(),
            },
        )


# reference-compatible aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer

_force_init_on_cpu = False


def force_init_on_cpu() -> bool:
    """True inside a ``with init_on_cpu():`` block (the reference's
    contract)."""
    return _force_init_on_cpu


@contextlib.contextmanager
def init_on_cpu():
    """Reference initializer.py ``init_on_cpu``, with JAX's contract
    (``paddle_tpu/initializer.py:184-207``): the guard flips the flag
    ``force_init_on_cpu()`` reads and moves nothing. The startup
    program's init ops run on the Executor's place, as every op does."""
    global _force_init_on_cpu
    prev = _force_init_on_cpu
    _force_init_on_cpu = True
    try:
        yield
    finally:
        _force_init_on_cpu = prev
