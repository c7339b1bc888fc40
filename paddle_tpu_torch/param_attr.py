"""ParamAttr — per-parameter configuration.

The port's copy of ``paddle_tpu/param_attr.py`` (Fluid's
python/paddle/fluid/param_attr.py).
"""

from __future__ import annotations

from typing import Optional

from .initializer import Initializer, XavierInitializer, ConstantInitializer


class ParamAttr:
    def __init__(
        self,
        name: Optional[str] = None,
        initializer: Optional[Initializer] = None,
        learning_rate: float = 1.0,
        regularizer=None,
        trainable: bool = True,
        gradient_clip=None,
        do_model_average: bool = False,
        logical_axes=None,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average
        # logical axis names per dim ("embed", "mlp", ...), stamped on
        # the Parameter as the JAX package does (its partition rules map
        # them to mesh axes; the port does not shard yet)
        self.logical_axes = tuple(logical_axes) if logical_axes else None

    @staticmethod
    def _to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else ParamAttr(trainable=False)
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")


class WeightNormParamAttr(ParamAttr):
    """API-parity stub for weight normalization (reference
    param_attr.py WeightNormParamAttr)."""

    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
