"""Dygraph ``Layer`` base class.

The port's counterpart of ``paddle_tpu/dygraph/layers.py`` (reference
python/paddle/fluid/dygraph/layers.py): parameter registration,
sublayers, ``state_dict`` (numpy values under keys such as
``0.weight``), ``set_dict`` / ``load_dict``, train / eval.

``Layer`` is a plain class, not a ``torch.nn.Module``: its
``parameters()`` is Paddle's (a list of VarBases, in registration
order), and there is no second registry to disagree with
``_parameters``.

Initial values: each parameter takes its own draw from the mode's one
parameter generator (``core.dygraph.param_generator``, seeded from
``default_startup_program().random_seed``), through the port's own
startup lowerings (``fill_constant``, ``uniform_random``,
``gaussian_random``, ``assign_value``). The JAX package runs each
initializer in a fresh one-op Program, so its draws repeat: two
``Linear(4, 4)`` start equal there (:135-151), and not here.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from ..core import dygraph as _mode
from ..core.framework import Program
from ..core.registry import LoweringContext, get_op_def
from ..initializer import ConstantInitializer, XavierInitializer
from ..param_attr import ParamAttr
from .base import VarBase, _PseudoOp, to_variable

__all__ = ["Layer"]


class _ParamContext(LoweringContext):
    """A lowering context whose every op draws from the mode's
    parameter generator, which each draw advances."""

    def op_generator(self, op):
        return _mode.param_generator()


def _materialize_init(init, shape, dtype):
    """The initializer's ops, appended to a scratch block, run through
    their lowerings on the eager device."""
    block = Program().global_block()
    var = block.create_var(name="__init__", shape=list(shape), dtype=dtype,
                           persistable=True)
    init(var, block)
    ctx = _ParamContext(_mode.eager_device())
    value = None
    for op in block.ops:
        pseudo = _PseudoOp(op.type, dict(op.attrs), dict(op.inputs),
                           dict(op.outputs))
        outs = get_op_def(op.type).lower(ctx, pseudo, {})
        value = outs["Out"][0]
    return value.detach().clone()


class Layer:
    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        self._parameters: "OrderedDict[str, VarBase]" = OrderedDict()
        self._sub_layers: "OrderedDict[str, Layer]" = OrderedDict()
        self._buffers: "OrderedDict[str, VarBase]" = OrderedDict()
        self._dtype = dtype
        self._full_name = name_scope or self.__class__.__name__.lower()
        self.training = True

    # -- parameter creation ---------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype="float32",
                         is_bias=False, default_initializer=None) -> VarBase:
        attr = ParamAttr._to_attr(attr)
        init = attr.initializer or default_initializer or (
            ConstantInitializer(0.0) if is_bias else XavierInitializer())
        value = _materialize_init(init, shape, dtype)
        return VarBase(value, name=attr.name, persistable=True,
                       stop_gradient=not attr.trainable)

    # -- attribute magic ------------------------------------------------------
    def __setattr__(self, name, value):
        if isinstance(value, VarBase) and getattr(value, "persistable", False):
            self.__dict__.setdefault("_parameters", OrderedDict())[name] = value
        elif isinstance(value, Layer):
            self.__dict__.setdefault("_sub_layers", OrderedDict())[name] = value
        object.__setattr__(self, name, value)

    # -- traversal ------------------------------------------------------------
    def parameters(self, include_sublayers=True):
        out = list(self._parameters.values())
        if include_sublayers:
            for sub in self._sub_layers.values():
                out.extend(sub.parameters())
        return out

    def named_parameters(self, prefix=""):
        for n, p in self._parameters.items():
            yield (f"{prefix}{n}", p)
        for ln, sub in self._sub_layers.items():
            yield from sub.named_parameters(prefix=f"{prefix}{ln}.")

    def sublayers(self, include_sublayers=True):
        out = list(self._sub_layers.values())
        if include_sublayers:
            for sub in self._sub_layers.values():
                out.extend(sub.sublayers())
        return out

    def add_sublayer(self, name, layer):
        self._sub_layers[name] = layer
        object.__setattr__(self, name, layer)
        return layer

    def add_parameter(self, name, param):
        self._parameters[name] = param
        object.__setattr__(self, name, param)
        return param

    def buffers(self):
        """The non-parameter state (BatchNorm's running statistics,
        SpectralNorm's u / v), this layer's and its sublayers'."""
        out = list(self._buffers.values())
        for sub in self._sub_layers.values():
            out.extend(sub.buffers())
        return out

    # -- mode -----------------------------------------------------------------
    def train(self):
        self.training = True
        for sub in self.sublayers():
            sub.training = True
        return self

    def eval(self):
        self.training = False
        for sub in self.sublayers():
            sub.training = False
        return self

    # -- state dict -----------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True, prefix=""):
        dest = destination if destination is not None else OrderedDict()
        for n, p in self._parameters.items():
            dest[f"{prefix}{n}"] = p.numpy()
        for n, b in self._buffers.items():
            dest[f"{prefix}{n}"] = b.numpy()
        if include_sublayers:
            for ln, sub in self._sub_layers.items():
                sub.state_dict(dest, True, prefix=f"{prefix}{ln}.")
        return dest

    def set_dict(self, state, include_sublayers=True, prefix=""):
        for n, p in list(self._parameters.items()) + list(
                self._buffers.items()):
            k = f"{prefix}{n}"
            if k in state:
                p.set_value(state[k])
        if include_sublayers:
            for ln, sub in self._sub_layers.items():
                sub.set_dict(state, True, prefix=f"{prefix}{ln}.")

    load_dict = set_dict

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    def full_name(self):
        return self._full_name

    # -- call -----------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        ins = [a if isinstance(a, (VarBase, Layer, type(None), str, int,
                                   float, bool)) else to_variable(a)
               for a in args]
        return self.forward(*ins, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError
