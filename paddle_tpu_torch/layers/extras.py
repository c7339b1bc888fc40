"""The port's copy of the layers of ``paddle_tpu/layers/extras.py`` a
ported path calls: ``switch_moe`` (:478-535) and the reader sugar over
``reader.GeneratorLoader`` (``py_reader``, ``create_py_reader_by_data``,
``double_buffer``, ``read_file``; :399-437)."""

from __future__ import annotations

from ..core.framework import unique_name
from ..initializer import ConstantInitializer, XavierInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .nn import _out

__all__ = ["switch_moe", "py_reader", "create_py_reader_by_data",
           "double_buffer", "read_file"]


def switch_moe(input, num_experts, expert_hidden, capacity_factor=1.25,
               act="gelu", param_attr=None, bias_attr=None, name=None):
    """Switch-transformer MoE FFN (top-1 routing, capacity-bound
    dispatch; ``ops/moe.py``). Returns (out, aux_loss): add ``aux_coeff
    * aux_loss`` to the training loss for load balancing. Its five
    parameters take per-slot copies of the attrs, named ``<name>.gate``,
    ``.w1``, ``.w2`` and ``<bias name>.b1``, ``.b2``."""
    helper = LayerHelper("switch_moe", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)

    def _slot(base, suffix):
        # one shared attr would alias the five parameters once the first
        # create_parameter names it; bias_attr=False means no bias
        # elsewhere, but the op's biases are structural
        a = ParamAttr._to_attr(base if base is not False else None)
        a = ParamAttr(**a.__dict__.copy())
        if a.name is not None:
            a.name = f"{a.name}.{suffix}"
        return a

    d = int(input.shape[-1])
    e, f = int(num_experts), int(expert_hidden)
    wg = helper.create_parameter(
        _slot(helper.param_attr, "gate"), [d, e], input.dtype,
        default_initializer=XavierInitializer())
    w1 = helper.create_parameter(
        _slot(helper.param_attr, "w1"), [e, d, f], input.dtype,
        default_initializer=XavierInitializer())
    b1 = helper.create_parameter(
        _slot(helper.bias_attr, "b1"), [e, f], input.dtype, is_bias=True,
        default_initializer=ConstantInitializer(0.0))
    w2 = helper.create_parameter(
        _slot(helper.param_attr, "w2"), [e, f, d], input.dtype,
        default_initializer=XavierInitializer())
    b2 = helper.create_parameter(
        _slot(helper.bias_attr, "b2"), [e, d], input.dtype, is_bias=True,
        default_initializer=ConstantInitializer(0.0))
    # the tag expert parallelism shards by
    # (CompiledProgram.with_expert_parallel)
    for v in (w1, b1, w2, b2):
        v._moe_expert_param = True
    out = _out(helper, input, shape=input.shape)
    aux = _out(helper, input, shape=(1,))
    helper.append_op(
        type="switch_moe",
        inputs={"X": [input], "GateW": [wg], "ExpertW1": [w1],
                "ExpertB1": [b1], "ExpertW2": [w2], "ExpertB2": [b2]},
        outputs={"Out": [out], "AuxLoss": [aux]},
        attrs={"capacity_factor": float(capacity_factor), "act": act},
    )
    return out, aux


# -- io sugar over the reader machinery -----------------------------------

def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """Reference layers/io.py py_reader: a queue-fed reader. Data vars
    are created from ``shapes`` / ``dtypes`` (dim 0 the batch) and
    become the feed list of a ``reader.GeneratorLoader``, whose device
    prefetch is the double buffer."""
    from ..reader import GeneratorLoader
    from .io import data as data_layer

    feed_vars = []
    for i, (shape, dtype) in enumerate(zip(shapes, dtypes)):
        feed_vars.append(data_layer(
            unique_name.generate(f"{name or 'py_reader'}_slot{i}"),
            list(shape[1:]), dtype=dtype))
    return GeneratorLoader(feed_vars, capacity=capacity,
                           use_double_buffer=use_double_buffer)


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    from ..reader import GeneratorLoader

    return GeneratorLoader(feed_list, capacity=capacity,
                           use_double_buffer=use_double_buffer)


def double_buffer(reader, place=None, name=None):
    """The GeneratorLoader prefetches to the device already: the reader
    itself, for API parity."""
    return reader


def read_file(reader):
    """The feed vars a py_reader batches into (reference layers/io.py
    read_file returns the reader's output vars)."""
    if hasattr(reader, "feed_list"):
        fl = reader.feed_list
        return list(fl) if len(fl) > 1 else fl[0]
    raise TypeError("read_file expects a py_reader/GeneratorLoader")
