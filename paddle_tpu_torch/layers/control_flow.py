"""Control-flow layers: the port's copy of
``paddle_tpu/layers/control_flow.py`` (:1-300; Fluid's
python/paddle/fluid/layers/control_flow.py): ``increment``, the
comparisons, the dense tensor arrays, ``While``, ``Switch`` and
``cond``. ``While`` and each ``Switch`` case append a ``while`` /
``conditional_block`` op over a sub-block, which the Executor runs
through ``core/control_flow.py``; ``cond`` traces both branches and
selects with ``where``, as the JAX package does.

``StaticRNN`` and ``DynamicRNN`` (:304-654, the ``recurrent`` lowering
and ``ops/rnn.py``) are ROADMAP A11 and refused by name.
"""

from __future__ import annotations

import contextlib

from ..core.framework import default_main_program
from ..layer_helper import LayerHelper

__all__ = [
    "increment", "create_array", "array_write", "array_read", "array_length",
    "less_than", "less_equal", "greater_than", "greater_equal", "equal",
    "not_equal", "While", "Switch", "cond", "StaticRNN", "DynamicRNN",
]


def _compare(op_type, x, y, out=None):
    helper = LayerHelper(op_type)
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype="bool", shape=x.shape, stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def less_than(x, y, force_cpu=None, cond=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                        shape=x.shape)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def create_array(dtype, capacity, elem_shape):
    """A dense tensor array [capacity, *elem_shape] of zeros. Fluid's
    array grows on write; a dense one declares its capacity (the loop's
    trip count), as in JAX."""
    from .tensor import fill_constant

    helper = LayerHelper("create_array")
    # gradients flow through writes back to what was written
    out = helper.create_variable_for_type_inference(
        dtype=dtype, shape=(capacity,) + tuple(elem_shape),
        stop_gradient=False)
    return fill_constant([capacity] + list(elem_shape), dtype, 0.0, out=out)


def array_write(x, i, array=None, capacity=None):
    """A[i] = x (Fluid's tensor_array_read_write_op.cc write_to_array).
    ``array=None`` allocates a new array and needs ``capacity``."""
    helper = LayerHelper("array_write")
    inputs = {"X": [x], "I": [i]}
    if array is not None:
        inputs["Array"] = [array]
        out = array     # read-then-write of one name: a loop carry
    else:
        if capacity is None:
            raise ValueError(
                "array_write(array=None) needs an explicit capacity: dense "
                "tensor arrays are fixed-size (use create_array)")
        out = helper.create_variable_for_type_inference(
            dtype=x.dtype, shape=(capacity,) + tuple(x.shape or ()))
    helper.append_op(type="write_to_array", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"capacity": int(capacity or 0)})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference(
        dtype="int64", shape=(1,), stop_gradient=True)
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def array_read(array, i):
    """out = A[i] (Fluid's tensor_array_read_write_op.cc)."""
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(
        dtype=array.dtype, shape=tuple((array.shape or (1,))[1:]))
    helper.append_op(type="read_from_array", inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


@contextlib.contextmanager
def _sub_block(op_type, inputs, attrs):
    """Ops appended inside go to a new block; on exit one ``op_type`` op
    over it joins the parent block."""
    prog = default_main_program()
    parent = prog.current_block()
    sub = prog._create_block()
    try:
        yield
    finally:
        prog._rollback()
        parent.append_op(type=op_type, inputs=inputs, outputs={},
                         attrs={"sub_block": sub, **attrs})
        prog._bump()


class While:
    """Fluid's While::

        loop = While(cond_var)
        with loop.block():
            ...ops...
            layers.assign(new_cond, cond_var)

    The loop's state is what the block writes of the names that exist
    before it (``core/control_flow.py``)."""

    def __init__(self, cond, is_test=False, name=None):
        self.cond_var = cond
        self.helper = LayerHelper("while", name=name)

    def block(self):
        return _sub_block("while", {"Condition": [self.cond_var]},
                          {"is_test": False})


class Switch:
    """Fluid's Switch: the FIRST case whose condition holds runs; the
    default runs only when none did. Each case is a conditional_block
    whose predicate is (cond AND NOT any earlier case)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._matched = None    # bool var: an earlier case fired

    def _effective_cond(self, condition):
        helper = LayerHelper("switch_case")
        if self._matched is None:
            self._matched = condition
            return condition

        def new_bool():
            return helper.create_variable_for_type_inference(
                dtype="bool", shape=condition.shape, stop_gradient=True)

        not_prev = new_bool()
        helper.append_op(type="logical_not", inputs={"X": [self._matched]},
                         outputs={"Out": [not_prev]})
        eff = new_bool()
        helper.append_op(type="logical_and",
                         inputs={"X": [condition], "Y": [not_prev]},
                         outputs={"Out": [eff]})
        new_matched = new_bool()
        helper.append_op(type="logical_or",
                         inputs={"X": [self._matched], "Y": [condition]},
                         outputs={"Out": [new_matched]})
        self._matched = new_matched
        return eff

    def case(self, condition):
        return _sub_block("conditional_block",
                          {"Cond": [self._effective_cond(condition)]},
                          {"is_scalar_condition": True})

    def default(self):
        from .tensor import fill_constant

        return self.case(fill_constant([1], "bool", 1.0))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def cond(pred, true_fn=None, false_fn=None, name=None):
    """Both branches are traced and ``where`` selects (the later API's
    layers.cond, as the JAX package builds it). Branches return
    Variables of one shape."""
    from .nn import cast, where

    t = true_fn() if true_fn is not None else None
    f = false_fn() if false_fn is not None else None
    if t is None or f is None:
        return t if t is not None else f
    return where(cast(pred, "bool"), t, f)


class _NotPorted:
    _what = ""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"layers.{type(self).__name__} is not ported to paddle_tpu_torch "
            f"yet (ROADMAP A11: {self._what})")


class StaticRNN(_NotPorted):
    _what = "the recurrent op's lowering and ops/rnn.py"


class DynamicRNN(_NotPorted):
    _what = "the recurrent op's lowering over LoD sequences"
