"""Callables of the ``py_func`` op: the port's copy of
``paddle_tpu/layers/py_func_registry.py``. The reference's py_func_op.cc
keeps a global vector of Python objects indexed by callable id; the op's
lowering (``ops/misc.py``) looks the id up here and calls it on the host
(a device-to-host copy of its inputs, then the callable, then its
results copied back to the run's device)."""

from __future__ import annotations

from typing import Callable, List

_CALLABLES: List[Callable] = []


def register_callable(fn: Callable) -> int:
    _CALLABLES.append(fn)
    return len(_CALLABLES) - 1


def get_callable(fid: int) -> Callable:
    return _CALLABLES[fid]


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Layer API (reference fluid.layers.py_func): run ``func`` on the
    host over ``x`` (numpy arrays), producing ``out``, Variables whose
    declared shapes and dtypes the op's attrs carry. ``backward_func(*x,
    *out_grads)`` returns a gradient a ``x``; without it, differentiating
    through the op raises."""
    from ..layer_helper import LayerHelper

    helper = LayerHelper("py_func")
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    attrs = {
        "forward_callable_id": register_callable(func),
        "out_shapes": [list(o.shape or ()) for o in outs],
        "out_dtypes": [str(o.dtype) for o in outs],
    }
    if backward_func is not None:
        attrs["backward_callable_id"] = register_callable(backward_func)
    helper.append_op(type="py_func", inputs={"X": list(xs)},
                     outputs={"Out": list(outs)}, attrs=attrs)
    return out
