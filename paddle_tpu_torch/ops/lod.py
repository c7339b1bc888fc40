"""Dense tensor arrays: ``write_to_array``, ``read_from_array`` and
``lod_array_length``, torch lowerings with the semantics of
``paddle_tpu/ops/lod.py:41-72``. An array is one dense [capacity,
*elem] tensor (``layers.create_array``); a write makes a new one, so a
value read earlier keeps its contents, as JAX's
``dynamic_update_slice`` does. The index is a tensor read back to the
host once a call."""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _index(ins, slot="I") -> int:
    return int(ins[slot][0].reshape(()))


@register_op("write_to_array", inputs=("X", "I", "Array"), outputs=("Out",),
             no_grad=("I",))
def _write_to_array(ctx, op, ins):
    x = ins["X"][0]
    i = _index(ins)
    if ins.get("Array"):
        arr = ins["Array"][0]
    else:
        cap = int(op.attrs.get("capacity", 0)) or 1
        arr = torch.zeros((cap,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
    # dynamic_update_slice clamps the start index into range
    i = min(max(i, 0), arr.shape[0] - 1)
    out = arr.clone()
    out[i] = x.to(arr.dtype)
    return {"Out": [out]}


@register_op("read_from_array", inputs=("X", "I"), outputs=("Out",),
             no_grad=("I",))
def _read_from_array(ctx, op, ins):
    arr = ins["X"][0]
    i = min(max(_index(ins), 0), arr.shape[0] - 1)
    return {"Out": [arr[i]]}


@register_op("lod_array_length", inputs=("X",), outputs=("Out",),
             stop_gradient=True)
def _lod_array_length(ctx, op, ins):
    """The capacity: a dense array is fixed-size, so this is the grown
    length only for an array written to its end, as in JAX."""
    x = ins["X"][0]
    return {"Out": [torch.tensor([x.shape[0]], dtype=torch.int64,
                                 device=x.device)]}
