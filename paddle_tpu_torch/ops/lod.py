"""Dense tensor arrays, rank tables and the LoD split / merge family:
torch lowerings with the semantics of ``paddle_tpu/ops/lod.py``. An array is one dense [capacity,
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


# -- rank tables, split / merge and the array conversions (lod.py:75-207) ----
#
# A LoDRankTable is a dense [B, 2] int64 tensor of (row, length) sorted by
# descending length (stable), as in the JAX package; split / merge by a
# mask keep the rows in place (masked, not compacted).


@register_op("lod_rank_table", inputs=("X", "Length"), outputs=("Out",),
             stop_gradient=True)
def _lod_rank_table(ctx, op, ins):
    x = ins["X"][0]
    b = x.shape[0]
    if ins.get("Length"):
        lengths = ins["Length"][0].to(torch.int64).reshape(b)
    else:
        t = x.shape[1] if x.dim() > 1 else 1
        lengths = torch.full((b,), t, dtype=torch.int64, device=x.device)
    order = torch.argsort(-lengths, stable=True)
    return {"Out": [torch.stack([order, lengths[order]], 1)]}


def _order(ins):
    return ins["RankTable"][0][:, 0].long()


@register_op("reorder_lod_tensor_by_rank", inputs=("X", "RankTable"),
             outputs=("Out",), no_grad=("RankTable",))
def _reorder_by_rank(ctx, op, ins):
    return {"Out": [ins["X"][0].index_select(0, _order(ins))]}


@register_op("shrink_rnn_memory", inputs=("X", "RankTable", "I"),
             outputs=("Out",), no_grad=("RankTable", "I"))
def _shrink_rnn_memory(ctx, op, ins):
    """The reference keeps the first k rank-sorted rows still running
    at step I; the dense form zeroes the finished rows."""
    x = ins["X"][0]
    lengths = ins["RankTable"][0][:, 1]
    active = (lengths > _index(ins)).to(x.dtype)
    return {"Out": [x * active.reshape((-1,) + (1,) * (x.dim() - 1))]}


@register_op("rnn_memory_helper", inputs=("X",), outputs=("Out",))
def _rnn_memory_helper(ctx, op, ins):
    return {"Out": [ins["X"][0]]}


def _row_mask(mask, x):
    return mask.reshape(-1).bool().reshape((-1,) + (1,) * (x.dim() - 1))


@register_op("split_lod_tensor", inputs=("X", "Mask"),
             outputs=("OutTrue", "OutFalse"), no_grad=("Mask",))
def _split_lod_tensor(ctx, op, ins):
    x = ins["X"][0]
    m = _row_mask(ins["Mask"][0], x)
    z = torch.zeros_like(x)
    return {"OutTrue": [torch.where(m, x, z)],
            "OutFalse": [torch.where(m, z, x)]}


def _merge_lod(ctx, op, ins):
    t, f = ins["InTrue"][0], ins["InFalse"][0]
    return {"Out": [torch.where(_row_mask(ins["Mask"][0], t), t,
                                f.to(t.dtype))]}


register_op("merge_lod_tensor", inputs=("X", "Mask", "InTrue", "InFalse"),
            outputs=("Out",), no_grad=("X", "Mask"))(_merge_lod)
register_op("merge_lod_tensor_infer",
            inputs=("X", "Mask", "InTrue", "InFalse"), outputs=("Out",),
            no_grad=("X", "Mask"))(_merge_lod)


@register_op("array_to_lod_tensor", inputs=("X", "RankTable"),
             outputs=("Out",), no_grad=("RankTable",))
def _array_to_lod_tensor(ctx, op, ins):
    """A time-major [T, B, ...] array back to batch-major [B, T, ...],
    the rank-table order undone."""
    out = ins["X"][0].transpose(0, 1)
    if ins.get("RankTable"):
        out = out.index_select(0, torch.argsort(_order(ins)))
    return {"Out": [out]}


@register_op("lod_tensor_to_array", inputs=("X", "RankTable"),
             outputs=("Out",), no_grad=("RankTable",))
def _lod_tensor_to_array(ctx, op, ins):
    x = ins["X"][0]
    if ins.get("RankTable"):
        x = x.index_select(0, _order(ins))
    return {"Out": [x.transpose(0, 1)]}


@register_op("tensor_array_to_tensor", inputs=("X",),
             outputs=("Out", "OutIndex"))
def _tensor_array_to_tensor(ctx, op, ins):
    arr = ins["X"][0]
    axis = int(op.attrs.get("axis", 0))
    n = arr.shape[0]
    if bool(op.attrs.get("use_stack", False)):
        if axis < 0:
            axis += arr.dim()
        out = arr.movedim(0, axis) if axis else arr
        sizes = torch.ones((n,), dtype=torch.int32, device=arr.device)
    else:
        if axis < 0:
            axis += arr.dim() - 1
        out = torch.cat(list(arr.unbind(0)), dim=axis)
        sizes = torch.full((n,), arr.shape[1 + axis], dtype=torch.int32,
                           device=arr.device)
    return {"Out": [out], "OutIndex": [sizes]}


@register_op("select_input", inputs=("X", "Mask"), outputs=("Out",),
             no_grad=("Mask",))
def _select_input(ctx, op, ins):
    branches = ins["X"]
    i = min(max(_index(ins, "Mask"), 0), len(branches) - 1)
    return {"Out": [branches[i]]}


@register_op("select_output", inputs=("X", "Mask"), outputs=("Out",),
             no_grad=("Mask",))
def _select_output(ctx, op, ins):
    """X goes to output Mask; the other outputs are zeros (JAX's
    static-shape stance; the reference leaves them unset)."""
    x = ins["X"][0]
    i = _index(ins, "Mask")
    n = len(op.outputs.get("Out", [])) or 1
    return {"Out": [x if k == i else torch.zeros_like(x) for k in range(n)]}


@register_op("get_places", inputs=(), outputs=("Out",), stop_gradient=True)
def _get_places(ctx, op, ins):
    """``device_count`` places, or the executor's one device."""
    n = int(op.attrs.get("device_count", 0)) or 1
    return {"Out": [torch.arange(n, dtype=torch.int32, device=ctx.device)]}
