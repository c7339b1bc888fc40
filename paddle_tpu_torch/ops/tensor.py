"""Tensor creation / shape-manipulation ops: torch lowerings with the
semantics of ``paddle_tpu/ops/tensor.py`` (Fluid's fill_constant_op,
reshape_op, transpose_op, split_op, concat_op, lookup_table_op, ...),
with the embedding gradient as a ``SelectedRows`` under ``is_sparse``
and the two ops over one (``merge_selected_rows``,
``get_tensor_from_selected_rows``)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.executor import torch_dtype
from ..core.registry import register_op
from ..core.selected_rows import SelectedRows


def _xshape(ctx, op, x):
    """The XShape bookkeeping output (a zero-size placeholder, as in
    the reference), made only when something reads it."""
    if ctx.wants(op, "XShape"):
        return {"XShape": [torch.zeros((0,), dtype=x.dtype, device=x.device)]}
    return {}


@register_op("fill_constant", inputs=(), outputs=("Out",), stop_gradient=True)
def _fill_constant(ctx, op, ins):
    shape = tuple(int(s) for s in op.attrs.get("shape", []))
    dtype = torch_dtype(op.attrs.get("dtype", "float32"))
    value = op.attrs.get("value", 0.0)
    return {"Out": [torch.full(shape, value, dtype=dtype, device=ctx.device)]}


@register_op("fill_zeros_like", inputs=("X",), outputs=("Out",), stop_gradient=True)
def _fill_zeros_like(ctx, op, ins):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


@register_op("assign", inputs=("X",), outputs=("Out",))
def _assign(ctx, op, ins):
    """A copy: the fused and the sparse updates write their state in
    place, so a value assigned from a parameter (Lookahead's slow
    weights) must not share its storage."""
    return {"Out": [ins["X"][0].clone()]}


@register_op("assign_value", inputs=(), outputs=("Out",), stop_gradient=True)
def _assign_value(ctx, op, ins):
    # built once per op and kept: the causal masks of a 1024-token GPT
    # carry a million values each in their attrs
    def build():
        shape = tuple(int(s) for s in op.attrs.get("shape", []))
        dtype = torch_dtype(op.attrs.get("dtype", "float32"))
        values = op.attrs.get("values", op.attrs.get("fp32_values", []))
        arr = np.asarray(values).reshape(shape)
        return torch.as_tensor(arr).to(device=ctx.device, dtype=dtype)

    return {"Out": [ctx.constant(op, build)]}


def _infer_reshape(x, shape):
    shape = list(int(s) for s in shape)
    # reference reshape_op.cc: 0 means "copy this dim from x", -1 infers
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    return tuple(shape)


@register_op("reshape2", inputs=("X",), outputs=("Out", "XShape"))
def _reshape2(ctx, op, ins):
    x = ins["X"][0]
    out = x.reshape(_infer_reshape(x, op.attrs.get("shape", [])))
    return {"Out": [out], **_xshape(ctx, op, x)}


@register_op("transpose2", inputs=("X",), outputs=("Out", "XShape"))
def _transpose2(ctx, op, ins):
    x = ins["X"][0]
    perm = tuple(int(a) for a in op.attrs.get("axis", []))
    return {"Out": [x.permute(perm)], **_xshape(ctx, op, x)}


def _split_sizes(sections, n: int):
    """Fluid's ``sections`` over an axis of ``n``: one -1, last, takes
    the rest of the axis. The reference splits at
    ``np.cumsum(sections)[:-1]`` (``paddle_tpu/ops/tensor.py:120``),
    which agrees with Fluid only in that case; a -1 elsewhere or sizes
    that do not sum to the axis would silently give other sizes there,
    so they raise here."""
    sizes = [int(s) for s in sections]
    if -1 in sizes[:-1] or any(s < -1 for s in sizes):
        raise ValueError(f"split: sections {sizes} may hold one -1, as the "
                         "last entry, and no other negative size")
    if sizes[-1] == -1:
        sizes[-1] = n - sum(sizes[:-1])
    if sizes[-1] < 0 or sum(sizes) != n:
        raise ValueError(f"split: sections {[int(s) for s in sections]} do "
                         f"not sum to the axis's {n}")
    return sizes


@register_op("split", inputs=("X",), outputs=("Out",))
def _split(ctx, op, ins):
    x = ins["X"][0]
    axis = int(op.attrs.get("axis", 0))
    sections = op.attrs.get("sections", [])
    num = int(op.attrs.get("num", 0))
    if sections:
        outs = torch.split(x, _split_sizes(sections, x.shape[axis]),
                           dim=axis)
    else:
        outs = torch.split(x, x.shape[axis] // num, dim=axis)
    return {"Out": list(outs)}


@register_op("squeeze2", inputs=("X",), outputs=("Out", "XShape"))
def _squeeze2(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:169``: drop the listed size-1 axes
    (every size-1 axis when none is listed)."""
    x = ins["X"][0]
    axes = [int(a) % x.dim() for a in op.attrs.get("axes", [])]
    if not axes:
        return {"Out": [x.squeeze()], **_xshape(ctx, op, x)}
    for a in axes:
        if x.shape[a] != 1:
            raise ValueError(f"squeeze2: axis {a} of {tuple(x.shape)} is "
                             "not 1")
    out = x
    for a in sorted(axes, reverse=True):
        out = out.squeeze(a)
    return {"Out": [out], **_xshape(ctx, op, x)}


@register_op("unsqueeze2", inputs=("X",), outputs=("Out", "XShape"))
def _unsqueeze2(ctx, op, ins):
    x = ins["X"][0]
    out = x
    for a in sorted(int(a) for a in op.attrs.get("axes", [])):
        out = out.unsqueeze(a)
    return {"Out": [out], **_xshape(ctx, op, x)}


def _flat_ids(ids):
    # reference lookup_table_op.cc: Ids has trailing dim 1
    return ids.squeeze(-1) if ids.dim() > 1 and ids.shape[-1] == 1 else ids


def _lookup(op, w, ids):
    out = w[ids]
    pad = op.attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        out = torch.where((ids == pad)[..., None],
                          torch.zeros((), dtype=w.dtype, device=w.device), out)
    return {"Out": [out]}


@register_op("lookup_table", inputs=("W", "Ids"), outputs=("Out",), no_grad=("Ids",))
def _lookup_table(ctx, op, ins):
    return _lookup(op, ins["W"][0], _flat_ids(ins["Ids"][0]))


@register_op("lookup_table_v2", inputs=("W", "Ids"), outputs=("Out",),
             no_grad=("Ids",))
def _lookup_table_v2(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:240``: the ids keep their trailing
    dim."""
    return _lookup(op, ins["W"][0], ins["Ids"][0])


def _embedding_grad(op, ins, squeeze_trailing):
    """The gradient of both lookups (``paddle_tpu/ops/tensor.py:250``).
    ``is_sparse``: a SelectedRows of the flat ids and the output
    gradient's rows, padding rows zeroed. Else the dense scatter-add,
    deterministic: the rows are stably sorted by id and each id's rows
    summed in their original order by ``segment_reduce``, where
    ``index_add_`` on CUDA adds repeated ids with float atomics in
    whatever order they land."""
    w, ids, og = ins["W"][0], ins["Ids"][0], ins["Out@GRAD"][0]
    if squeeze_trailing:
        ids = _flat_ids(ids)
    flat_ids = ids.reshape(-1)
    flat_g = og.reshape(-1, og.shape[-1])
    pad = op.attrs.get("padding_idx", -1)
    if pad is not None and pad >= 0:
        flat_g = torch.where((flat_ids == pad)[:, None],
                             torch.zeros((), dtype=flat_g.dtype,
                                         device=flat_g.device), flat_g)
    grad = SelectedRows(flat_ids, flat_g.to(w.dtype), w.shape[0])
    if op.attrs.get("is_sparse", False):
        return {"W@GRAD": [grad]}
    return {"W@GRAD": [grad.to_dense()]}


@register_op(
    "lookup_table_grad",
    inputs=("W", "Ids", "Out@GRAD"),
    outputs=("W@GRAD",),
    stop_gradient=True,
)
def _lookup_table_grad(ctx, op, ins):
    return _embedding_grad(op, ins, squeeze_trailing=True)


@register_op(
    "lookup_table_v2_grad",
    inputs=("W", "Ids", "Out@GRAD"),
    outputs=("W@GRAD",),
    stop_gradient=True,
)
def _lookup_table_v2_grad(ctx, op, ins):
    return _embedding_grad(op, ins, squeeze_trailing=False)


@register_op("merge_selected_rows", inputs=("X",), outputs=("Out",),
             stop_gradient=True)
def _merge_selected_rows(ctx, op, ins):
    """Fluid's merge_selected_rows_op.cc: distinct rows, slices summed."""
    x = ins["X"][0]
    if not isinstance(x, SelectedRows):
        raise TypeError("merge_selected_rows needs a SelectedRows input, "
                        f"got {type(x).__name__}")
    return {"Out": [x.merge()]}


@register_op("get_tensor_from_selected_rows", inputs=("X",),
             outputs=("Out",), stop_gradient=True)
def _get_tensor_from_selected_rows(ctx, op, ins):
    """Fluid's get_tensor_from_selected_rows_op.cc: the dense tensor."""
    x = ins["X"][0]
    return {"Out": [x.to_dense() if isinstance(x, SelectedRows) else x]}


@register_op("concat", inputs=("X",), outputs=("Out",))
def _concat(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:109``."""
    return {"Out": [torch.cat(ins["X"], dim=int(op.attrs.get("axis", 0)))]}


@register_op("top_k", inputs=("X",), outputs=("Out", "Indices"))
def _top_k(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:330``: the k largest along the last
    axis, largest first, with int64 indices. Equal values keep
    ``jax.lax.top_k``'s order, the lower index first, and NaN sorts
    above every number as there: a stable descending sort does both
    (``torch.topk`` leaves the order of ties undefined)."""
    k = int(op.attrs.get("k", 1))
    vals, idx = torch.sort(ins["X"][0], dim=-1, descending=True, stable=True)
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}


@register_op("sign", inputs=("X",), outputs=("Out",))
def _sign(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:500``."""
    return {"Out": [torch.sign(ins["X"][0])]}


@register_op("where", inputs=("Condition", "X", "Y"), outputs=("Out",),
             no_grad=("Condition",))
def _where(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:373``: X where Condition, else Y."""
    return {"Out": [torch.where(ins["Condition"][0], ins["X"][0],
                                ins["Y"][0])]}


@register_op("increment", inputs=("X",), outputs=("Out",))
def _increment(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:407``: X + step in X's dtype. The
    learning-rate counter's op names the persistable counter as its
    output, so the Executor writes the new value into the scope."""
    x = ins["X"][0]
    step = op.attrs.get("step", 1.0)
    return {"Out": [x + (step if x.is_floating_point() else int(step))]}


# -- the everyday tensor ops (``paddle_tpu/ops/tensor.py``) ----------------


@register_op("fill_constant_batch_size_like", inputs=("Input",),
             outputs=("Out",), stop_gradient=True)
def _fill_constant_batch_size_like(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:26``: a constant of ``shape`` whose
    ``output_dim_idx`` takes Input's ``input_dim_idx``."""
    ref = ins["Input"][0]
    shape = [int(s) for s in op.attrs.get("shape", [])]
    shape[int(op.attrs.get("output_dim_idx", 0))] = ref.shape[
        int(op.attrs.get("input_dim_idx", 0))]
    dtype = torch_dtype(op.attrs.get("dtype", "float32"))
    return {"Out": [torch.full(tuple(shape), op.attrs.get("value", 0.0),
                               dtype=dtype, device=ref.device)]}


@register_op("shape", inputs=("Input",), outputs=("Out",), stop_gradient=True)
def _shape(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:55``: Input's shape as int32."""
    x = ins["Input"][0]
    return {"Out": [torch.tensor(tuple(x.shape), dtype=torch.int32,
                                 device=x.device)]}


@register_op("flatten2", inputs=("X",), outputs=("Out", "XShape"))
def _flatten2(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:84``: the dims before ``axis`` into
    one, the rest into the other."""
    x = ins["X"][0]
    axis = int(op.attrs.get("axis", 1))
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return {"Out": [x.reshape(lead, -1)], **_xshape(ctx, op, x)}


def _strided(x, axis, start, end, step):
    """``x[..., start:end:step, ...]`` on ``axis`` with Python's
    clamping; a negative step (which torch's slicing refuses) gathers
    the same indices."""
    idx = [slice(None)] * x.dim()
    if step > 0:
        idx[axis] = slice(start, end, step)
        return x[tuple(idx)]
    rows = range(*slice(start, end, step).indices(x.shape[axis]))
    return x.index_select(axis, torch.tensor(list(rows), dtype=torch.long,
                                             device=x.device))


@register_op("slice", inputs=("Input",), outputs=("Out",))
def _slice(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:128``: ``starts:ends`` on each of
    ``axes`` (negative from the end, clamped), then the
    ``decrease_axis`` dims squeezed."""
    out = ins["Input"][0]
    for a, s, e in zip(op.attrs.get("axes", []), op.attrs.get("starts", []),
                       op.attrs.get("ends", [])):
        out = _strided(out, int(a), int(s), int(e), 1)
    dec = op.attrs.get("decrease_axis")
    if dec:
        for a in sorted((int(a) for a in dec), reverse=True):
            if out.shape[a] != 1:
                raise ValueError(f"slice: decrease_axis {a} of "
                                 f"{tuple(out.shape)} is not 1")
            out = out.squeeze(a)
    return {"Out": [out]}


@register_op("strided_slice", inputs=("Input",), outputs=("Out",))
def _strided_slice(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:143``: ``starts:ends:strides`` on
    each of ``axes``."""
    out = ins["Input"][0]
    axes = [int(a) for a in op.attrs.get("axes", [])]
    strides = op.attrs.get("strides") or [1] * len(axes)
    for a, s, e, st in zip(axes, op.attrs.get("starts", []),
                           op.attrs.get("ends", []), strides):
        out = _strided(out, a, int(s), int(e), int(st))
    return {"Out": [out]}


@register_op("stack", inputs=("X",), outputs=("Y",))
def _stack(ctx, op, ins):
    return {"Y": [torch.stack(ins["X"], dim=int(op.attrs.get("axis", 0)))]}


@register_op("unstack", inputs=("X",), outputs=("Y",))
def _unstack(ctx, op, ins):
    return {"Y": list(torch.unbind(ins["X"][0],
                                   dim=int(op.attrs.get("axis", 0))))}


@register_op("expand", inputs=("X",), outputs=("Out",))
def _expand(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:185``: ``jnp.tile`` by
    ``expand_times``."""
    times = [int(t) for t in op.attrs.get("expand_times", [])]
    return {"Out": [torch.tile(ins["X"][0], times)]}


@register_op("expand_as", inputs=("X", "target_tensor"), outputs=("Out",),
             no_grad=("target_tensor",))
def _expand_as(ctx, op, ins):
    x, t = ins["X"][0], ins["target_tensor"][0]
    return {"Out": [torch.tile(x, [ts // xs for ts, xs in
                                   zip(t.shape, x.shape)])]}


@register_op("gather", inputs=("X", "Index"), outputs=("Out",),
             no_grad=("Index",))
def _gather(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:204``: rows of X along axis 0."""
    x, idx = ins["X"][0], ins["Index"][0]
    out = x.index_select(0, idx.reshape(-1).long())
    return {"Out": [out.reshape(tuple(idx.shape) + tuple(x.shape[1:]))]}


@register_op("gather_nd", inputs=("X", "Index"), outputs=("Out",),
             no_grad=("Index",))
def _gather_nd(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:210``: Index [..., k] addresses the
    first k dims of X."""
    x, idx = ins["X"][0], ins["Index"][0]
    return {"Out": [x[tuple(idx.long().unbind(-1))]]}


def _last_of_each_id(ids):
    """The positions of the last occurrence of each distinct id, in
    the order of the ids: a stable sort groups them, and the last of a
    group is the one before a change of id."""
    order = torch.argsort(ids, stable=True)
    srt = ids[order]
    last = torch.ones_like(srt, dtype=torch.bool)
    last[:-1] = srt[1:] != srt[:-1]
    return order[last]


@register_op("scatter", inputs=("X", "Ids", "Updates"), outputs=("Out",),
             no_grad=("Ids",))
def _scatter(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:219``: X with the rows of ``Ids``
    replaced by Updates (``overwrite``) or Updates added to them.

    A repeated id under ``overwrite`` takes its LAST update, on every
    device: the rows are first reduced to the last occurrence of each
    id (``_last_of_each_id``), so the copy writes each row once and a
    CUDA scatter has no race to lose. The overwritten updates get no
    gradient, as JAX's scatter gives them none. XLA:CPU writes repeated
    ids in order, so the JAX package agrees on the CPU. Adds with
    repeated ids sum them (``index_add``)."""
    x, ids, upd = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    ids = ids.reshape(-1).long()
    if op.attrs.get("overwrite", True):
        keep = _last_of_each_id(ids)
        return {"Out": [x.index_copy(0, ids[keep], upd[keep])]}
    return {"Out": [x.index_add(0, ids, upd)]}


def _one_hot_of(x, depth):
    """``jax.nn.one_hot``: float32 rows, all zero for an id outside
    [0, depth) (``F.one_hot`` raises there)."""
    return (x.long().unsqueeze(-1) == torch.arange(
        depth, device=x.device)).to(torch.float32)


@register_op("one_hot", inputs=("X",), outputs=("Out",), stop_gradient=True)
def _one_hot(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:315``: a trailing dim of 1 on the ids
    is dropped."""
    x = ins["X"][0]
    x = x.squeeze(-1) if x.dim() > 1 and x.shape[-1] == 1 else x
    return {"Out": [_one_hot_of(x, int(op.attrs.get("depth", 1)))]}


@register_op("one_hot_v2", inputs=("X",), outputs=("Out",),
             stop_gradient=True)
def _one_hot_v2(ctx, op, ins):
    return {"Out": [_one_hot_of(ins["X"][0], int(op.attrs.get("depth", 1)))]}


@register_op("arg_max", inputs=("X",), outputs=("Out",), stop_gradient=True)
def _arg_max(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:346``: the first maximum (NaN counts
    as the maximum, as in ``jnp.argmax``), int64."""
    x = ins["X"][0]
    axis = int(op.attrs.get("axis", -1))
    return {"Out": [torch.argmax(x, dim=axis,
                                 keepdim=bool(op.attrs.get("keepdims",
                                                           False)))]}


@register_op("arg_min", inputs=("X",), outputs=("Out",), stop_gradient=True)
def _arg_min(ctx, op, ins):
    x = ins["X"][0]
    return {"Out": [torch.argmin(x, dim=int(op.attrs.get("axis", -1)))]}


@register_op("argsort", inputs=("X",), outputs=("Out", "Indices"))
def _argsort(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:363``: a stable sort; descending is
    the ascending sort of -x, as JAX computes it, so ties keep their
    order and NaN goes LAST in both directions (``torch.argsort(
    descending=True)`` puts NaN first)."""
    x = ins["X"][0]
    axis = int(op.attrs.get("axis", -1))
    key = -x if op.attrs.get("descending", False) else x
    idx = torch.argsort(key, dim=axis, stable=True)
    return {"Out": [torch.take_along_dim(x, idx, dim=axis)],
            "Indices": [idx]}


@register_op("range", inputs=("Start", "End", "Step"), outputs=("Out",),
             stop_gradient=True)
def _range(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:378``: ``start + step * arange(n)``,
    n = ceil((end - start) / step); the bounds from the attrs, else from
    the inputs (read on the host: they set the output's length)."""
    def bound(key, slot):
        if key in op.attrs:
            return float(op.attrs[key])
        return float(ins[slot][0].reshape(()))

    s, e, st = bound("start", "Start"), bound("end", "End"), bound("step",
                                                                   "Step")
    dtype = (ins["Start"][0].dtype if ins.get("Start")
             else torch_dtype(op.attrs.get("dtype", "float32")))
    n = max(int(np.ceil((e - s) / st)), 0)
    return {"Out": [s + st * torch.arange(n, dtype=dtype,
                                          device=ctx.device)]}


@register_op("pad", inputs=("X",), outputs=("Out",))
def _pad(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:413``: ``paddings`` as (before, after)
    pairs from the first dim on, filled with ``pad_value``."""
    x = ins["X"][0]
    p = [int(v) for v in op.attrs.get("paddings", [])]
    pairs = list(zip(p[::2], p[1::2]))
    flat = [v for pair in reversed(pairs) for v in pair]
    return {"Out": [torch.nn.functional.pad(
        x, flat, value=float(op.attrs.get("pad_value", 0.0)))]}


@register_op("cumsum", inputs=("X",), outputs=("Out",))
def _cumsum(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:438``: ``reverse`` sums from the end;
    ``exclusive`` is the inclusive sum minus x, as JAX computes it."""
    x = ins["X"][0]
    axis = int(op.attrs.get("axis", -1))
    if op.attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), dim=axis),
                         (axis,))
    else:
        out = torch.cumsum(x, dim=axis)
    if op.attrs.get("exclusive", False):
        out = out - x
    return {"Out": [out]}
