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


# -- sequence helpers (paddle_tpu/ops/tensor.py:644-741) ---------------------


@register_op("gather_tree", inputs=("Ids", "Parents"), outputs=("Out",),
             stop_gradient=True)
def _gather_tree(ctx, op, ins):
    """Beam parents walked back, keeping the [T, B, beam] layout."""
    from .beam import backtrack

    return {"Out": [backtrack(ins["Ids"][0], ins["Parents"][0])]}


@register_op("max_sequence_len", inputs=("RankTable",), outputs=("Out",),
             stop_gradient=True)
def _max_sequence_len(ctx, op, ins):
    """The dense form's padded time axis is the longest length."""
    x = ins["RankTable"][0]
    n = x.shape[1] if x.dim() > 1 else x.shape[0]
    return {"Out": [torch.tensor(n, dtype=torch.int32, device=x.device)]}


@register_op("lod_reset", inputs=("X", "Y"), outputs=("Out",), no_grad=("Y",))
def _lod_reset(ctx, op, ins):
    """Dense data carries no LoD: X passes through."""
    return {"Out": [ins["X"][0]]}


@register_op("ctc_align", inputs=("Input", "InputLength"),
             outputs=("Output", "OutputLength"), stop_gradient=True)
def _ctc_align(ctx, op, ins):
    """CTC decode alignment: repeats merged, blanks dropped, survivors
    moved to the front; the new lengths alongside (int32)."""
    from .sequence import _compact

    x = ins["Input"][0]
    blank = int(op.attrs.get("blank", 0))
    B, T = x.shape
    ln = (ins["InputLength"][0].reshape(-1) if ins.get("InputLength")
          else torch.full((B,), T, dtype=torch.int32, device=x.device))
    in_seq = torch.arange(T, device=x.device)[None, :] < ln[:, None]
    prev = torch.cat([torch.full((B, 1), -1, dtype=x.dtype, device=x.device),
                      x[:, :-1]], dim=1)
    out, new_len = _compact(x, in_seq & (x != blank) & (x != prev),
                            torch.int32)
    return {"Output": [out], "OutputLength": [new_len]}


# -- the rest of paddle_tpu/ops/tensor.py -------------------------------------


@register_op("reshape", inputs=("X",), outputs=("Out",))
def _reshape(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:78``: reshape2 without XShape."""
    x = ins["X"][0]
    return {"Out": [x.reshape(_infer_reshape(x, op.attrs.get("shape", [])))]}


@register_op("transpose", inputs=("X",), outputs=("Out",))
def _transpose(ctx, op, ins):
    """``paddle_tpu/ops/tensor.py:102``."""
    perm = tuple(int(a) for a in op.attrs.get("axis", []))
    return {"Out": [ins["X"][0].permute(perm)]}


@register_op("tile", inputs=("X",), outputs=("Out",))
def _tile(ctx, op, ins):
    """``jnp.tile`` (:199): ``torch.tile`` has numpy's rule for repeats
    shorter or longer than the rank."""
    reps = [int(t) for t in op.attrs.get("repeat_times", [])]
    return {"Out": [torch.tile(ins["X"][0], reps)]}


@register_op("top_k_v2", inputs=("X",), outputs=("Out", "Indices"))
def _top_k_v2(ctx, op, ins):
    """:338: ``top_k`` (``jax.lax.top_k``'s order of ties)."""
    return _top_k(ctx, op, ins)


@register_op("pad2d", inputs=("X",), outputs=("Out",))
def _pad2d(ctx, op, ins):
    """:423: NCHW, ``paddings`` (top, bottom, left, right); ``constant``
    with ``pad_value``, ``reflect`` (the edge row not repeated) or
    ``edge``."""
    x = ins["X"][0]
    p = [int(v) for v in op.attrs.get("paddings", [0, 0, 0, 0])]
    mode = op.attrs.get("mode", "constant")
    flat = [p[2], p[3], p[0], p[1]]
    if mode == "constant":
        return {"Out": [torch.nn.functional.pad(
            x, flat, value=float(op.attrs.get("pad_value", 0.0)))]}
    return {"Out": [torch.nn.functional.pad(
        x, flat, mode="reflect" if mode == "reflect" else "replicate")]}


@register_op("shard_index", inputs=("X",), outputs=("Out",),
             stop_gradient=True)
def _shard_index(ctx, op, ins):
    """:450 (shard_index_op.cc): a global class id to its shard's local
    id, ``ignore_value`` outside the shard; floor division and modulo,
    as ``//`` and ``%`` of jnp."""
    x = ins["X"][0]
    nshards = int(op.attrs["nshards"])
    per = (int(op.attrs["index_num"]) + nshards - 1) // nshards
    in_shard = torch.div(x, per, rounding_mode="floor") == int(
        op.attrs["shard_id"])
    return {"Out": [torch.where(in_shard, torch.remainder(x, per),
                                torch.full_like(x, int(op.attrs.get(
                                    "ignore_value", -1))))]}


@register_op("size", inputs=("Input",), outputs=("Out",), stop_gradient=True)
def _size(ctx, op, ins):
    """:464: the element count, an int64 0-dim tensor."""
    x = ins["Input"][0]
    return {"Out": [torch.tensor(x.numel(), dtype=torch.int64,
                                 device=x.device)]}


@register_op("diag", inputs=("Diagonal",), outputs=("Out",))
def _diag(ctx, op, ins):
    """:474 (``jnp.diag``): a vector to its diagonal matrix, a matrix to
    its diagonal."""
    return {"Out": [torch.diag(ins["Diagonal"][0])]}


@register_op("linspace", inputs=("Start", "Stop", "Num"), outputs=("Out",),
             stop_gradient=True)
def _linspace(ctx, op, ins):
    """:479: ``num`` points from Start to Stop, computed as
    ``jnp.linspace`` computes them: ``start * (1 - s) + stop * s`` with s
    = i / (num - 1), the last point Stop itself. The count sets the
    shape, so it is read on the host (the attr, else the Num input)."""
    n = (int(op.attrs["num"]) if "num" in op.attrs
         else int(ins["Num"][0].reshape(())))
    start = ins["Start"][0]
    dt = start.dtype
    cdt = dt if dt.is_floating_point else torch.float32
    s = start.reshape(()).to(cdt)
    e = ins["Stop"][0].reshape(()).to(cdt)
    if n > 1:
        step = (torch.arange(n - 1, dtype=torch.float32, device=s.device)
                / float(n - 1)).to(cdt)
        out = torch.cat([s * (1 - step) + e * step, e.reshape(1)])
    else:
        out = s.reshape(1)[:n]
    if not dt.is_floating_point:
        out = torch.floor(out)
    return {"Out": [out.to(dt)]}


@register_op("eye", inputs=(), outputs=("Out",), stop_gradient=True)
def _eye(ctx, op, ins):
    """:505."""
    n = int(op.attrs["num_rows"])
    m = int(op.attrs.get("num_columns", -1))
    return {"Out": [torch.eye(n, m if m > 0 else n, device=ctx.device,
                              dtype=torch_dtype(op.attrs.get(
                                  "dtype", "float32")))]}


@register_op("fill", inputs=(), outputs=("Out",), stop_gradient=True)
def _fill(ctx, op, ins):
    """:513 (fill_op.cc): the listed values in ``shape``."""
    shape = tuple(int(s) for s in op.attrs["shape"])
    vals = torch.as_tensor(np.asarray(list(op.attrs["value"])),
                           dtype=torch_dtype(op.attrs.get("dtype",
                                                          "float32")))
    return {"Out": [vals.reshape(shape).to(ctx.device)]}


@register_op("fill_any_like", inputs=("X",), outputs=("Out",),
             stop_gradient=True)
def _fill_any_like(ctx, op, ins):
    """:522."""
    return {"Out": [torch.full_like(ins["X"][0], op.attrs.get("value", 0.0))]}


@register_op("reverse", inputs=("X",), outputs=("Out",))
def _reverse(ctx, op, ins):
    """:529."""
    axes = tuple(int(a) for a in op.attrs.get("axis", [0]))
    return {"Out": [torch.flip(ins["X"][0], axes)]}


def _host_ints(t):
    return [int(v) for v in t.reshape(-1).tolist()]


def _crop_to(x, shape, off):
    return x[tuple(slice(o, o + s) for o, s in zip(off, shape))]


@register_op("crop", inputs=("X", "Y", "Offsets"), outputs=("Out",),
             no_grad=("Y", "Offsets"))
def _crop(ctx, op, ins):
    """:538: the window of Y's shape (else the ``shape`` attr) at
    Offsets (else the ``offsets`` attr); Offsets is read on the host."""
    x = ins["X"][0]
    shape = (tuple(ins["Y"][0].shape) if ins.get("Y")
             else [int(s) for s in op.attrs["shape"]])
    off = (_host_ints(ins["Offsets"][0]) if ins.get("Offsets")
           else [int(v) for v in op.attrs.get("offsets", [0] * x.dim())])
    return {"Out": [_crop_to(x, shape, off)]}


@register_op("crop_tensor", inputs=("X", "Shape", "Offsets"), outputs=("Out",),
             no_grad=("Shape", "Offsets"))
def _crop_tensor(ctx, op, ins):
    """:553: as ``crop``, the shape from the Shape tensor or the attr; a
    -1 takes the rest of the dim past its offset."""
    x = ins["X"][0]
    shape = (_host_ints(ins["Shape"][0]) if ins.get("Shape")
             else [int(s) for s in op.attrs["shape"]])
    off = (_host_ints(ins["Offsets"][0]) if ins.get("Offsets")
           else [int(v) for v in op.attrs.get("offsets", [0] * x.dim())])
    shape = [x.shape[i] - off[i] if s == -1 else s
             for i, s in enumerate(shape)]
    return {"Out": [_crop_to(x, shape, off)]}


@register_op("pad_constant_like", inputs=("X", "Y"), outputs=("Out",),
             no_grad=("X",))
def _pad_constant_like(ctx, op, ins):
    """:569: Y padded at the end of each dim up to X's shape."""
    x, y = ins["X"][0], ins["Y"][0]
    flat = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        flat += [0, xs - ys]
    return {"Out": [torch.nn.functional.pad(
        y, flat, value=float(op.attrs.get("pad_value", 0.0)))]}


@register_op("multiplex", inputs=("Ids", "X"), outputs=("Out",),
             no_grad=("Ids",))
def _multiplex(ctx, op, ins):
    """:578: row i of X[Ids[i]]."""
    ids = ins["Ids"][0].reshape(-1).long()
    stacked = torch.stack(ins["X"], dim=0)
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return {"Out": [stacked[ids, rows]]}


def _column_window(x, start, length):
    s = start if start >= 0 else x.shape[1] + start
    return x[:, s:(x.shape[1] if length < 0 else s + length)]


@register_op("partial_concat", inputs=("X",), outputs=("Out",))
def _partial_concat(ctx, op, ins):
    """:587: columns [start, start + length) of each input, joined."""
    start = int(op.attrs.get("start_index", 0))
    length = int(op.attrs.get("length", -1))
    return {"Out": [torch.cat([_column_window(x, start, length)
                               for x in ins["X"]], dim=1)]}


@register_op("partial_sum", inputs=("X",), outputs=("Out",))
def _partial_sum(ctx, op, ins):
    """:601: the same windows, summed in input order."""
    start = int(op.attrs.get("start_index", 0))
    length = int(op.attrs.get("length", -1))
    tot = None
    for x in ins["X"]:
        w = _column_window(x, start, length)
        tot = w if tot is None else tot + w
    return {"Out": [tot]}


@register_op("is_empty", inputs=("X",), outputs=("Out",), stop_gradient=True)
def _is_empty(ctx, op, ins):
    """:614: a 0-dim bool."""
    x = ins["X"][0]
    return {"Out": [torch.tensor(x.numel() == 0, device=x.device)]}


def _unique_padded(x, counts):
    """``jnp.unique(x, size=|x|, fill_value=0)``: the sorted distinct
    values, then zeros up to |x| (the static shape JAX needs; the
    reference returns the shrunk array), the int32 index of each element
    into them and, with ``counts``, their counts padded with 0."""
    x = x.reshape(-1)
    n = x.shape[0]
    if x.is_meta:       # shape inference: the padded shapes alone
        uniq, inv, cnt = x, x.to(torch.int64), x.to(torch.int64)
    else:
        uniq, inv, cnt = torch.unique(x, sorted=True, return_inverse=True,
                                      return_counts=True)
    pad = n - uniq.shape[0]
    out = {"Out": [torch.cat([uniq, uniq.new_zeros(pad)])],
           "Index": [inv.to(torch.int32)]}
    if counts:
        out["Count"] = [torch.cat([cnt, cnt.new_zeros(pad)]).to(torch.int32)]
    return out


@register_op("unique", inputs=("X",), outputs=("Out", "Index"),
             stop_gradient=True)
def _unique(ctx, op, ins):
    """:619."""
    return _unique_padded(ins["X"][0], False)


@register_op("unique_with_counts", inputs=("X",),
             outputs=("Out", "Index", "Count"), stop_gradient=True)
def _unique_with_counts(ctx, op, ins):
    """:628."""
    return _unique_padded(ins["X"][0], True)


@register_op("scatter_nd_add", inputs=("X", "Index", "Updates"),
             outputs=("Out",), no_grad=("Index",))
def _scatter_nd_add(ctx, op, ins):
    """:638: ``x.at[index].add(updates)``, Index's last dim addressing
    X's leading dims; repeated indices add up."""
    x, idx, upd = ins["X"][0], ins["Index"][0].long(), ins["Updates"][0]
    keys = tuple(idx[..., k] for k in range(idx.shape[-1]))
    return {"Out": [torch.index_put(x, keys, upd.to(x.dtype),
                                    accumulate=True)]}


def _seed_out(ctx, ins):
    return (ins["Seed"][0] if ins.get("Seed")
            else torch.zeros((1,), dtype=torch.int32, device=ctx.device))


@register_op("shuffle_batch", inputs=("X", "Seed"),
             outputs=("Out", "ShuffleIdx", "SeedOut"), stop_gradient=True)
def _shuffle_batch(ctx, op, ins):
    """:675: the rows in an order drawn from the op's generator."""
    x = ins["X"][0]
    perm = torch.randperm(x.shape[0], generator=ctx.op_generator(op),
                          device=ctx.device)
    return {"Out": [x[perm]], "ShuffleIdx": [perm.to(torch.int32)],
            "SeedOut": [_seed_out(ctx, ins)]}


@register_op("random_crop", inputs=("X", "Seed"), outputs=("Out", "SeedOut"),
             stop_gradient=True)
def _random_crop(ctx, op, ins):
    """:684: a window of ``shape`` over the trailing dims, its corner
    drawn uniformly from the op's generator, one draw a dim."""
    x = ins["X"][0]
    shape = [int(s) for s in op.attrs["shape"]]
    lead = x.dim() - len(shape)
    if x.is_meta:       # shape inference draws nothing
        starts = [0] * len(shape)
    else:
        gen = ctx.op_generator(op)
        starts = [int(torch.randint(0, x.shape[lead + i] - s + 1, (),
                                    generator=gen, device=ctx.device))
                  for i, s in enumerate(shape)]
    idx = tuple([slice(None)] * lead
                + [slice(st, st + s) for st, s in zip(starts, shape)])
    return {"Out": [x[idx]], "SeedOut": [_seed_out(ctx, ins)]}


@register_op("seed", inputs=(), outputs=("Out",), stop_gradient=True)
def _seed(ctx, op, ins):
    """:703."""
    return {"Out": [torch.tensor([int(op.attrs.get("seed", 0))],
                                 dtype=torch.int32, device=ctx.device)]}


_M32 = 0xFFFFFFFF


def _mul32(a, c):
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32) and a 32-bit
    constant ``c``, in products below 2**48: the low and high halves of
    ``a`` apart, so no int64 product overflows."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


@register_op("hash", inputs=("X",), outputs=("Out",), stop_gradient=True)
def _hash(ctx, op, ins):
    """:708: JAX's splitmix-style mix in uint32 arithmetic, with its
    constants, so the two packages hash an id to the same bucket (the
    reference's hash_op.cc is xxhash: ROADMAP §C). Torch's uint32 has no
    multiply or shift, so the mix runs in int64, masked to 32 bits after
    every product (``_mul32``). JAX builds the i-th seed term
    ``i * 0x85EBCA6B`` as a uint32 from a Python int and raises past
    i = 1 (num_hash > 2); the port wraps it to 32 bits, the uint32
    product that term stands for.
    Out is int64: [..., num_hash, last] for num_hash > 1."""
    x = ins["X"][0].to(torch.int64) & _M32
    num_hash = int(op.attrs.get("num_hash", 1))
    mod_by = int(op.attrs.get("mod_by", 1))
    outs = []
    for i in range(num_hash):
        h = (_mul32(x, 0x9E3779B1) + ((i * 0x85EBCA6B) & _M32)) & _M32
        h = h ^ (h >> 16)
        h = _mul32(h, 0xC2B2AE35)
        h = h ^ (h >> 13)
        outs.append(torch.remainder(h, mod_by))
    return {"Out": [torch.stack(outs, dim=-2) if num_hash > 1 else outs[0]]}
