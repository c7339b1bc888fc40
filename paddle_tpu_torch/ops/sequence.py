"""Sequence ops over dense padded batches: torch lowerings with the
semantics of ``paddle_tpu/ops/sequence.py``.

The reference's sequence ops work on LoD tensors (ragged rows). The JAX
package, and this port, keep a dense ``[B, T, ...]`` tensor with an
optional ``Length`` input instead: absent lengths mean every row is
full. ``sequence_pool``'s max takes the gradient of ``jnp.max``: an
incoming gradient is shared equally among the positions that tie for
the maximum (``torch.amax``), never sent to one index, and padded
positions get none.
"""

from __future__ import annotations

import torch

from ..core.executor import torch_dtype
from ..core.registry import register_op

_BIG_NEG = -1e38


def _mask(x, ins, time_axis=1):
    if not ins.get("Length"):
        return None
    ln = ins["Length"][0]
    t = x.shape[time_axis]
    ar = torch.arange(t, device=x.device)
    return (ar[None, :] < ln.reshape(-1, 1)).to(x.dtype)


def _full_lengths(x, dtype=torch.int32):
    return torch.full((x.shape[0],), x.shape[1], dtype=dtype, device=x.device)


@register_op("sequence_pool", inputs=("X", "Length"),
             outputs=("Out", "MaxIndex"), no_grad=("Length",))
def _sequence_pool(ctx, op, ins):
    x = ins["X"][0]
    ptype = str(op.attrs.get("pooltype", "AVERAGE")).upper()
    m = _mask(x, ins)
    mm = None
    if m is not None:
        mm = m[..., None] if x.dim() == 3 else m
    if ptype == "SUM":
        out = (x * mm).sum(1) if mm is not None else x.sum(1)
    elif ptype == "AVERAGE":
        out = ((x * mm).sum(1) / torch.clamp(mm.sum(1), min=1.0)
               if mm is not None else x.mean(1))
    elif ptype == "SQRT":
        out = ((x * mm).sum(1) / torch.sqrt(torch.clamp(mm.sum(1), min=1.0))
               if mm is not None else x.sum(1) / (x.shape[1] ** 0.5))
    elif ptype == "MAX":
        xm = x
        if mm is not None:
            xm = torch.where(mm > 0, x, torch.full_like(x, _BIG_NEG))
        out = torch.amax(xm, 1)
    elif ptype == "LAST":
        if ins.get("Length"):
            idx = torch.clamp(ins["Length"][0].long() - 1, min=0)
            idx = idx.reshape((-1,) + (1,) * (x.dim() - 1))
            idx = idx.expand((x.shape[0], 1) + tuple(x.shape[2:]))
            out = torch.gather(x, 1, idx).squeeze(1)
        else:
            out = x[:, -1]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError(ptype)
    return {"Out": [out],
            "MaxIndex": [torch.zeros((0,), dtype=torch.int32,
                                     device=x.device)]}


@register_op("sequence_softmax", inputs=("X", "Length"), outputs=("Out",),
             no_grad=("Length",))
def _sequence_softmax(ctx, op, ins):
    x = ins["X"][0]
    m = _mask(x, ins)
    if m is None:
        return {"Out": [torch.softmax(x, dim=1)]}
    logits = torch.where(m > 0, x, torch.full_like(x, _BIG_NEG))
    return {"Out": [torch.softmax(logits, dim=1) * m]}


@register_op("sequence_expand", inputs=("X", "Y"), outputs=("Out",),
             no_grad=("Y",))
def _sequence_expand(ctx, op, ins):
    """Dense: X tiles along Y's time axis."""
    x, y = ins["X"][0], ins["Y"][0]
    if x.dim() < y.dim():
        x = x.unsqueeze(1)
    reps = [1] * x.dim()
    reps[1] = y.shape[1] // x.shape[1]
    return {"Out": [x.repeat(*reps)]}


@register_op("sequence_reshape", inputs=("X",), outputs=("Out",))
def _sequence_reshape(ctx, op, ins):
    x = ins["X"][0]
    return {"Out": [x.reshape(x.shape[0], -1, int(op.attrs["new_dim"]))]}


@register_op("sequence_concat", inputs=("X",), outputs=("Out",))
def _sequence_concat(ctx, op, ins):
    return {"Out": [torch.cat(list(ins["X"]), dim=1)]}


@register_op("sequence_reverse", inputs=("X", "Length"), outputs=("Y",),
             no_grad=("Length",))
def _sequence_reverse(ctx, op, ins):
    x = ins["X"][0]
    if not ins.get("Length"):
        return {"Y": [x.flip(1)]}
    ln = ins["Length"][0].reshape(-1, 1).long()
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    rev = torch.where(idx < ln, ln - 1 - idx, idx)
    rev = rev.reshape(rev.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return {"Y": [torch.gather(x, 1, rev)]}


@register_op("sequence_pad", inputs=("X", "PadValue", "Length"),
             outputs=("Out", "Length"), no_grad=("PadValue", "Length"))
def _sequence_pad(ctx, op, ins):
    """The dense form is padded already: X passes through with its
    lengths."""
    x = ins["X"][0]
    ln = ins["Length"][0] if ins.get("Length") else _full_lengths(
        x, torch.int64)
    return {"Out": [x], "Length": [ln]}


@register_op("sequence_unpad", inputs=("X", "Length"), outputs=("Out",),
             no_grad=("Length",))
def _sequence_unpad(ctx, op, ins):
    return {"Out": [ins["X"][0]]}


@register_op("sequence_mask", inputs=("X",), outputs=("Y",),
             stop_gradient=True)
def _sequence_mask(ctx, op, ins):
    ln = ins["X"][0]
    maxlen = int(op.attrs.get("maxlen", -1))
    if maxlen <= 0:
        raise ValueError("sequence_mask needs a static maxlen attr, as in "
                         "the JAX package")
    ar = torch.arange(maxlen, device=ln.device)
    m = ar < ln[..., None]
    return {"Y": [m.to(torch_dtype(op.attrs.get("out_dtype", "int64")))]}


@register_op("sequence_conv", inputs=("X", "Filter", "Length"),
             outputs=("Out",), no_grad=("Length",))
def _sequence_conv(ctx, op, ins):
    """Context-window convolution over time (reference
    sequence_conv_op.cc): each step's ``contextLength`` rows from
    ``contextStart`` on, concatenated, times Filter [ctx·D, F]; rows
    out of range or past the row's length are zeros."""
    x, w = ins["X"][0], ins["Filter"][0]
    clen = int(op.attrs.get("contextLength",
                            op.attrs.get("context_length", 3)))
    cstart = int(op.attrs.get("contextStart",
                              op.attrs.get("context_start", -1)))
    B, T, D = x.shape
    m = _mask(x, ins)
    if m is not None:
        x = x * m[..., None]
    cols = []
    t_idx = torch.arange(T, device=x.device)
    for j in range(clen):
        off = cstart + j
        shifted = torch.roll(x, -off, dims=1)
        valid = ((t_idx + off >= 0) & (t_idx + off < T))[None, :, None]
        cols.append(torch.where(valid, shifted, torch.zeros_like(shifted)))
    return {"Out": [torch.cat(cols, dim=-1) @ w]}


@register_op("sequence_enumerate", inputs=("X", "Length"), outputs=("Out",),
             stop_gradient=True)
def _sequence_enumerate(ctx, op, ins):
    """Every ``win_size`` window of ids at each position; positions
    past a row's end hold ``pad_value``."""
    x = ins["X"][0]
    win = int(op.attrs["win_size"])
    pad = op.attrs.get("pad_value", 0)
    B, T = x.shape[0], x.shape[1]
    ln = ins["Length"][0] if ins.get("Length") else _full_lengths(x)
    t_idx = (torch.arange(T, device=x.device)[:, None]
             + torch.arange(win, device=x.device)[None, :])
    gather = x[:, torch.clamp(t_idx, 0, T - 1)]
    valid = t_idx[None] < ln.reshape(-1, 1, 1)
    return {"Out": [torch.where(valid, gather,
                                torch.full_like(gather, pad))]}


def _compact(x, keep, ln_dtype):
    """Survivors moved to the front in order (a stable argsort on
    (dropped, position)), the tail zeroed; returns (out, new lengths)."""
    B, T = x.shape
    pos = torch.arange(T, device=x.device)[None, :]
    key = torch.where(keep, 0, 1) * (T + 1) + pos
    order = torch.argsort(key, dim=1, stable=True)
    compacted = torch.gather(x, 1, order)
    new_len = keep.sum(1).to(ln_dtype)
    out = torch.where(pos < new_len[:, None], compacted,
                      torch.zeros_like(compacted))
    return out, new_len


@register_op("sequence_erase", inputs=("X", "Length"),
             outputs=("Out", "OutLength"), stop_gradient=True)
def _sequence_erase(ctx, op, ins):
    x = ins["X"][0]
    tokens = torch.tensor(list(op.attrs.get("tokens", [])), dtype=x.dtype,
                          device=x.device)
    B, T = x.shape
    ln = ins["Length"][0] if ins.get("Length") else _full_lengths(x)
    in_seq = torch.arange(T, device=x.device)[None, :] < ln.reshape(-1, 1)
    keep = in_seq & ~torch.isin(x, tokens)
    out, new_len = _compact(x, keep, ln.dtype)
    return {"Out": [out], "OutLength": [new_len]}


@register_op("sequence_expand_as", inputs=("X", "Y"), outputs=("Out",),
             no_grad=("Y",))
def _sequence_expand_as(ctx, op, ins):
    """Each step of X repeats in place (x0, x0, x1, x1) to Y's time
    length; a [B, ...] X broadcasts along it."""
    x, y = ins["X"][0], ins["Y"][0]
    if x.dim() == y.dim():
        return {"Out": [torch.repeat_interleave(x, y.shape[1] // x.shape[1],
                                                dim=1)]}
    return {"Out": [x.unsqueeze(1).expand((x.shape[0], y.shape[1])
                                          + tuple(x.shape[1:]))]}


@register_op("sequence_scatter", inputs=("X", "Ids", "Updates", "Length"),
             outputs=("Out",), no_grad=("Ids", "Length"))
def _sequence_scatter(ctx, op, ins):
    """Out = X; Out[b, Ids[b, t]] += Updates[b, t] for t < Length[b]."""
    x, ids, upd = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    B, T = ids.shape[0], ids.shape[1]
    ln = ins["Length"][0] if ins.get("Length") else _full_lengths(ids)
    valid = torch.arange(T, device=x.device)[None, :] < ln.reshape(-1, 1)
    upd = upd.reshape(B, T)
    upd = torch.where(valid, upd, torch.zeros_like(upd))
    return {"Out": [x.scatter_add(1, ids.reshape(B, T).long(),
                                  upd.to(x.dtype))]}


@register_op("sequence_slice", inputs=("X", "Offset", "Length"),
             outputs=("Out", "OutLength"), no_grad=("Offset", "Length"))
def _sequence_slice(ctx, op, ins):
    """Each row's [offset, offset + length) window, moved to the front
    of the time axis, the tail zeroed."""
    x = ins["X"][0]
    off = ins["Offset"][0].reshape(-1).to(torch.int32)
    ln = ins["Length"][0].reshape(-1).to(torch.int32)
    B, T = x.shape[0], x.shape[1]
    ar = torch.arange(T, device=x.device)[None, :]
    gidx = torch.clamp(ar + off[:, None], 0, T - 1).long()
    tail = (1,) * (x.dim() - 2)
    out = torch.gather(x, 1, gidx.reshape((B, T) + tail).expand(x.shape))
    valid = (ar < ln[:, None]).reshape((B, T) + tail)
    return {"Out": [torch.where(valid, out, torch.zeros_like(out))],
            "OutLength": [ln]}


@register_op("sequence_topk_avg_pooling", inputs=("X", "Length"),
             outputs=("Out",), no_grad=("Length",))
def _sequence_topk_avg_pooling(ctx, op, ins):
    """The mean of the top k scores of each channel, for each k of
    ``topks``: X [B, C, T] -> [B, C·len(topks)]. The sort is JAX's:
    ascending and stable, then reversed, so tied scores keep JAX's
    order (and their gradients land where JAX's do)."""
    x = ins["X"][0]
    topks = [int(t) for t in op.attrs["topks"]]
    B, C, T = x.shape
    if ins.get("Length"):
        ln = ins["Length"][0]
        live = (torch.arange(T, device=x.device)[None, None, :]
                < ln.reshape(-1, 1, 1))
        x = torch.where(live, x, torch.full_like(x, _BIG_NEG))
    else:
        ln = torch.full((B,), T, dtype=torch.int32, device=x.device)
    sx = torch.sort(x, dim=-1, stable=True).values.flip(-1)
    outs = []
    for k in topks:
        k_eff = torch.clamp(ln, max=k).reshape(-1, 1)
        kk = min(k, T)
        valid = (torch.arange(kk, device=x.device)[None, None, :]
                 < k_eff[..., None])
        take = sx[..., :kk]
        s = torch.where(valid, take, torch.zeros_like(take)).sum(-1)
        outs.append(s / torch.clamp(k_eff, min=1).to(x.dtype))
    return {"Out": [torch.stack(outs, -1).reshape(B, C * len(topks))]}
