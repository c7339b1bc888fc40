"""The sequence fusions of ``paddle_tpu/ops/fused.py``: ``fusion_lstm``,
``fusion_gru``, ``fused_embedding_fc_lstm``, ``fused_embedding_seq_pool``,
``fusion_seqconv_eltadd_relu``, ``fusion_seqexpand_concat_fc``,
``fusion_seqpool_concat`` and ``fusion_seqpool_cvm_concat``.

These are op types a saved Fluid program may hold (the reference's
fuse passes write them). As in the JAX package, each is the plain
composition of the ops it fuses, with the one input projection shared
between the ``XX`` output and the recurrence.
"""

from __future__ import annotations

import torch

from ..core.registry import get_op_def, register_op

_UNARY = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
          "identity": lambda x: x, "": lambda x: x}


def _act(name):
    return _UNARY[str(name or "identity").lower()]


def _project(ins):
    xx = torch.einsum("btd,dk->btk", ins["X"][0], ins["WeightX"][0])
    if ins.get("Bias"):
        xx = xx + ins["Bias"][0]
    return xx


@register_op("fusion_lstm",
             inputs=("X", "WeightX", "WeightH", "Bias", "H0", "C0", "Length"),
             no_grad=("Length",),
             outputs=("Hidden", "Cell", "XX", "BatchedInput", "BatchedHidden",
                      "BatchedCell", "ReorderedH0", "ReorderedC0",
                      "CheckedCell"))
def _fusion_lstm(ctx, op, ins):
    x = ins["X"][0]
    xx = _project(ins)
    r = get_op_def("lstm").lower(ctx, op, {
        "Input": [xx], "Weight": ins["WeightH"], "H0": ins.get("H0", []),
        "C0": ins.get("C0", []), "Length": ins.get("Length", [])})
    H = ins["WeightH"][0].shape[0]
    z = torch.zeros((x.shape[0], H), dtype=x.dtype, device=x.device)
    return {"Hidden": r["Hidden"], "Cell": r["Cell"], "XX": [xx],
            "BatchedInput": [xx], "BatchedHidden": r["Hidden"],
            "BatchedCell": r["Cell"],
            "ReorderedH0": [ins["H0"][0] if ins.get("H0") else z],
            "ReorderedC0": [ins["C0"][0] if ins.get("C0") else z],
            "CheckedCell": [torch.zeros((2, H), dtype=x.dtype,
                                        device=x.device)]}


@register_op("fusion_gru",
             inputs=("X", "H0", "WeightX", "WeightH", "Bias", "Length"),
             no_grad=("Length",),
             outputs=("ReorderedH0", "XX", "BatchedInput", "BatchedOut",
                      "Hidden"))
def _fusion_gru(ctx, op, ins):
    x = ins["X"][0]
    xx = _project(ins)
    r = get_op_def("gru").lower(ctx, op, {
        "Input": [xx], "Weight": ins["WeightH"], "H0": ins.get("H0", []),
        "Length": ins.get("Length", [])})
    H = ins["WeightH"][0].shape[0]
    h0 = ins["H0"][0] if ins.get("H0") else torch.zeros(
        (x.shape[0], H), dtype=x.dtype, device=x.device)
    return {"ReorderedH0": [h0], "XX": [xx], "BatchedInput": [xx],
            "BatchedOut": r["Hidden"], "Hidden": r["Hidden"]}


@register_op("fused_embedding_fc_lstm",
             inputs=("Ids", "Embeddings", "WeightH", "Bias", "H0", "C0"),
             outputs=("Hidden", "Cell", "XX", "BatchedInput", "BatchedHidden",
                      "BatchedCell", "ReorderedH0", "ReorderedC0"),
             no_grad=("Ids",))
def _fused_embedding_fc_lstm(ctx, op, ins):
    """Embeddings [vocab, 4H] are the pre-projected x·Wx: the lookup
    replaces the input matmul."""
    from .rnn import _lstm_scan

    ids = ins["Ids"][0]
    emb = ins["Embeddings"][0][ids.reshape(ids.shape[0], -1).long()]
    if ins.get("Bias"):
        emb = emb + ins["Bias"][0]
    wh = ins["WeightH"][0]
    B, T, _ = emb.shape
    H = wh.shape[0]
    z = torch.zeros((B, H), dtype=emb.dtype, device=emb.device)
    h0 = ins["H0"][0] if ins.get("H0") else z
    c0 = ins["C0"][0] if ins.get("C0") else z
    hs, cs, _, _ = _lstm_scan(emb.transpose(0, 1), wh, h0, c0)
    hid, cell = hs.transpose(0, 1), cs.transpose(0, 1)
    return {"Hidden": [hid], "Cell": [cell], "XX": [emb],
            "BatchedInput": [emb], "BatchedHidden": [hid],
            "BatchedCell": [cell], "ReorderedH0": [h0], "ReorderedC0": [c0]}


@register_op("fused_embedding_seq_pool", inputs=("W", "Ids"),
             outputs=("Out",), no_grad=("Ids",))
def _fused_embedding_seq_pool(ctx, op, ins):
    w, ids = ins["W"][0], ins["Ids"][0]
    ids = ids.reshape(ids.shape[0], -1).long()
    emb = w[ids]
    pad = op.attrs.get("padding_idx", None)
    if pad is not None and int(pad) >= 0:
        emb = emb * (ids != int(pad))[..., None].to(emb.dtype)
    if str(op.attrs.get("combiner", "sum")).lower() == "mean":
        return {"Out": [emb.mean(1)]}
    return {"Out": [emb.sum(1)]}


@register_op("fusion_seqconv_eltadd_relu", inputs=("X", "Filter", "Bias"),
             outputs=("Out", "ColMat"))
def _fusion_seqconv_eltadd_relu(ctx, op, ins):
    r = get_op_def("sequence_conv").lower(ctx, op, ins)
    out = torch.relu(r["Out"][0] + ins["Bias"][0])
    return {"Out": [out], "ColMat": [torch.zeros((0,), dtype=out.dtype,
                                                 device=out.device)]}


@register_op("fusion_seqexpand_concat_fc",
             inputs=("X", "FCWeight", "FCBias"), outputs=("Out", "FCOut"))
def _fusion_seqexpand_concat_fc(ctx, op, ins):
    """X[0] [B, T, D0] is the sequence; each later X [B, Di] broadcasts
    along T; the concatenation goes through one fc."""
    seq = ins["X"][0]
    B, T = seq.shape[0], seq.shape[1]
    parts = [seq] + [v[:, None, :].expand(B, T, v.shape[-1])
                     for v in ins["X"][1:]]
    cat = torch.cat(parts, dim=-1)
    w = ins["FCWeight"][0]
    out = cat.reshape(B * T, -1) @ w
    if ins.get("FCBias"):
        out = out + ins["FCBias"][0].reshape(1, -1)
    out = _act(op.attrs.get("fc_activation", ""))(out).reshape(
        B, T, w.shape[1])
    return {"Out": [out], "FCOut": [out]}


def _seq_pool(x, pooltype):
    pt = str(pooltype).upper()
    if pt == "SUM":
        return x.sum(1)
    if pt == "AVERAGE":
        return x.mean(1)
    if pt == "SQRT":
        return x.sum(1) / (float(x.shape[1]) ** 0.5)
    if pt == "MAX":
        return torch.amax(x, 1)
    if pt == "LAST":
        return x[:, -1]
    if pt == "FIRST":
        return x[:, 0]
    raise NotImplementedError(pt)


@register_op("fusion_seqpool_concat", inputs=("X",), outputs=("Out",))
def _fusion_seqpool_concat(ctx, op, ins):
    pt = op.attrs.get("pooltype", "SUM")
    return {"Out": [torch.cat([_seq_pool(x, pt) for x in ins["X"]], -1)]}


@register_op("fusion_seqpool_cvm_concat", inputs=("X", "CVM"),
             outputs=("Out",), no_grad=("CVM",))
def _fusion_seqpool_cvm_concat(ctx, op, ins):
    pt = op.attrs.get("pooltype", "SUM")
    drop = 0 if bool(op.attrs.get("use_cvm", True)) else 2
    return {"Out": [torch.cat([_seq_pool(x, pt)[:, drop:]
                               for x in ins["X"]], -1)]}
