"""The fused ops of ``paddle_tpu/ops/fused.py``.

The sequence fusions (``fusion_lstm``, ``fusion_gru``,
``fused_embedding_fc_lstm``, ``fused_embedding_seq_pool``,
``fusion_seqconv_eltadd_relu``, ``fusion_seqexpand_concat_fc``,
``fusion_seqpool_concat``, ``fusion_seqpool_cvm_concat``) and the
inference fusions (``fc``, ``fused_elemwise_activation``,
``fused_fc_elementwise_layernorm``, ``fused_batch_norm_act``,
``fusion_repeated_fc_relu``, ``fusion_squared_mat_sub``,
``fusion_transpose_flatten_concat``, ``multihead_matmul``,
``conv2d_fusion``, ``conv2d_inception_fusion``).

These are op types a saved Fluid program may hold (the reference's
fuse passes write them; ``contrib.layers.fused_elemwise_activation``
emits one). As in the JAX package, each is the plain composition of
the ops it fuses: none is a Pallas kernel there, and none is a
hand-written kernel here. The one input projection of a recurrence is
shared between the ``XX`` output and the recurrence. ``gelu`` in these
ops is ``jax.nn.gelu``'s default, the tanh approximation (the ``gelu``
op itself is exact erf).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import get_op_def, register_op

_UNARY = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
          "gelu": lambda x: F.gelu(x, approximate="tanh"),
          "identity": lambda x: x, "": lambda x: x}
_BINARY = {"elementwise_add": torch.add, "elementwise_sub": torch.sub,
           "elementwise_mul": torch.mul}


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


# -- the inference fusions ---------------------------------------------------


def _fc_compute(x, w, bias, in_num_col_dims=1, act=None):
    lead = tuple(x.shape[:in_num_col_dims])
    out = x.reshape(math.prod(lead), -1) @ w
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return _act(act)(out).reshape(lead + (w.shape[1],))


@register_op("fc", inputs=("Input", "W", "Bias"), outputs=("Out",))
def _fc(ctx, op, ins):
    bias = ins["Bias"][0] if ins.get("Bias") else None
    return {"Out": [_fc_compute(
        ins["Input"][0], ins["W"][0], bias,
        int(op.attrs.get("in_num_col_dims", 1)),
        op.attrs.get("activation_type", ""))]}


@register_op("fused_elemwise_activation", inputs=("X", "Y"),
             outputs=("Out", "IntermediateOut"))
def _fused_elemwise_activation(ctx, op, ins):
    """``functor_list = [outer, inner]``: binary(X, unary(Y)) or
    unary(binary(X, Y)) (reference fused_elemwise_activation_op.h). A
    ``scale`` attr wins even at 0.0."""
    x, y = ins["X"][0], ins["Y"][0]
    outer, inner = list(op.attrs.get("functor_list",
                                     ["elementwise_add", ""]))
    has_scale = "scale" in op.attrs
    scale = float(op.attrs.get("scale", 1.0))

    def unary(name, v):
        if name.startswith("scale"):
            return v * (scale if has_scale else 1.0)
        return _act(name)(v)

    if outer in _BINARY:
        mid = unary(inner, y)
        out = _BINARY[outer](x, mid)
    else:
        mid = _BINARY[inner](x, y)
        out = unary(outer, mid)
    return {"Out": [out], "IntermediateOut": [mid]}


@register_op("fused_fc_elementwise_layernorm",
             inputs=("X", "W", "Bias0", "Y", "Scale", "Bias1"),
             outputs=("Out", "Mean", "Variance"))
def _fused_fc_elementwise_layernorm(ctx, op, ins):
    """fc, + Y, layer norm over the axes from ``begin_norm_axis``
    (biased variance); Mean and Variance come back flattened."""
    bias0 = ins["Bias0"][0] if ins.get("Bias0") else None
    h = _fc_compute(ins["X"][0], ins["W"][0], bias0,
                    int(op.attrs.get("x_num_col_dims", 1))) + ins["Y"][0]
    axis = int(op.attrs.get("begin_norm_axis", 1))
    eps = float(op.attrs.get("epsilon", 1e-5))
    red = tuple(range(axis, h.dim()))
    mean = h.mean(dim=red, keepdim=True)
    var = ((h - mean) ** 2).mean(dim=red, keepdim=True)
    norm = (h - mean) * torch.rsqrt(var + eps)
    if ins.get("Scale"):
        norm = norm * ins["Scale"][0]
    if ins.get("Bias1"):
        norm = norm + ins["Bias1"][0]
    norm = _act(op.attrs.get("activation_type", ""))(norm)
    return {"Out": [norm], "Mean": [mean.reshape(-1)],
            "Variance": [var.reshape(-1)]}


@register_op("fused_batch_norm_act",
             inputs=("X", "Scale", "Bias", "Mean", "Variance"),
             outputs=("Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance", "ReserveSpace"),
             no_grad=("Mean", "Variance"))
def _fused_batch_norm_act(ctx, op, ins):
    bn = dict(get_op_def("batch_norm").lower(ctx, op, ins))
    bn["Y"] = [_act(op.attrs.get("act_type", "relu"))(bn["Y"][0])]
    x = ins["X"][0]
    bn["ReserveSpace"] = [torch.zeros((0,), dtype=torch.float32,
                                      device=x.device)]
    return bn


@register_op("fusion_repeated_fc_relu", inputs=("X", "W", "Bias"),
             outputs=("ReluOut", "Out"))
def _fusion_repeated_fc_relu(ctx, op, ins):
    """Every layer is fc + relu, the last included (reference
    fusion_repeated_fc_relu_op.cc)."""
    x = ins["X"][0]
    ws, bs = ins["W"], ins["Bias"]
    relu_outs = []
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = _fc_compute(x, w, b, 1, "relu")
        if i < len(ws) - 1:
            relu_outs.append(x)
    return {"ReluOut": relu_outs, "Out": [x]}


@register_op("fusion_squared_mat_sub", inputs=("X", "Y"),
             outputs=("SquaredX", "SquaredY", "SquaredXY", "Out"))
def _fusion_squared_mat_sub(ctx, op, ins):
    """Out = scalar * ((X @ Y)^2 - X^2 @ Y^2)."""
    x, y = ins["X"][0], ins["Y"][0]
    scalar = float(op.attrs.get("scalar", 1.0))
    sx, sy = x * x, y * y
    sxy = (x @ y) ** 2
    return {"SquaredX": [sx], "SquaredY": [sy], "SquaredXY": [sxy],
            "Out": [scalar * (sxy - sx @ sy)]}


@register_op("fusion_transpose_flatten_concat", inputs=("X",),
             outputs=("Out",))
def _fusion_transpose_flatten_concat(ctx, op, ins):
    """Each X transposed by ``trans_axis``, flattened to 2-D at
    ``flatten_axis``, concatenated on ``concat_axis % 2`` (as JAX)."""
    trans = [int(a) for a in op.attrs.get("trans_axis", [])]
    flat = int(op.attrs.get("flatten_axis", 1))
    cat = int(op.attrs.get("concat_axis", 1))
    outs = []
    for x in ins["X"]:
        if trans:
            x = x.permute(*trans)
        outs.append(x.reshape(math.prod(x.shape[:flat]), -1))
    return {"Out": [torch.cat(outs, dim=cat % 2)]}


@register_op("multihead_matmul", inputs=("Input", "W", "Bias", "BiasQK"),
             outputs=("Out",), no_grad=("BiasQK",))
def _multihead_matmul(ctx, op, ins):
    """Fused QKV attention of the inference transformer fusion
    (reference fused/multihead_matmul_op.cu): Input [B, S, D], W [D, 3,
    N, H], Bias [3, N, H], BiasQK broadcastable to [B, N, S, S]; one
    projection einsum, scores scaled by ``alpha``, float softmax."""
    x, w, bias = ins["Input"][0], ins["W"][0], ins["Bias"][0]
    B, S, _D = x.shape
    _, _three, N, H = w.shape
    alpha = float(op.attrs.get("alpha", 1.0))
    qkv = torch.einsum("bsd,dcnh->cbnsh", x, w) + bias.reshape(3, 1, N, 1, H)
    q, k, v = qkv[0], qkv[1], qkv[2]                       # [B, N, S, H]
    scores = torch.einsum("bnsh,bnth->bnst", q, k) * alpha
    if ins.get("BiasQK"):
        scores = scores + ins["BiasQK"][0]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnst,bnth->bnsh", probs, v)
    return {"Out": [out.permute(0, 2, 1, 3).reshape(B, S, N * H)]}


@register_op("conv2d_fusion",
             inputs=("Input", "Filter", "Bias", "ResidualData"),
             outputs=("Output",))
def _conv2d_fusion(ctx, op, ins):
    """conv2d (the port's lowering, the op's attrs) + bias + residual +
    activation (reference fused/conv_fusion_op.cu)."""
    r = get_op_def("conv2d").lower(ctx, op, {"Input": ins["Input"],
                                             "Filter": ins["Filter"]})
    out = r["Output"][0]
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(1, -1, 1, 1)
    if ins.get("ResidualData"):
        out = out + ins["ResidualData"][0]
    return {"Output": [_act(op.attrs.get("activation", "relu"))(out)]}


@register_op("conv2d_inception_fusion", inputs=("Input", "Filter", "Bias"),
             outputs=("Output", "TempOutput"))
def _conv2d_inception_fusion(ctx, op, ins):
    """Branch convolutions (stride 1, each padded by k // 2) + bias +
    relu, concatenated on channels (reference
    fused/fusion_conv_inception_op.cu); TempOutput is empty."""
    x = ins["Input"][0]
    outs = []
    for w, b in zip(ins["Filter"], ins["Bias"]):
        o = F.conv2d(x, w, padding=(w.shape[2] // 2, w.shape[3] // 2))
        outs.append(torch.relu(o + b.reshape(1, -1, 1, 1)))
    return {"Output": [torch.cat(outs, dim=1)],
            "TempOutput": [torch.zeros((0,), dtype=x.dtype,
                                       device=x.device)]}
