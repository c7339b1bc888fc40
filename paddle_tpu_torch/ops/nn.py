"""NN ops: conv2d, pool2d, batch_norm, softmax, layer_norm (kernels
K1/K3), softmax_with_cross_entropy (kernels K4/K5), clip_by_norm and
flash_attention (kernels K6-K9) — torch lowerings with the semantics of
``paddle_tpu/ops/nn.py`` and ``paddle_tpu/kernels/flash_attention.py``.

The JAX package computes convolutions, pooling and batch norm outside
any Pallas kernel (``lax.conv_general_dilated``, ``reduce_window`` and
jnp), so their lowerings here are ``F.conv2d``, ``F.max_pool2d`` /
``F.avg_pool2d`` and ``F.batch_norm`` (cuDNN on the card), as plain
matmuls are ``torch.matmul``. Both layouts are taken: NCHW as it is,
NHWC moved to channels-first around the call (filters are OIHW in
both, as in the reference)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register_op
from ..kernels.flash_attention import NEG_INF, flash_attention
from ..kernels.layer_norm import fused_layer_norm
from ..kernels.softmax_xent import fused_softmax_xent


@register_op("softmax", inputs=("X",), outputs=("Out",))
def _softmax(ctx, op, ins):
    axis = int(op.attrs.get("axis", -1))
    return {"Out": [torch.softmax(ins["X"][0], dim=axis)]}


@register_op(
    "layer_norm",
    inputs=("X", "Scale", "Bias"),
    outputs=("Y", "Mean", "Variance"),
)
def _layer_norm(ctx, op, ins):
    """Y through ``fused_layer_norm`` (K1 forward, K3 backward), as the
    reference's kernel path (``ops/nn.py:432-448``); the Mean/Variance
    outputs come from plain torch, outside the Function, so their
    gradients stay exact (``layer_norm_pallas``), and only when
    something reads them."""
    x = ins["X"][0]
    eps = float(op.attrs.get("epsilon", 1e-5))
    bna = int(op.attrs.get("begin_norm_axis", 1))
    R = int(np.prod(x.shape[:bna]))
    C = int(np.prod(x.shape[bna:]))
    x2 = x.reshape(R, C)
    gamma = (ins["Scale"][0].reshape(C) if ins.get("Scale")
             else torch.ones(C, dtype=x.dtype, device=x.device))
    beta = (ins["Bias"][0].reshape(C) if ins.get("Bias")
            else torch.zeros(C, dtype=x.dtype, device=x.device))
    y = fused_layer_norm(x2.contiguous(), gamma.contiguous(),
                         beta.contiguous(), eps).reshape(x.shape)
    out = {"Y": [y]}
    if ctx.wants(op, "Mean") or ctx.wants(op, "Variance"):
        out["Mean"] = [x2.mean(dim=1)]
        out["Variance"] = [x2.var(dim=1, unbiased=False)]
    return out


@register_op(
    "softmax_with_cross_entropy",
    inputs=("Logits", "Label"),
    outputs=("Softmax", "Loss"),
    no_grad=("Label",),
)
def _softmax_with_cross_entropy(ctx, op, ins):
    """Loss through ``fused_softmax_xent`` (K4 forward, K5 backward) for
    hard labels over the last axis, as the reference's kernel path
    (``ops/nn.py:234-274``); rows labelled ``ignore_index`` get loss 0
    and no gradient (the kernels mask them). The Softmax slot is plain
    torch, made only when something reads it. Soft labels and other
    axes take the reference's plain path (``_softmax_xent_plain``), as
    JAX sends them past its kernel."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = int(op.attrs.get("axis", -1))
    if op.attrs.get("soft_label", False) or axis not in (-1, logits.dim() - 1):
        return _softmax_xent_plain(ctx, op, logits, label, axis)
    ignore_index = int(op.attrs.get("ignore_index", -100))
    C = logits.shape[-1]
    lead = tuple(logits.shape[:-1])
    lbl = label
    if lbl.dim() == logits.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    if lbl.dtype != torch.int64:
        lbl = lbl.long()
    loss = fused_softmax_xent(logits.reshape(-1, C).contiguous(),
                              lbl.reshape(-1).contiguous(), ignore_index)
    out = {"Loss": [loss.reshape(lead + (1,))]}
    if ctx.wants(op, "Softmax"):
        out["Softmax"] = [torch.softmax(logits, dim=-1)]
    return out


def _softmax_xent_plain(ctx, op, logits, label, axis):
    """``paddle_tpu/ops/nn.py:276-294``: log-softmax over ``axis``;
    soft labels take ``-sum(label * logp)``, hard labels the picked
    ``-logp`` with ``ignore_index`` rows 0. Softmax is ``exp(logp)``."""
    logp = torch.log_softmax(logits, dim=axis)
    if op.attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        ignore_index = int(op.attrs.get("ignore_index", -100))
        lbl = label
        if lbl.dim() == logits.dim() and lbl.shape[axis] == 1:
            lbl = lbl.squeeze(axis)
        lbl = lbl.long()
        safe = torch.where(lbl == ignore_index, torch.zeros_like(lbl), lbl)
        loss = -torch.take_along_dim(logp, safe.unsqueeze(axis), dim=axis)
        loss = torch.where((lbl != ignore_index).unsqueeze(axis), loss,
                           torch.zeros((), dtype=loss.dtype,
                                       device=loss.device))
    out = {"Loss": [loss]}
    if ctx.wants(op, "Softmax"):
        out["Softmax"] = [torch.exp(logp)]
    return out


@register_op("flash_attention", inputs=("Q", "K", "V", "Mask", "BiasQK"),
             outputs=("Out",), no_grad=("Mask",))
def _flash_attention_op(ctx, op, ins):
    """The fused attention op on [B, S, H*D] inputs
    (``kernels/flash_attention.py:973-1081``): heads split into
    [B, H, S, D], the kernels, heads merged back. Its gradient is the
    registry's automatic one: the forward runs the autograd Function,
    so the grad op's ``torch.autograd.grad`` reaches the backward
    kernels. mask_type "binary" maps 1 / 0 to 0 / NEG_INF, "additive"
    adds the values as they are; under AMP the mask arrives as bfloat16.
    The sequence-parallel (ring / Ulysses) and mesh-wrapped routes of
    the reference are distribution work, not ported (ROADMAP A10)."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    h = int(op.attrs["num_heads"])
    causal = bool(op.attrs.get("causal", False))
    B, S, HD = q.shape
    D = HD // h

    def split(x):
        return x.reshape(B, S, h, D).transpose(1, 2)

    mask = ins["Mask"][0] if ins.get("Mask") else None
    if mask is not None and mask.dtype != torch.bool:
        if op.attrs.get("mask_type", "binary") == "binary":
            mask = torch.where(mask.reshape(B, S) > 0.5,
                               torch.zeros((), device=mask.device),
                               torch.full((), NEG_INF, device=mask.device))
        else:
            mask = mask.reshape(B, S)
    bias = ins["BiasQK"][0] if ins.get("BiasQK") else None
    o = flash_attention(split(q), split(k), split(v), causal, None,
                        mask=mask, bias=bias)
    return {"Out": [o.transpose(1, 2).reshape(B, S, HD)]}


def _pair(v):
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v), int(v)]


def _nchw(x, fmt):
    return x if fmt == "NCHW" else x.permute(0, 3, 1, 2)


def _from_nchw(x, fmt):
    return x if fmt == "NCHW" else x.permute(0, 2, 3, 1)


def _same_pads(size, k, stride, dilation):
    """``lax``'s SAME padding of one spatial dim: the output is
    ceil(size / stride), the total padding split with the odd element
    after."""
    ke = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + ke - size, 0)
    return total // 2, total - total // 2


@register_op("conv2d", inputs=("Input", "Filter", "Bias"),
             outputs=("Output",))
def _conv2d(ctx, op, ins):
    """``paddle_tpu/ops/nn.py:28``: strides, paddings, dilations and
    groups; filters OIHW. Paddings are [h, w] (both sides alike) or, as
    ``layers.conv2d(padding=[top, bottom, left, right])`` passes them
    through, four sides: H by (pd[0], pd[1]) and W by (pd[2], pd[3]), as
    the reference's :43-46; an uneven padding takes an ``F.pad`` before
    the convolution. ``padding_algorithm`` SAME pads as ``lax`` does
    (``_same_pads``) and VALID not at all; both ignore ``paddings``."""
    x, w = ins["Input"][0], ins["Filter"][0]
    fmt = op.attrs.get("data_format", "NCHW")
    xc = _nchw(x, fmt)
    strides = _pair(op.attrs.get("strides", [1, 1]))
    dilations = _pair(op.attrs.get("dilations", [1, 1]))
    algo = op.attrs.get("padding_algorithm", "EXPLICIT")
    if algo == "SAME":
        (t, b), (l, r) = (_same_pads(xc.shape[2 + i], w.shape[2 + i],
                                     strides[i], dilations[i])
                          for i in range(2))
        pd = [t, b, l, r]
    elif algo == "VALID":
        pd = [0, 0]
    else:
        pd = _pair(op.attrs.get("paddings", [0, 0]))
    if len(pd) == 4:
        if pd[0] == pd[1] and pd[2] == pd[3]:
            pd = [pd[0], pd[2]]
        else:
            xc = F.pad(xc, (pd[2], pd[3], pd[0], pd[1]))
            pd = [0, 0]
    out = F.conv2d(xc, w, stride=strides, padding=pd, dilation=dilations,
                   groups=int(op.attrs.get("groups", 1)))
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(1, -1, 1, 1)
    return {"Output": [_from_nchw(out, fmt)]}


@register_op("depthwise_conv2d", inputs=("Input", "Filter", "Bias"),
             outputs=("Output",))
def _depthwise_conv2d(ctx, op, ins):
    """``paddle_tpu/ops/nn.py:65``: conv2d with ``groups`` equal to the
    input channels (the attr says so)."""
    return _conv2d(ctx, op, ins)


@register_op("conv2d_transpose", inputs=("Input", "Filter", "Bias"),
             outputs=("Output",))
def _conv2d_transpose(ctx, op, ins):
    """``paddle_tpu/ops/nn.py:72``: the transpose (gradient) of a
    convolution, filter [in_c, out_c / groups, kh, kw] as
    ``F.conv_transpose2d`` takes it. The output is (in - 1) * stride -
    2 * pad + (k - 1) * dilation + 1; an ``output_size`` attr picks a
    size up to stride - 1 larger, added after (``output_padding``), as
    the reference pads the high side."""
    x, w = ins["Input"][0], ins["Filter"][0]
    fmt = op.attrs.get("data_format", "NCHW")
    xc = _nchw(x, fmt)
    strides = _pair(op.attrs.get("strides", [1, 1]))
    pads = _pair(op.attrs.get("paddings", [0, 0]))
    dilations = _pair(op.attrs.get("dilations", [1, 1]))
    groups = int(op.attrs.get("groups", 1))
    extra = [0, 0]
    out_size = op.attrs.get("output_size")
    if out_size:
        for i in range(2):
            formula = ((xc.shape[2 + i] - 1) * strides[i] - 2 * pads[i]
                       + (w.shape[2 + i] - 1) * dilations[i] + 1)
            extra[i] = int(out_size[i]) - formula
            if not 0 <= extra[i] < strides[i]:
                raise ValueError(
                    f"conv2d_transpose: output_size[{i}]={out_size[i]} "
                    f"not in [{formula}, {formula + strides[i] - 1}]")
    if groups > 1 and (xc.shape[1] % groups or w.shape[0] != xc.shape[1]):
        raise ValueError(
            f"conv2d_transpose: in_c {xc.shape[1]} and filter dim0 "
            f"{w.shape[0]} must be divisible/equal for groups={groups}")
    out = F.conv_transpose2d(xc, w, stride=strides, padding=pads,
                             output_padding=extra, groups=groups,
                             dilation=dilations)
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(1, -1, 1, 1)
    return {"Output": [_from_nchw(out, fmt)]}


@register_op("pool2d", inputs=("X",), outputs=("Out",))
def _pool2d(ctx, op, ins):
    """``paddle_tpu/ops/nn.py:150``: max or average over windows
    (``ceil_mode`` is ignored there too), global pooling over the whole
    plane. An average over a padded window divides by the window's
    count of real elements when ``exclusive``, else by its size.
    ``adaptive`` takes ``ksize`` as the output size."""
    x = ins["X"][0]
    fmt = op.attrs.get("data_format", "NCHW")
    ptype = op.attrs.get("pooling_type", "max")
    xc = _nchw(x, fmt)
    if op.attrs.get("global_pooling", False):
        ksize, strides, pads = list(xc.shape[2:]), list(xc.shape[2:]), [0, 0]
    else:
        ksize = _pair(op.attrs.get("ksize", [2, 2]))
        strides = _pair(op.attrs.get("strides", [2, 2]))
        pads = _pair(op.attrs.get("paddings", [0, 0]))
    if op.attrs.get("adaptive", False):
        # ksize is the output's size; the exact reshape-reduce, so the
        # plane must divide into it (:166-178)
        n, c, h, w = xc.shape
        oh, ow = ksize
        if h % oh or w % ow:
            raise ValueError("adaptive pool needs divisible sizes")
        xr = xc.reshape(n, c, oh, h // oh, ow, w // ow)
        out = (torch.amax(xr, dim=(3, 5)) if ptype == "max"
               else torch.mean(xr, dim=(3, 5)))
        return {"Out": [_from_nchw(out, fmt)]}
    if ptype == "max":
        out = F.max_pool2d(xc, ksize, strides, pads)
    else:
        out = F.avg_pool2d(
            xc, ksize, strides, pads,
            count_include_pad=not bool(op.attrs.get("exclusive", True)))
    return {"Out": [_from_nchw(out, fmt)]}


@register_op("batch_norm",
             inputs=("X", "Scale", "Bias", "Mean", "Variance"),
             outputs=("Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"),
             no_grad=("Mean", "Variance"))
def _batch_norm(ctx, op, ins):
    """``paddle_tpu/ops/nn.py:331-377``. Training normalises with the
    batch mean and the BIASED batch variance (``jnp.var``) and returns
    ``MeanOut = momentum * mean + (1 - momentum) * batch_mean``,
    ``VarianceOut`` likewise from the biased variance, ``SavedMean`` and
    ``SavedVariance = 1 / sqrt(var + eps)``. ``F.batch_norm`` without
    running buffers normalises exactly so (its own running update would
    take the unbiased variance), so it makes Y and its gradient, and
    the statistics outputs are computed here as the reference does.
    ``is_test`` / ``use_global_stats`` normalise with Mean and Variance
    and pass them through."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = float(op.attrs.get("epsilon", 1e-5))
    momentum = float(op.attrs.get("momentum", 0.9))
    is_test = bool(op.attrs.get("is_test", False)) or bool(
        op.attrs.get("use_global_stats", False))
    ch = 1 if op.attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    xc = x.movedim(ch, 1)
    if is_test:
        y = F.batch_norm(xc, mean, var, scale, bias, training=False, eps=eps)
        return {"Y": [y.movedim(1, ch)], "MeanOut": [mean],
                "VarianceOut": [var], "SavedMean": [mean],
                "SavedVariance": [var]}
    y = F.batch_norm(xc, None, None, scale, bias, training=True, eps=eps)
    out = {"Y": [y.movedim(1, ch)]}
    with torch.no_grad():
        axes = tuple(i for i in range(x.dim()) if i != ch)
        bvar, bmean = torch.var_mean(x, dim=axes, correction=0)
        out["MeanOut"] = [momentum * mean + (1 - momentum) * bmean]
        out["VarianceOut"] = [momentum * var + (1 - momentum) * bvar]
        out["SavedMean"] = [bmean]
        if ctx.wants(op, "SavedVariance"):
            out["SavedVariance"] = [1.0 / torch.sqrt(bvar + eps)]
    return out


@register_op("clip_by_norm", inputs=("X",), outputs=("Out",))
def _clip_by_norm(ctx, op, ins):
    """``paddle_tpu/ops/nn.py:1017``: x scaled to L2 norm ``max_norm``
    when its norm is larger."""
    x = ins["X"][0]
    mn = float(op.attrs.get("max_norm", 1.0))
    norm = torch.sqrt(torch.sum(x * x))
    return {"Out": [torch.where(norm > mn, x * (mn / norm), x)]}


@register_op("sigmoid_cross_entropy_with_logits", inputs=("X", "Label"),
             outputs=("Out",), no_grad=("Label",))
def _sigmoid_ce(ctx, op, ins):
    """``paddle_tpu/ops/nn.py:313``: max(x, 0) - x z + log1p(exp(-|x|)),
    zero where the label is ``ignore_index``, over the count of the
    others with ``normalize``. ``max`` and ``|x|`` take JAX's gradients
    at 0 (``ops/math.py``'s ``_maximum`` and ``_Abs``)."""
    from .math import _Abs, _maximum

    x, z = ins["X"][0], ins["Label"][0]
    ignore_index = int(op.attrs.get("ignore_index", -100))
    loss = (_maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))
            - x * z + torch.log1p(torch.exp(-_Abs.apply(x))))
    mask = z != ignore_index
    loss = torch.where(mask, loss, torch.zeros((), dtype=loss.dtype,
                                               device=loss.device))
    if op.attrs.get("normalize", False):
        loss = loss / torch.clamp_min(mask.to(loss.dtype).sum(), 1.0)
    return {"Out": [loss]}
