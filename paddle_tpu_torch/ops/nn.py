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
from .math import _Abs, _bounded, _softplus


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
    Under sequence parallelism the op takes the ring or Ulysses route
    (``runtime/tp_plan.py``, JAX's :994-1033), under tensor parallelism
    it runs on the rank's heads; the JAX package's mesh wrapping of its
    Mosaic calls (``kernels/mesh_wrap.py``) has no counterpart here:
    every kernel already runs on the rank's own tensors."""
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
    """An NHWC value as the channels-last NCHW tensor cuDNN's NHWC
    kernels take: a view when ``x`` is a contiguous NHWC tensor, else one
    copy into that layout. A bare permute of a value whose memory is NCHW
    (the view a ``transpose2`` returns) would hand cuDNN NCHW memory, and
    the region would run NCHW kernels."""
    if fmt == "NCHW":
        return x
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


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


# -- sequence helpers (paddle_tpu/ops/nn.py:840, :927) -----------------------


@register_op("im2sequence", inputs=("X",), outputs=("Out",))
def _im2sequence(ctx, op, ins):
    """Sliding blocks as a sequence: [N, C, H, W] -> [N, oh·ow,
    C·kh·kw] (reference im2sequence_op.cc, no padding)."""
    x = ins["X"][0]
    kh, kw = [int(v) for v in op.attrs["kernels"]]
    sh, sw = [int(v) for v in op.attrs.get("strides", [1, 1])]
    N, C, H, W = x.shape
    oh, ow = (H - kh) // sh + 1, (W - kw) // sw + 1
    cols = [x[:, :, i:i + sh * oh:sh, j:j + sw * ow:sw]
            for i in range(kh) for j in range(kw)]
    out = torch.stack(cols, dim=-1).permute(0, 2, 3, 1, 4)
    return {"Out": [out.reshape(N, oh * ow, C * kh * kw)]}


@register_op("row_conv", inputs=("X", "Filter"), outputs=("Out",))
def _row_conv(ctx, op, ins):
    """Lookahead row convolution: out[t] = sum_j W[j] · x[t + j]."""
    x, w = ins["X"][0], ins["Filter"][0]
    K = w.shape[0]
    T = x.shape[1]
    xp = F.pad(x, (0, 0, 0, K - 1))
    out = xp[:, 0:T] * w[0][None, None, :]
    for j in range(1, K):
        out = out + xp[:, j:j + T] * w[j][None, None, :]
    return {"Out": [out]}


# -- the ops of the dygraph.nn classes (paddle_tpu/ops/nn.py:468, :596,
# :886, :905, :1036) -----------------------------------------------------------


@register_op("prelu", inputs=("X", "Alpha"), outputs=("Out",))
def _prelu(ctx, op, ins):
    """x where x > 0, else alpha * x; ``channel`` mode takes one alpha a
    channel of dim 1, ``all`` and ``element`` broadcast Alpha as it is."""
    x, alpha = ins["X"][0], ins["Alpha"][0]
    if op.attrs.get("mode", "all") == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return {"Out": [torch.where(x > 0, x, alpha * x)]}


@register_op("group_norm", inputs=("X", "Scale", "Bias"),
             outputs=("Y", "Mean", "Variance"))
def _group_norm(ctx, op, ins):
    """Normalise each (sample, group of C / groups channels) over its
    channels and positions by the biased variance; NCHW or NHWC."""
    x = ins["X"][0]
    g = int(op.attrs.get("groups", 1))
    eps = float(op.attrs.get("epsilon", 1e-5))
    n = x.shape[0]
    if op.attrs.get("data_layout", "NCHW") == "NHWC":
        c = x.shape[-1]
        xg = x.reshape(tuple(x.shape[:-1]) + (g, c // g))
        axes = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)
        bshape = [1] * (x.dim() - 1) + [c]
    else:
        c = x.shape[1]
        xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
        axes = tuple(range(2, xg.dim()))
        bshape = [1, c] + [1] * (x.dim() - 2)
    var, mean = torch.var_mean(xg, dim=axes, correction=0, keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(bshape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(bshape)
    return {"Y": [y], "Mean": [mean.reshape(n, g)],
            "Variance": [var.reshape(n, g)]}


@register_op("spectral_norm", inputs=("Weight", "U", "V"), outputs=("Out",),
             no_grad=("U", "V"))
def _spectral_norm(ctx, op, ins):
    """W / sigma, sigma = u · W · v after ``power_iters`` power
    iterations from U and V (reference spectral_norm_op.cc); the
    gradient runs through the iterations, as JAX's vjp does."""
    w = ins["Weight"][0]
    dim = int(op.attrs.get("dim", 0))
    eps = float(op.attrs.get("eps", 1e-12))
    wm = w.movedim(dim, 0).reshape(w.shape[dim], -1)
    u, v = ins["U"][0].reshape(-1), ins["V"][0].reshape(-1)
    for _ in range(max(int(op.attrs.get("power_iters", 1)), 1)):
        v = wm.t() @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return {"Out": [w / (u @ wm @ v)]}


@register_op("bilinear_tensor_product", inputs=("X", "Y", "Weight", "Bias"),
             outputs=("Out",))
def _bilinear_tensor_product(ctx, op, ins):
    """out[b, k] = x[b] · W[k] · y[b] (+ bias[k])."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["Weight"][0]
    out = torch.einsum("bm,kmn,bn->bk", x, w, y)
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(1, -1)
    return {"Out": [out]}


@register_op("nce", inputs=("Input", "Label", "Weight", "Bias",
                            "SampleWeight"),
             outputs=("Cost", "SampleLogits", "SampleLabels"),
             no_grad=("Label", "SampleWeight"))
def _nce(ctx, op, ins):
    """Noise-contrastive estimation (reference nce_op.cc): the label and
    ``num_neg_samples`` classes drawn uniformly (from the op's
    generator) a row, a logistic loss each, summed; SampleLabels holds
    the classes. SampleWeight and ``sampler`` are not read, as in JAX."""
    x = ins["Input"][0]
    lbl = ins["Label"][0].reshape(-1).long()
    w = ins["Weight"][0]
    num_neg = int(op.attrs.get("num_neg_samples", 10))
    B = x.shape[0]
    if x.is_meta:       # shape inference (layers/auto.py): no draw
        neg = torch.empty((B, num_neg), dtype=torch.long, device=x.device)
    else:
        neg = torch.randint(0, w.shape[0], (B, num_neg),
                            generator=ctx.op_generator(op), device=x.device)
    cls = torch.cat([lbl[:, None], neg], dim=1)
    logits = torch.einsum("bd,bkd->bk", x, w[cls])
    if ins.get("Bias"):
        logits = logits + ins["Bias"][0].reshape(-1)[cls]
    labels = torch.zeros_like(logits)
    labels[:, 0] = 1
    # softplus as jnp.logaddexp(x, 0)
    softplus = (torch.clamp(logits, min=0)
                + torch.log1p(torch.exp(-logits.abs())))
    ce = softplus - labels * logits
    return {"Cost": [ce.sum(dim=1, keepdim=True)], "SampleLogits": [logits],
            "SampleLabels": [cls]}


# -- the rest of paddle_tpu/ops/nn.py ------------------------------------------
#
# Plain torch, as the reference's are plain jnp. ``jnp.clip`` / ``maximum``
# / ``minimum`` split a gradient at a tie (``math._maximum``), ``jnp.max``
# splits it over equal maxima (``torch.amax``), ``jax.nn.softplus`` is
# ``logaddexp(x, 0)`` (``math._softplus``).


@register_op("cross_entropy", inputs=("X", "Label"), outputs=("Y",),
             no_grad=("Label",))
def _cross_entropy(ctx, op, ins):
    """:295: ``-log(clip(x, 1e-8, 1))`` at the label (hard) or summed
    against it (``soft_label``), a trailing 1 kept."""
    x, label = ins["X"][0], ins["Label"][0]
    logx = torch.log(_bounded(x, 1e-8, 1.0))
    if op.attrs.get("soft_label", False):
        return {"Y": [-torch.sum(label * logx, dim=-1, keepdim=True)]}
    if label.dim() == x.dim() and label.shape[-1] == 1:
        label = label.squeeze(-1)
    return {"Y": [-torch.gather(logx, -1, label.long().unsqueeze(-1))]}


@register_op(
    "sync_batch_norm",
    inputs=("X", "Scale", "Bias", "Mean", "Variance"),
    outputs=("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"),
    no_grad=("Mean", "Variance"),
)
def _sync_batch_norm(ctx, op, ins):
    """:376-400. JAX's is ``batch_norm``: under GSPMD the batch mean is
    already global. The port runs data parallelism as one process a
    device, so inside a world the per-channel sum, sum of squares and
    count are summed over the data-parallel group, both ways
    (``comm.all_reduce_sum``: the backward sums the statistics'
    gradients over the ranks, as one process's batch norm over the
    whole batch would), and the moments are JAX's sync form ``E[x^2] -
    E[x]^2``. Outside a world, or in a test-mode op, it is
    ``batch_norm``."""
    dist = ctx.dist
    is_test = bool(op.attrs.get("is_test", False)) or bool(
        op.attrs.get("use_global_stats", False))
    if (dist is None or not dist.active or dist.batch_n <= 1
            or dist.batch_group is None or is_test):
        return _batch_norm(ctx, op, ins)
    from ..parallel import comm

    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = float(op.attrs.get("epsilon", 1e-5))
    momentum = float(op.attrs.get("momentum", 0.9))
    ch = 1 if op.attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    n = x.numel() // x.shape[ch]
    stats = torch.cat([x.sum(dim=axes), (x * x).sum(dim=axes),
                       x.new_full((1,), float(n))])
    stats = comm.all_reduce_sum(stats, dist.batch_group)
    C = x.shape[ch]
    count = stats[2 * C]
    g_mean = stats[:C] / count
    g_var = stats[C:2 * C] / count - g_mean * g_mean
    inv = 1.0 / torch.sqrt(g_var + eps)
    bshape = [1] * x.dim()
    bshape[ch] = C
    y = ((x - g_mean.reshape(bshape)) * inv.reshape(bshape)
         * scale.reshape(bshape) + bias.reshape(bshape))
    return {"Y": [y],
            "MeanOut": [momentum * mean + (1 - momentum) * g_mean.detach()],
            "VarianceOut": [momentum * var + (1 - momentum) * g_var.detach()],
            "SavedMean": [g_mean.detach()], "SavedVariance": [inv.detach()]}


@register_op("instance_norm", inputs=("X", "Scale", "Bias"),
             outputs=("Y", "SavedMean", "SavedVariance"))
def _instance_norm(ctx, op, ins):
    """:500-525: each (sample, channel) over its spatial dims, with the
    biased variance; SavedVariance is 1 / sqrt(var + eps), [N, C]."""
    x = ins["X"][0]
    eps = float(op.attrs.get("epsilon", 1e-5))
    axes = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=axes, keepdim=True, correction=0)
    inv = 1.0 / torch.sqrt(var + eps)
    y = (x - mean) * inv
    n, c = x.shape[0], x.shape[1]
    bshape = [1, c] + [1] * (x.dim() - 2)
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(bshape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(bshape)
    return {"Y": [y], "SavedMean": [mean.reshape(n, c)],
            "SavedVariance": [inv.reshape(n, c)]}


@register_op("l2_normalize", inputs=("X",), outputs=("Out", "Norm"))
def _l2_normalize(ctx, op, ins):
    """:527: x / sqrt(sum(x^2) + eps) along ``axis``."""
    x = ins["X"][0]
    axis = int(op.attrs.get("axis", -1))
    eps = float(op.attrs.get("epsilon", 1e-10))
    norm = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True) + eps)
    return {"Out": [x / norm], "Norm": [norm]}


@register_op("norm", inputs=("X",), outputs=("Out", "Norm"))
def _norm(ctx, op, ins):
    """:536: ``l2_normalize``."""
    return _l2_normalize(ctx, op, ins)


@register_op("squared_l2_norm", inputs=("X",), outputs=("Out",))
def _squared_l2_norm(ctx, op, ins):
    """:541: [1]."""
    x = ins["X"][0]
    return {"Out": [torch.sum(x * x).reshape(1)]}


@register_op("squared_l2_distance", inputs=("X", "Y"),
             outputs=("Out", "sub_result"))
def _squared_l2_distance(ctx, op, ins):
    """:546: a row's squared distance, [N, 1], and X - Y."""
    sub = ins["X"][0] - ins["Y"][0]
    return {"Out": [torch.sum(sub * sub, dim=tuple(range(1, sub.dim())))
                    .reshape(-1, 1)],
            "sub_result": [sub]}


@register_op("log_loss", inputs=("Predicted", "Labels"), outputs=("Loss",),
             no_grad=("Labels",))
def _log_loss(ctx, op, ins):
    """:560."""
    p, y = ins["Predicted"][0], ins["Labels"][0]
    eps = float(op.attrs.get("epsilon", 1e-4))
    return {"Loss": [-y * torch.log(p + eps) - (1 - y) * torch.log(
        1 - p + eps)]}


@register_op("huber_loss", inputs=("X", "Y"), outputs=("Out", "Residual"),
             no_grad=("Y",))
def _huber_loss(ctx, op, ins):
    """:568: on r = y - x, 0.5 r^2 within ``delta``, else delta (|r| -
    delta / 2)."""
    r = ins["Y"][0] - ins["X"][0]
    delta = float(op.attrs.get("delta", 1.0))
    abs_r = _Abs.apply(r)
    loss = torch.where(abs_r <= delta, 0.5 * (r * r),
                       delta * (abs_r - 0.5 * delta))
    return {"Out": [loss], "Residual": [r]}


@register_op("smooth_l1_loss",
             inputs=("X", "Y", "InsideWeight", "OutsideWeight"),
             outputs=("Out", "Diff"),
             no_grad=("Y", "InsideWeight", "OutsideWeight"))
def _smooth_l1_loss(ctx, op, ins):
    """:580: a row's sum, [N, 1], of 0.5 s^2 d^2 below 1 / s^2 and
    |d| - 0.5 / s^2 above it, d = (x - y) * InsideWeight."""
    s2 = float(op.attrs.get("sigma", 1.0)) ** 2
    diff = ins["X"][0] - ins["Y"][0]
    if ins.get("InsideWeight"):
        diff = diff * ins["InsideWeight"][0]
    ad = _Abs.apply(diff)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * (diff * diff),
                       ad - 0.5 / s2)
    if ins.get("OutsideWeight"):
        loss = loss * ins["OutsideWeight"][0]
    loss = torch.sum(loss, dim=tuple(range(1, loss.dim()))).reshape(-1, 1)
    return {"Out": [loss], "Diff": [diff]}


@register_op("maxout", inputs=("X",), outputs=("Out",))
def _maxout(ctx, op, ins):
    """:605: the max of each run of ``groups`` channels."""
    x = ins["X"][0]
    g = int(op.attrs.get("groups", 1))
    n, c, h, w = x.shape
    return {"Out": [torch.amax(x.reshape(n, c // g, g, h, w), dim=2)]}


@register_op("kldiv_loss", inputs=("X", "Target"), outputs=("Loss",),
             no_grad=("Target",))
def _kldiv_loss(ctx, op, ins):
    """:613: t (log t - x) where t > 0, then ``reduction``."""
    x, t = ins["X"][0], ins["Target"][0]
    loss = t * (torch.log(torch.clamp(t, min=1e-10)) - x)
    loss = torch.where(t > 0, loss, torch.zeros((), dtype=loss.dtype,
                                                device=loss.device))
    red = op.attrs.get("reduction", "mean")
    if red == "mean":
        loss = torch.mean(loss)
    elif red == "sum":
        loss = torch.sum(loss)
    elif red == "batchmean":
        loss = torch.sum(loss) / x.shape[0]
    return {"Loss": [loss]}


def _interp_out_hw(x, op):
    """:628: ``out_h`` / ``out_w``, else the input's size times
    ``scale``."""
    oh = int(op.attrs.get("out_h", 0))
    ow = int(op.attrs.get("out_w", 0))
    scale = op.attrs.get("scale", 0.0)
    if (not oh or not ow) and scale:
        oh, ow = int(x.shape[2] * scale), int(x.shape[3] * scale)
    return oh, ow


def _arange32(n, device):
    return torch.arange(n, dtype=torch.float32, device=device)


def _ratio32(in_len, out_len):
    """in / out as XLA evaluates JAX's ``k * in / out``: the division a
    product with out's float32 reciprocal, folded with in into one
    float32 constant."""
    return float(np.float32(np.float32(in_len)
                            * np.float32(1.0 / np.float32(out_len))))


@register_op("interp_nearest", inputs=("X",), outputs=("Out",))
@register_op("nearest_interp", inputs=("X",), outputs=("Out",))
def _nearest_interp(ctx, op, ins):
    """:637 (interpolate_op, nearest). Output k reads source index
    ``floor(r k + 0.5)``, r = (in - 1) / (out - 1), under
    ``align_corners`` (the default), else ``floor(k in / out)``, in JAX's
    float32 arithmetic as XLA evaluates it (``r k + 0.5`` one fused
    multiply-add, rounded once: computed in float64 here;
    ``_ratio32``); a gather of rows, then of columns."""
    x = ins["X"][0]
    oh, ow = _interp_out_hw(x, op)
    ac = bool(op.attrs.get("align_corners", True))

    def idx(out_len, in_len):
        k = _arange32(out_len, x.device)
        if out_len == in_len:
            return k.long()
        if ac:
            r = float(np.float32((in_len - 1) / max(out_len - 1, 1)))
            return torch.floor((k.double() * r + 0.5).float()).long()
        return torch.floor(k * _ratio32(in_len, out_len)).long()

    out = x.index_select(2, idx(oh, x.shape[2]))
    return {"Out": [out.index_select(3, idx(ow, x.shape[3]))]}


@register_op("bilinear_interp", inputs=("X",), outputs=("Out",))
def _bilinear_interp(ctx, op, ins):
    """:659 (interpolate_op, bilinear): a lerp along H, then along W.
    Output k samples source s = k (in - 1) / (out - 1) under
    ``align_corners`` (the default); otherwise ``align_mode`` 0 is the
    half-pixel ``(k + 0.5) in / out - 0.5`` and 1 (the default) is ``k
    in / out``, both clipped to [0, in - 1], which ``F.interpolate`` does
    not offer. Indices and weights are JAX's float32 ones, ``in / out``
    as XLA folds it (``_ratio32``)."""
    x = ins["X"][0]
    oh, ow = _interp_out_hw(x, op)
    ac = bool(op.attrs.get("align_corners", True))
    mode = int(op.attrs.get("align_mode", 1))

    def src(out_len, in_len):
        k = _arange32(out_len, x.device)
        if ac:
            return k * ((in_len - 1) / max(out_len - 1, 1))
        c = _ratio32(in_len, out_len)
        if mode == 0:
            return torch.clamp((k + 0.5) * c - 0.5, 0, in_len - 1)
        return torch.clamp(k * c, 0, in_len - 1)

    def lerp_axis(v, out_len, in_len, axis):
        s = src(out_len, in_len)
        lo = torch.floor(s).long()
        hi = torch.clamp(lo + 1, max=in_len - 1)
        w = (s - lo).to(x.dtype)
        shape = [1] * v.dim()
        shape[axis] = out_len
        w = w.reshape(shape)
        return (v.index_select(axis, lo) * (1 - w)
                + v.index_select(axis, hi) * w)

    out = lerp_axis(x, oh, x.shape[2], 2)
    return {"Out": [lerp_axis(out, ow, x.shape[3], 3)]}


@register_op("add_position_encoding", inputs=("X",), outputs=("Out",))
def _add_position_encoding(ctx, op, ins):
    """:702 (add_position_encoding_op.h:73): alpha x + beta PE, PE's
    angle pos / 10000^(k / (half - 1)) (pos / 10000 when half is 1),
    sines then cosines."""
    x = ins["X"][0]
    alpha = float(op.attrs.get("alpha", 1.0))
    beta = float(op.attrs.get("beta", 1.0))
    B, T, D = x.shape
    half = D // 2
    pos = _arange32(T, x.device)[:, None]
    i = _arange32(half, x.device)[None, :]
    if half > 1:
        angle = pos / torch.pow(torch.tensor(10000.0, device=x.device),
                                i / (half - 1))
    else:
        angle = pos / 10000.0
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=1)
    return {"Out": [alpha * x + beta * pe[None, :, :D].to(x.dtype)]}


@register_op("affine_channel", inputs=("X", "Scale", "Bias"),
             outputs=("Out",))
def _affine_channel(ctx, op, ins):
    """:723: x * Scale[c] + Bias[c], NCHW."""
    x = ins["X"][0]
    return {"Out": [x * ins["Scale"][0].reshape(1, -1, 1, 1)
                    + ins["Bias"][0].reshape(1, -1, 1, 1)]}


def _linspace32(n, device):
    """``jnp.linspace(-1, 1, n)`` in float32: -(1 - s) + s with s = i /
    (n - 1), the last point 1."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    s = _arange32(n - 1, device) / float(n - 1)
    return torch.cat([-1.0 * (1 - s) + 1.0 * s,
                      torch.ones(1, device=device)])


@register_op("affine_grid", inputs=("Theta", "OutputShape"),
             outputs=("Output",), no_grad=("OutputShape",))
def _affine_grid(ctx, op, ins):
    """:731 (affine_grid_op.cc): the grid [N, H, W, 2] of Theta [N, 2, 3]
    applied to (x, y, 1), x and y from -1 to 1 over W and H (the corner
    pixels' centres: align_corners). OutputShape is read on the host."""
    theta = ins["Theta"][0]
    if ins.get("OutputShape"):
        oshape = [int(v) for v in ins["OutputShape"][0].reshape(-1).tolist()]
    else:
        oshape = [int(v) for v in op.attrs["output_shape"]]
    _, _, H, W = oshape
    gy, gx = torch.meshgrid(_linspace32(H, theta.device),
                            _linspace32(W, theta.device), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).to(theta.dtype)
    return {"Output": [torch.einsum("hwk,nck->nhwc", base, theta)]}


@register_op("grid_sampler", inputs=("X", "Grid"), outputs=("Output",),
             no_grad=("Grid",))
def _grid_sampler(ctx, op, ins):
    """:749 (grid_sampler_op.cc): X sampled bilinearly at Grid [N, Ho,
    Wo, 2] (x, y in [-1, 1], -1 and 1 the corner pixels' centres, as
    ``align_corners=True``), a corner outside the image counting 0 (zero
    padding); the four corners gathered and mixed in JAX's order."""
    x, grid = ins["X"][0], ins["Grid"][0]
    N, C, H, W = x.shape
    Ho, Wo = grid.shape[1], grid.shape[2]
    gx = (grid[..., 0] + 1.0) * (W - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (H - 1) / 2.0
    x0 = torch.floor(gx).long()
    y0 = torch.floor(gy).long()
    x1, y1 = x0 + 1, y0 + 1
    lx, ly = (gx - x0)[:, None], (gy - y0)[:, None]
    flat = x.reshape(N, C, H * W)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    def pick(yy, xx):
        inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        at = (torch.clamp(yy, 0, H - 1) * W
              + torch.clamp(xx, 0, W - 1)).reshape(N, 1, Ho * Wo)
        v = torch.gather(flat, 2, at.expand(N, C, Ho * Wo))
        return torch.where(inb[:, None], v.reshape(N, C, Ho, Wo), zero)

    v00, v01 = pick(y0, x0), pick(y0, x1)
    v10, v11 = pick(y1, x0), pick(y1, x1)
    out = (v00 * (1 - ly) * (1 - lx) + v01 * (1 - ly) * lx
           + v10 * ly * (1 - lx) + v11 * ly * lx)
    return {"Output": [out]}


@register_op("pixel_shuffle", inputs=("X",), outputs=("Out",))
def _pixel_shuffle(ctx, op, ins):
    """:780: [N, C r^2, H, W] -> [N, C, H r, W r]."""
    x = ins["X"][0]
    r = int(op.attrs.get("upscale_factor", 1))
    N, C, H, W = x.shape
    c = C // (r * r)
    out = x.reshape(N, c, r, r, H, W).permute(0, 1, 4, 2, 5, 3)
    return {"Out": [out.reshape(N, c, H * r, W * r)]}


@register_op("space_to_depth", inputs=("X",), outputs=("Out",))
def _space_to_depth(ctx, op, ins):
    """:790: blocks of ``blocksize`` pixels into channels, the block
    offset major."""
    x = ins["X"][0]
    bs = int(op.attrs.get("blocksize", 1))
    N, C, H, W = x.shape
    out = x.reshape(N, C, H // bs, bs, W // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return {"Out": [out.reshape(N, C * bs * bs, H // bs, W // bs)]}


@register_op("temporal_shift", inputs=("X",), outputs=("Out",))
def _temporal_shift(ctx, op, ins):
    """:799 (TSM): of each segment's frames, the first ``shift_ratio`` of
    the channels take the next frame's values, the next as many the
    previous frame's, zeros at the ends."""
    x = ins["X"][0]
    T = int(op.attrs["seg_num"])
    ratio = float(op.attrs.get("shift_ratio", 0.25))
    NT, C, H, W = x.shape
    c1, c2 = int(C * ratio), int(C * 2 * ratio)
    v = x.reshape(NT // T, T, C, H, W)
    fwd = torch.cat([v[:, 1:, :c1], torch.zeros_like(v[:, :1, :c1])], 1)
    bwd = torch.cat([torch.zeros_like(v[:, :1, c1:c2]), v[:, :-1, c1:c2]], 1)
    out = torch.cat([fwd, bwd, v[:, :, c2:]], dim=2)
    return {"Out": [out.reshape(NT, C, H, W)]}


@register_op("unfold", inputs=("X",), outputs=("Y",))
def _unfold(ctx, op, ins):
    """:817 (im2col): [N, C, H, W] -> [N, C kh kw, L], the kernel offset
    minor within a channel; ``paddings`` (top, left, bottom, right)."""
    x = ins["X"][0]
    kh, kw = [int(v) for v in op.attrs["kernel_sizes"]]
    sh, sw = [int(v) for v in op.attrs.get("strides", [1, 1])]
    pads = [int(v) for v in op.attrs.get("paddings", [0, 0, 0, 0])]
    dh, dw = [int(v) for v in op.attrs.get("dilations", [1, 1])]
    N, C = x.shape[0], x.shape[1]
    xp = F.pad(x, [pads[1], pads[3], pads[0], pads[2]])
    Hp, Wp = xp.shape[2], xp.shape[3]
    oh = (Hp - (dh * (kh - 1) + 1)) // sh + 1
    ow = (Wp - (dw * (kw - 1) + 1)) // sw + 1
    cols = [xp[:, :, i * dh:i * dh + sh * oh:sh, j * dw:j * dw + sw * ow:sw]
            for i in range(kh) for j in range(kw)]
    out = torch.stack(cols, dim=2)
    return {"Y": [out.reshape(N, C * kh * kw, oh * ow)]}


@register_op("lrn", inputs=("X",), outputs=("Out", "MidOut"))
def _lrn(ctx, op, ins):
    """:858: x / (k + alpha * sum of x^2 over ``n`` neighbouring
    channels)^beta, the window summed in JAX's order."""
    x = ins["X"][0]
    n = int(op.attrs.get("n", 5))
    k = float(op.attrs.get("k", 2.0))
    alpha = float(op.attrs.get("alpha", 1e-4))
    beta = float(op.attrs.get("beta", 0.75))
    half = n // 2
    pad = F.pad(x * x, [0, 0, 0, 0, half, half])
    C = x.shape[1]
    acc = pad[:, 0:C]
    for i in range(1, n):
        acc = acc + pad[:, i:i + C]
    mid = k + alpha * acc
    return {"Out": [x / torch.pow(mid, beta)], "MidOut": [mid]}


@register_op("data_norm", inputs=("X", "BatchSize", "BatchSum",
                                  "BatchSquareSum"),
             outputs=("Y", "Means", "Scales"),
             no_grad=("BatchSize", "BatchSum", "BatchSquareSum"))
def _data_norm(ctx, op, ins):
    """:873 (data_norm_op.cc): normalised by the accumulated batch
    statistics it is given. Stateless, as JAX's: the statistics are not
    updated (ROADMAP §C)."""
    x = ins["X"][0]
    n = torch.clamp(ins["BatchSize"][0], min=1e-4)
    s = ins["BatchSum"][0]
    mean = s / n
    scale = torch.sqrt(n / torch.clamp(ins["BatchSquareSum"][0] - s * mean,
                                       min=1e-4))
    return {"Y": [(x - mean) * scale], "Means": [mean], "Scales": [scale]}


@register_op("conv_shift", inputs=("X", "Y"), outputs=("Out",))
def _conv_shift(ctx, op, ins):
    """:914: circular correlation, out[i, j] = sum_k x[i, (j + k - w/2)
    mod n] y[i, k]."""
    x, y = ins["X"][0], ins["Y"][0]
    N, Wd = x.shape[1], y.shape[1]
    idx = (torch.arange(N, device=x.device)[:, None]
           + torch.arange(Wd, device=x.device)[None, :] - Wd // 2) % N
    return {"Out": [torch.einsum("bnw,bw->bn", x[:, idx], y)]}


@register_op("pool_with_index", inputs=("X",), outputs=("Out", "Mask"))
def _pool_with_index(ctx, op, ins):
    """:939: max pool with the flat index (h W + w) of each window's
    first maximum, int32."""
    x = ins["X"][0]
    ks = [int(v) for v in op.attrs.get("ksize", [2, 2])]
    st = [int(v) for v in op.attrs.get("strides", ks)]
    N, C, H, W = x.shape
    oh = (H - ks[0]) // st[0] + 1
    ow = (W - ks[1]) // st[1] + 1
    patches, flat = [], []
    for i in range(ks[0]):
        for j in range(ks[1]):
            patches.append(x[:, :, i:i + st[0] * oh:st[0],
                             j:j + st[1] * ow:st[1]])
            rows = (torch.arange(oh, device=x.device) * st[0] + i)[:, None]
            cols = (torch.arange(ow, device=x.device) * st[1] + j)[None, :]
            flat.append(rows * W + cols)
    stacked = torch.stack(patches, dim=-1)
    which = torch.argmax(stacked, dim=-1)
    idxs = torch.stack(flat, dim=-1).expand(N, C, oh, ow, len(patches))
    mask = torch.gather(idxs, -1, which[..., None])[..., 0]
    return {"Out": [torch.amax(stacked, dim=-1)],
            "Mask": [mask.to(torch.int32)]}


@register_op("spp", inputs=("X",), outputs=("Out",))
def _spp(ctx, op, ins):
    """:968: spatial pyramid pooling, level l pooled over 2^l x 2^l bins
    (bounds ``H i // bins``), the levels' bins in order."""
    x = ins["X"][0]
    levels = int(op.attrs.get("pyramid_height", 2))
    is_max = op.attrs.get("pooling_type", "max") == "max"
    H, W = x.shape[2], x.shape[3]
    outs = []
    for lv in range(levels):
        bins = 2 ** lv
        hs = [H * i // bins for i in range(bins + 1)]
        ws = [W * i // bins for i in range(bins + 1)]
        for bi in range(bins):
            for bj in range(bins):
                patch = x[:, :, hs[bi]:hs[bi + 1], ws[bj]:ws[bj + 1]]
                outs.append(torch.amax(patch, dim=(2, 3)) if is_max
                            else torch.mean(patch, dim=(2, 3)))
    return {"Out": [torch.cat(outs, dim=1)]}


@register_op("fsp", inputs=("X", "Y"), outputs=("Out",))
def _fsp(ctx, op, ins):
    """:989: X Y^T over the spatial dims / (H W)."""
    x, y = ins["X"][0], ins["Y"][0]
    H, W = x.shape[2], x.shape[3]
    return {"Out": [torch.einsum("nchw,ndhw->ncd", x, y) / (H * W)]}


@register_op("minus", inputs=("X", "Y"), outputs=("Out",))
def _minus(ctx, op, ins):
    """:998."""
    return {"Out": [ins["X"][0] - ins["Y"][0]]}


@register_op("selu", inputs=("X",), outputs=("Out",))
def _selu(ctx, op, ins):
    """:1003."""
    scale = float(op.attrs.get("scale", 1.0507009873554805))
    alpha = float(op.attrs.get("alpha", 1.6732632423543772))
    x = ins["X"][0]
    return {"Out": [scale * torch.where(x > 0, x, alpha * (torch.exp(x)
                                                           - 1.0))]}


@register_op("l1_norm", inputs=("X",), outputs=("Out",))
def _l1_norm(ctx, op, ins):
    """:1011: [1]."""
    return {"Out": [torch.sum(_Abs.apply(ins["X"][0])).reshape(1)]}


@register_op("label_smooth", inputs=("X", "PriorDist"), outputs=("Out",),
             no_grad=("PriorDist",))
def _label_smooth(ctx, op, ins):
    """:1025: (1 - eps) x + eps PriorDist (uniform without one)."""
    x = ins["X"][0]
    eps = float(op.attrs.get("epsilon", 0.1))
    prior = (ins["PriorDist"][0].reshape(1, -1) if ins.get("PriorDist")
             else 1.0 / x.shape[-1])
    return {"Out": [(1.0 - eps) * x + eps * prior]}


@register_op("hierarchical_sigmoid",
             inputs=("X", "W", "Label", "PathTable", "PathCode", "Bias"),
             outputs=("Out", "PreOut", "W_Out"),
             no_grad=("Label", "PathTable", "PathCode"))
def _hierarchical_sigmoid(ctx, op, ins):
    """:1064 (hierarchical_sigmoid_op.cc): a binary-tree softmax. Without
    a PathTable the tree is the complete one over ``num_classes``: label
    l's path is the bits of l + C below its top bit, internal node ids
    ``(l + C) >> (s + 1)`` - 1. A row's loss sums softplus(pre) - bit *
    pre over the valid nodes of its path; softplus is ``logaddexp(pre,
    0)``, as ``jax.nn.softplus``."""
    x, w = ins["X"][0], ins["W"][0]
    lbl = ins["Label"][0].reshape(-1).long()
    C = int(op.attrs.get("num_classes", w.shape[0] + 1))
    depth = max(int(np.ceil(np.log2(max(C, 2)))), 1)
    if ins.get("PathTable"):
        table = ins["PathTable"][0].long()
        bits = ins["PathCode"][0].to(torch.float32)
        valid = table >= 0
        node_ids = torch.clamp(table, min=0)
    else:
        key = lbl + C
        shifts = torch.arange(depth - 1, -1, -1, device=x.device)
        node_ids = (key[:, None] >> (shifts[None, :] + 1)) - 1
        bits = ((key[:, None] >> shifts[None, :]) & 1).to(torch.float32)
        valid = (node_ids >= 0) & (node_ids < w.shape[0])
        node_ids = torch.clamp(node_ids, 0, w.shape[0] - 1)
    pre = torch.einsum("bd,bkd->bk", x, w[node_ids])
    if ins.get("Bias"):
        pre = pre + ins["Bias"][0].reshape(-1)[node_ids]
    ce = _softplus(pre) - bits * pre
    ce = torch.where(valid, ce, torch.zeros((), dtype=ce.dtype,
                                            device=ce.device))
    return {"Out": [torch.sum(ce, dim=1, keepdim=True)], "PreOut": [pre],
            "W_Out": [w]}
