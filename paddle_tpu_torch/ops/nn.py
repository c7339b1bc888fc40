"""NN ops: softmax, layer_norm (kernels K1/K3),
softmax_with_cross_entropy (kernels K4/K5) and flash_attention (kernels
K6-K9) — torch lowerings with the semantics of ``paddle_tpu/ops/nn.py``
and ``paddle_tpu/kernels/flash_attention.py``."""

from __future__ import annotations

import numpy as np
import torch

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
    torch, made only when something reads it."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = int(op.attrs.get("axis", -1))
    if op.attrs.get("soft_label", False) or axis not in (-1, logits.dim() - 1):
        raise NotImplementedError(
            "softmax_with_cross_entropy: the port takes hard labels over the "
            "last axis (soft labels and other axes are not ported yet)")
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
