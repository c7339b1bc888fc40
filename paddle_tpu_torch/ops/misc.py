"""``flatten`` and ``tree_conv``: the port's copies of the ops of
``paddle_tpu/ops/misc.py`` (:22, :230) that the everyday layers and
``dygraph.nn.TreeConv`` reach."""

from __future__ import annotations

import math

import torch

from ..core.registry import register_op


@register_op("flatten", inputs=("X",), outputs=("Out",))
def _flatten(ctx, op, ins):
    """Fluid's flatten_op.cc: the dims before ``axis`` into one, the
    rest into the other (``flatten2`` without the XShape slot)."""
    x = ins["X"][0]
    axis = int(op.attrs.get("axis", 1))
    lead = math.prod(x.shape[:axis]) if axis else 1
    return {"Out": [x.reshape(lead, -1)]}


@register_op("tree_conv", inputs=("NodesVector", "EdgeSet", "Filter"),
             outputs=("Out",), no_grad=("EdgeSet",))
def _tree_conv(ctx, op, ins):
    """Tree-based convolution (TBCNN, reference tree_conv_op.cc;
    ``paddle_tpu/ops/misc.py:230``). NodesVector [B, N, D], EdgeSet
    [B, E, 2] (parent, child), Filter [D, F, 3] (top, left, right).
    Child k (0-based, in edge order) of m siblings mixes left and right
    by eta_r = k / (m - 1) (0.5 for an only child), eta_l = 1 - eta_r;
    each parent sums its children's messages; then ``act`` (tanh by
    default, relu, or none)."""
    nodes = ins["NodesVector"][0]
    edges = ins["EdgeSet"][0].long()
    filt = ins["Filter"][0]
    B, N, _ = nodes.shape
    E = edges.shape[1]
    wt, wl, wr = filt[..., 0], filt[..., 1], filt[..., 2]
    parents, children = edges[..., 0], edges[..., 1]
    same = parents[:, :, None] == parents[:, None, :]
    pos = torch.arange(E, device=nodes.device)
    k = (same & (pos[None, :] < pos[:, None])).sum(2).to(nodes.dtype)
    m = same.sum(2).to(nodes.dtype)
    eta_r = torch.where(m > 1, k / torch.clamp(m - 1.0, min=1.0),
                        torch.full_like(m, 0.5))
    eta_l = 1.0 - eta_r
    cvec = torch.gather(nodes, 1,
                        children[..., None].expand(B, E, nodes.shape[2]))
    msg = (cvec @ wl) * eta_l[..., None] + (cvec @ wr) * eta_r[..., None]
    agg = torch.zeros((B, N, wl.shape[1]), dtype=nodes.dtype,
                      device=nodes.device)
    agg = agg.scatter_add(1, parents[..., None].expand(B, E, wl.shape[1]),
                          msg)
    pre = nodes @ wt + agg
    act = str(op.attrs.get("act", "tanh"))
    if act == "tanh":
        return {"Out": [torch.tanh(pre)]}
    if act == "relu":
        return {"Out": [torch.relu(pre)]}
    return {"Out": [pre]}
