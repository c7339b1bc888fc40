"""The misc ops: the torch lowerings of ``paddle_tpu/ops/misc.py``
(``flatten``, ``tree_conv``, the squeeze / unsqueeze / cross-entropy
forms, the sampled-softmax, match-pyramid and CTR helpers, ``py_func``
on the host, ``brelu`` and the inf / nan probes)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.executor import to_numpy, torch_dtype
from ..core.registry import register_op
from .math import _bounded
from .tensor import _M32, _mul32


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


# -- the rest of paddle_tpu/ops/misc.py ----------------------------------------


@register_op("squeeze", inputs=("X",), outputs=("Out",))
def _squeeze(ctx, op, ins):
    """``paddle_tpu/ops/misc.py:30``: the listed size-1 axes dropped
    (every size-1 axis with none listed), a scalar kept as [1]."""
    x = ins["X"][0]
    axes = [int(a) % max(x.dim(), 1) for a in op.attrs.get("axes", [])]
    shape = [s for i, s in enumerate(x.shape)
             if s != 1 or (axes and i not in axes)]
    return {"Out": [x.reshape(shape or (1,))]}


@register_op("unsqueeze", inputs=("X",), outputs=("Out",))
def _unsqueeze(ctx, op, ins):
    """:43: a size-1 axis at each listed position, in ascending order."""
    out = ins["X"][0]
    for a in sorted(int(a) for a in op.attrs.get("axes", [0])):
        out = out.unsqueeze(a)
    return {"Out": [out]}


@register_op("fill_zeros_like2", inputs=("X",), outputs=("Out",),
             stop_gradient=True)
def _fill_zeros_like2(ctx, op, ins):
    """:52."""
    return {"Out": [torch.zeros_like(ins["X"][0])]}


@register_op("cross_entropy2", inputs=("X", "Label"),
             outputs=("Y", "MatchX", "XShape"), no_grad=("Label",))
def _cross_entropy2(ctx, op, ins):
    """:58 (CrossEntropyOp2): hard labels only, -log max(p, 1e-20) of the
    label's probability, that probability (MatchX) and X's shape as
    int32."""
    x, label = ins["X"][0], ins["Label"][0]
    idx = label.reshape(label.shape[0], -1)[:, 0].long()
    probs = torch.gather(x.reshape(x.shape[0], -1), 1, idx[:, None])
    ce = -torch.log(torch.clamp(probs, min=1e-20))
    return {"Y": [ce], "MatchX": [probs],
            "XShape": [torch.tensor(list(x.shape), dtype=torch.int32,
                                    device=x.device)]}


@register_op("gaussian_random_batch_size_like", inputs=("Input",),
             outputs=("Out",), stop_gradient=True)
def _gaussian_random_batch_size_like(ctx, op, ins):
    """:72: N(mean, std) float32 of ``shape``, dim ``output_dim_idx``
    taken from Input's ``input_dim_idx``."""
    ref = ins["Input"][0]
    shape = [int(s) for s in op.attrs.get("shape", [1])]
    shape[int(op.attrs.get("output_dim_idx", 0))] = ref.shape[
        int(op.attrs.get("input_dim_idx", 0))]
    z = torch.randn(tuple(shape), generator=ctx.op_generator(op),
                    device=ctx.device, dtype=torch.float32)
    return {"Out": [float(op.attrs.get("mean", 0.0))
                    + float(op.attrs.get("std", 1.0)) * z]}


@register_op("sample_logits",
             inputs=("Logits", "Labels", "CustomizedSamples",
                     "CustomizedProbabilities"),
             outputs=("Samples", "Probabilities", "LogitsDim", "LabelsDim",
                      "SampledLogits", "SampledLabels"),
             no_grad=("Labels", "CustomizedSamples",
                      "CustomizedProbabilities"))
def _sample_logits(ctx, op, ins):
    """:86 (sample_logits_op.cc): the true labels' logits, then
    ``num_samples`` negatives drawn uniformly from the op's generator (or
    the customized ones); a negative equal to one of its row's true
    labels gets -1e20 with ``remove_accidental_hits``. SampledLabels
    index the true columns."""
    logits, labels = ins["Logits"][0], ins["Labels"][0]
    B, C = logits.shape
    labels = labels.reshape(B, -1)
    nt = labels.shape[1]
    ns = int(op.attrs.get("num_samples", 5))
    if ins.get("CustomizedSamples"):
        neg = ins["CustomizedSamples"][0].reshape(B, -1)[:, nt:]
        probs_neg = ins["CustomizedProbabilities"][0].reshape(B, -1)[:, nt:]
    else:
        neg = torch.randint(0, C, (B, ns), generator=ctx.op_generator(op),
                            device=logits.device)
        probs_neg = torch.full((B, ns), 1.0 / C, dtype=logits.dtype,
                               device=logits.device)
    samples = torch.cat([labels.long(), neg.long()], dim=1)
    probs = torch.cat([torch.full((B, nt), 1.0 / C, dtype=logits.dtype,
                                  device=logits.device),
                       probs_neg.to(logits.dtype)], dim=1)
    sampled = torch.gather(logits, 1, samples)
    if bool(op.attrs.get("remove_accidental_hits", True)):
        hit = (samples[:, None, nt:] == labels[:, :, None].long()).any(1)
        mask = torch.cat([torch.zeros((B, nt), dtype=torch.bool,
                                      device=hit.device), hit], dim=1)
        sampled = torch.where(mask, torch.full((), -1e20, dtype=sampled.dtype,
                                               device=sampled.device),
                              sampled)
    dev = logits.device
    return {
        "Samples": [samples],
        "Probabilities": [probs],
        "LogitsDim": [torch.tensor([B, C], dtype=torch.int64, device=dev)],
        "LabelsDim": [torch.tensor([B, nt], dtype=torch.int64, device=dev)],
        "SampledLogits": [sampled],
        "SampledLabels": [torch.arange(nt, dtype=torch.int64, device=dev)
                          .expand(B, nt).contiguous()],
    }


@register_op("similarity_focus", inputs=("X",), outputs=("Out",),
             stop_gradient=True)
def _similarity_focus(ctx, op, ins):
    """:130 (similarity_focus_op.h:74-104): for each index channel, walk
    the cells in descending order (a stable sort of -x), taking a cell
    when neither its row nor its column is taken; the mask of taken
    cells, unioned over the index channels, across every channel. The
    walk is H W steps over the batch at once, on the run's device."""
    x = ins["X"][0]
    if int(op.attrs.get("axis", 1)) != 1:
        raise NotImplementedError("similarity_focus: axis 1 only, as JAX")
    B, C, H, W = x.shape
    rows = torch.arange(B, device=x.device)
    mask = torch.zeros((B, H * W), dtype=torch.bool, device=x.device)
    for ci in [int(i) for i in op.attrs.get("indexes", [0])]:
        order = torch.argsort(-x[:, ci].reshape(B, H * W), dim=1,
                              stable=True)
        rtag = torch.zeros((B, H), dtype=torch.bool, device=x.device)
        ctag = torch.zeros((B, W), dtype=torch.bool, device=x.device)
        sel = torch.zeros((B, H * W), dtype=torch.bool, device=x.device)
        for t in range(H * W):
            idx = order[:, t]
            r, c = idx // W, idx % W
            ok = ~rtag[rows, r] & ~ctag[rows, c]
            rtag[rows, r] |= ok
            ctag[rows, c] |= ok
            sel[rows, idx] = ok
        mask |= sel
    out = mask.reshape(B, 1, H, W).to(x.dtype)
    return {"Out": [out.expand(x.shape).contiguous()]}


@register_op("filter_by_instag", inputs=("Ins", "Ins_tag", "Filter_tag"),
             outputs=("Out", "LossWeight", "IndexMap"),
             no_grad=("Ins_tag", "Filter_tag"))
def _filter_by_instag(ctx, op, ins):
    """:170: rows whose tags meet no filter tag are zeroed and weighted 0,
    not removed: JAX masks where the reference (filter_by_instag_op.cc)
    compacts, to keep shapes static (ROADMAP §C). IndexMap is the
    identity, int64."""
    x = ins["Ins"][0]
    tags = ins["Ins_tag"][0].reshape(x.shape[0], -1)
    filt = ins["Filter_tag"][0].reshape(-1)
    keep = (tags[:, :, None] == filt[None, None, :]).any(2).any(1)
    w = keep.to(x.dtype)
    idx = torch.arange(x.shape[0], dtype=torch.int64, device=x.device)
    return {"Out": [x * w.reshape((-1,) + (1,) * (x.dim() - 1))],
            "LossWeight": [w.reshape(-1, 1)],
            "IndexMap": [torch.stack([idx, idx], dim=1)]}


@register_op("pyramid_hash", inputs=("X", "W", "WhiteList", "BlackList"),
             outputs=("Out", "DropPos", "X_Temp_Out"),
             no_grad=("X", "WhiteList", "BlackList"))
def _pyramid_hash(ctx, op, ins):
    """:190 (pyramid_hash_op.cc): the sum of W's rows at the buckets of
    every n-gram (n = 2 .. pyramid_layer) of the token rows. The n-gram's
    hash is JAX's multiplicative one in uint32 arithmetic (h * 2654435761
    + token, the reference uses xxhash), computed in int64 masked to 32
    bits (``tensor._mul32``)."""
    x = ins["X"][0].reshape(ins["X"][0].shape[0], -1)
    w = ins["W"][0]
    layers = int(op.attrs.get("pyramid_layer", 2))
    space = int(op.attrs.get("space_len", w.shape[0]))
    B, T = x.shape
    out = torch.zeros((B, w.shape[1]), dtype=w.dtype, device=w.device)
    xi = x.to(torch.int64) & _M32
    for n in range(2, max(layers + 1, 3)):
        if n > T:
            break
        h = torch.zeros((B, T - n + 1), dtype=torch.int64, device=x.device)
        for j in range(n):
            h = (_mul32(h, 2654435761) + xi[:, j:T - n + 1 + j]) & _M32
        out = out + w[torch.remainder(h, space)].sum(1)
    return {"Out": [out],
            "DropPos": [torch.zeros((B, 1), dtype=torch.int32,
                                    device=x.device)],
            "X_Temp_Out": [x]}


@register_op("match_matrix_tensor", inputs=("X", "Y", "W"),
             outputs=("Out", "Tmp"))
def _match_matrix_tensor(ctx, op, ins):
    """:219: out[b, t, i, j] = x[b, i] W[:, t, :] y[b, j]."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["W"][0]
    tmp = torch.einsum("bid,dtk->btik", x, w)
    return {"Out": [torch.einsum("btik,bjk->btij", tmp, y)], "Tmp": [tmp]}


@register_op("var_conv_2d", inputs=("X", "ROW", "COLUMN", "W"),
             outputs=("Out", "Col"), no_grad=("ROW", "COLUMN"))
def _var_conv_2d(ctx, op, ins):
    """:273: the dense form of var_conv_2d_op.cc: a same-padded
    convolution of the padded grids [B, C_in, H, W] by W [C_out, C_in kh
    kw], the output masked to each sample's ROW x COLUMN extent."""
    x, w = ins["X"][0], ins["W"][0]
    cin = int(op.attrs.get("InputChannel", x.shape[1]))
    cout = int(op.attrs.get("OutputChannel", w.shape[0]))
    kh = int(op.attrs.get("KernelH", 3))
    kw = int(op.attrs.get("KernelW", 3))
    out = F.conv2d(x, w.reshape(cout, cin, kh, kw),
                   stride=(int(op.attrs.get("StrideH", 1)),
                           int(op.attrs.get("StrideW", 1))),
                   padding=(kh // 2, kw // 2))
    if ins.get("ROW") and ins.get("COLUMN"):
        rows = ins["ROW"][0].reshape(-1)
        cols = ins["COLUMN"][0].reshape(-1)
        hmask = torch.arange(out.shape[2], device=x.device) < rows[:, None]
        wmask = torch.arange(out.shape[3], device=x.device) < cols[:, None]
        out = (out * hmask[:, None, :, None].to(out.dtype)
               * wmask[:, None, None, :].to(out.dtype))
    return {"Out": [out], "Col": [torch.zeros((0,), dtype=x.dtype,
                                              device=x.device)]}


def _host_call(fn, xs, shapes, dtypes, device):
    """``fn`` on numpy copies of ``xs`` (a device-to-host copy), its
    results as tensors of the declared shapes and dtypes on ``device``.
    On meta tensors (shape inference) nothing is called."""
    dts = [torch_dtype(d) for d in dtypes]
    if any(x.is_meta for x in xs) or str(device) == "meta":
        return [torch.empty(tuple(int(d) for d in s), dtype=dt,
                            device="meta") for s, dt in zip(shapes, dts)]
    res = fn(*[to_numpy(x) for x in xs])
    if not isinstance(res, (list, tuple)):
        res = [res]
    return [torch.as_tensor(np.asarray(r)).to(device=device, dtype=dt)
            .reshape(tuple(int(d) for d in s))
            for r, s, dt in zip(res, shapes, dts)]


@register_op("py_func", inputs=("X",), outputs=("Out",))
def _py_func(ctx, op, ins):
    """:310 (py_func_op.cc): the registered callable on the host, its
    results shaped by the ``out_shapes`` / ``out_dtypes`` attrs (JAX's
    ``pure_callback``). Its gradient is the explicit ``py_func_grad``."""
    from ..layers.py_func_registry import get_callable

    fn = get_callable(int(op.attrs.get("forward_callable_id", 0)))
    xs = ins.get("X", [])
    outs = _host_call(fn, xs, op.attrs.get("out_shapes", []),
                      op.attrs.get("out_dtypes", ["float32"]),
                      xs[0].device if xs else ctx.device)
    return {"Out": outs}


@register_op("py_func_grad", inputs=("X", "Out@GRAD"), outputs=("X@GRAD",))
def _py_func_grad(ctx, op, ins):
    """:335: ``backward_func(*x, *out_grads)`` on the host, a gradient a
    X of X's shape and dtype; without a backward_func it raises, as
    JAX's does."""
    from ..layers.py_func_registry import get_callable

    bid = op.attrs.get("backward_callable_id", None)
    if bid is None:
        raise NotImplementedError(
            "differentiating through py_func requires backward_func= "
            "(host callbacks have no automatic vjp)")
    xs = ins.get("X", [])
    dtypes = [str(x.dtype).replace("torch.", "") for x in xs]
    grads = _host_call(get_callable(int(bid)),
                       list(xs) + list(ins.get("Out@GRAD", [])),
                       [tuple(x.shape) for x in xs], dtypes,
                       xs[0].device if xs else ctx.device)
    return {"X@GRAD": grads}


@register_op("expand_pred_like", inputs=("X", "Y"), outputs=("Out",),
             no_grad=("X", "Y"), stop_gradient=True)
def _expand_pred_like(ctx, op, ins):
    """:360: a predicate broadcast to Y's shape (trailing axes added),
    for the select-based control-flow sugar."""
    p = ins["X"][0].to(torch.bool)
    y = ins["Y"][0]
    while p.dim() < y.dim():
        p = p[..., None]
    return {"Out": [p.expand(y.shape).contiguous()]}


@register_op("brelu", inputs=("X",), outputs=("Out",))
def _brelu(ctx, op, ins):
    """:372 (BRelu): ``jnp.clip(x, t_min, t_max)``, the gradient split at
    a bound as JAX's."""
    return {"Out": [_bounded(ins["X"][0], float(op.attrs.get("t_min", 0.0)),
                             float(op.attrs.get("t_max", 24.0)))]}


@register_op("has_inf", inputs=("X",), outputs=("Out",), stop_gradient=True)
def _has_inf(ctx, op, ins):
    """:380: bool [1]."""
    return {"Out": [torch.isinf(ins["X"][0]).any().reshape(1)]}


@register_op("has_nan", inputs=("X",), outputs=("Out",), stop_gradient=True)
def _has_nan(ctx, op, ins):
    """:385: bool [1]."""
    return {"Out": [torch.isnan(ins["X"][0]).any().reshape(1)]}


@register_op("npair_loss", inputs=("Anchor", "Positive", "Labels"),
             outputs=("Out",), no_grad=("Labels",))
def _npair_loss(ctx, op, ins):
    """:390 (layers/loss.py npair_loss): softmax cross entropy over
    anchor . positive^T with the same-label rows as targets, plus
    0.25 l2_reg (mean |a|^2 + mean |p|^2); [1]."""
    a, p = ins["Anchor"][0], ins["Positive"][0]
    labels = ins["Labels"][0].reshape(-1)
    l2 = float(op.attrs.get("l2_reg", 0.002))
    sim = a @ p.T
    tgt = (labels[:, None] == labels[None, :]).to(sim.dtype)
    tgt = tgt / torch.clamp(tgt.sum(1, keepdim=True), min=1.0)
    ce = -torch.mean(torch.sum(tgt * torch.log_softmax(sim, -1), -1))
    reg = l2 * 0.25 * (torch.mean(torch.sum(a * a, 1))
                       + torch.mean(torch.sum(p * p, 1)))
    return {"Out": [(ce + reg).reshape(1)]}
