"""3D / volumetric convolution and pooling, the index pools, unpool and
trilinear interpolation: torch lowerings with the semantics of
``paddle_tpu/ops/vision3d.py`` (its 8 lowerings; reference
operators/conv_op.cc, conv_transpose_op.cc, pool_op.cc,
pool_with_index_op.cc, unpool_op.cc, interpolate_op.cc).

The JAX package computes these outside any Pallas kernel
(``lax.conv_general_dilated``, ``conv_transpose``, ``reduce_window``),
so their lowerings here are ``F.conv3d``, ``F.conv_transpose{2,3}d``,
``F.max_pool{2,3}d`` / ``F.avg_pool3d`` (cuDNN on the card). The index
pools return int32 flat spatial indices, the first of a tied window
(the smallest index), as JAX's do.

``pool3d`` honours ``adaptive`` (``ksize`` is the output's size, the
volume divided exactly, as the port's ``pool2d``); JAX's lowering
ignores the attr, so its ``layers.adaptive_pool3d`` pools windows of
``ksize`` at stride 2 instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op


def _tup(v, n):
    v = list(v) if isinstance(v, (list, tuple)) else [v]
    if len(v) == 1:
        v = v * n
    return tuple(int(i) for i in v[:n])


def _cf(x, fmt):
    """Channels-first view of an NDHWC / NHWC input."""
    return x if fmt in ("NCDHW", "NCHW") else x.movedim(-1, 1)


def _from_cf(x, fmt):
    return x if fmt in ("NCDHW", "NCHW") else x.movedim(1, -1)


def _bias(out, ins):
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape((1, -1) + (1,) * (out.dim() - 2))
    return out


@register_op("conv3d", inputs=("Input", "Filter", "Bias"), outputs=("Output",))
def _conv3d(ctx, op, ins):
    """Filters OIDHW in both layouts; paddings [d, h, w] on both sides."""
    x, w = ins["Input"][0], ins["Filter"][0]
    fmt = op.attrs.get("data_format", "NCDHW")
    out = F.conv3d(_cf(x, fmt), w,
                   stride=_tup(op.attrs.get("strides", [1, 1, 1]), 3),
                   padding=_tup(op.attrs.get("paddings", [0, 0, 0]), 3),
                   dilation=_tup(op.attrs.get("dilations", [1, 1, 1]), 3),
                   groups=int(op.attrs.get("groups", 1)))
    return {"Output": [_from_cf(_bias(out, ins), fmt)]}


@register_op("conv3d_transpose", inputs=("Input", "Filter", "Bias"),
             outputs=("Output",))
def _conv3d_transpose(ctx, op, ins):
    """Filter [in_c, out_c, kd, kh, kw]; the output is (in - 1) * stride
    - 2 * pad + (k - 1) * dilation + 1 a side (JAX's output-space
    padding k_eff - 1 - pad). Grouped transposes are not lowered (JAX's
    lowering has no groups either)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    if int(op.attrs.get("groups", 1)) != 1:
        raise NotImplementedError(
            "conv3d_transpose with groups != 1 is not lowered")
    fmt = op.attrs.get("data_format", "NCDHW")
    out = F.conv_transpose3d(
        _cf(x, fmt), w, stride=_tup(op.attrs.get("strides", [1, 1, 1]), 3),
        padding=_tup(op.attrs.get("paddings", [0, 0, 0]), 3),
        dilation=_tup(op.attrs.get("dilations", [1, 1, 1]), 3))
    return {"Output": [_from_cf(_bias(out, ins), fmt)]}


@register_op("depthwise_conv2d_transpose", inputs=("Input", "Filter", "Bias"),
             outputs=("Output",))
def _depthwise_conv2d_transpose(ctx, op, ins):
    """A transposed convolution a channel (filter [C, 1, kh, kw]), NCHW
    and dilation 1 only, as JAX's."""
    x, w = ins["Input"][0], ins["Filter"][0]
    if op.attrs.get("data_format", "NCHW") != "NCHW":
        raise NotImplementedError(
            "depthwise_conv2d_transpose: only NCHW is lowered; transpose "
            "the input or use conv2d_transpose with groups")
    if any(int(d) != 1 for d in op.attrs.get("dilations", [1, 1])):
        raise NotImplementedError(
            "depthwise_conv2d_transpose: dilation > 1 is not lowered; use "
            "conv2d_transpose with groups")
    out = F.conv_transpose2d(
        x, w, stride=_tup(op.attrs.get("strides", [1, 1]), 2),
        padding=_tup(op.attrs.get("paddings", [0, 0]), 2),
        groups=x.shape[1])
    return {"Output": [_bias(out, ins)]}


@register_op("pool3d", inputs=("X",), outputs=("Out",))
def _pool3d(ctx, op, ins):
    """Max or average over windows (``ceil_mode`` ignored, as in JAX);
    an average over a padded window divides by its count of real
    elements when ``exclusive``, else by the window's size; global
    pooling over the whole volume; ``adaptive`` takes ``ksize`` as the
    output's size."""
    x = ins["X"][0]
    fmt = op.attrs.get("data_format", "NCDHW")
    ptype = op.attrs.get("pooling_type", "max")
    xc = _cf(x, fmt)
    if op.attrs.get("global_pooling", False):
        k, s, p = tuple(xc.shape[2:]), tuple(xc.shape[2:]), (0, 0, 0)
    else:
        k = _tup(op.attrs.get("ksize", [2, 2, 2]), 3)
        s = _tup(op.attrs.get("strides", [2, 2, 2]), 3)
        p = _tup(op.attrs.get("paddings", [0, 0, 0]), 3)
    if op.attrs.get("adaptive", False) and not op.attrs.get(
            "global_pooling", False):
        n, c, d, h, w = xc.shape
        od, oh, ow = k
        if d % od or h % oh or w % ow:
            raise ValueError("adaptive pool3d needs divisible sizes")
        xr = xc.reshape(n, c, od, d // od, oh, h // oh, ow, w // ow)
        out = (torch.amax(xr, dim=(3, 5, 7)) if ptype == "max"
               else torch.mean(xr, dim=(3, 5, 7)))
        return {"Out": [_from_cf(out, fmt)]}
    if ptype == "max":
        out = F.max_pool3d(xc, k, s, p)
    else:
        out = F.avg_pool3d(
            xc, k, s, p,
            count_include_pad=not bool(op.attrs.get("exclusive", True)))
    return {"Out": [_from_cf(out, fmt)]}


def _max_pool_with_index(op, x, nd):
    ones = [1] * nd
    if op.attrs.get("global_pooling", False):
        k, s, p = tuple(x.shape[2:]), tuple(x.shape[2:]), (0,) * nd
    else:
        k = _tup(op.attrs.get("ksize", [2] * nd), nd)
        s = _tup(op.attrs.get("strides", [2] * nd), nd)
        p = _tup(op.attrs.get("paddings", [0] * nd), nd)
    pool = F.max_pool2d if nd == 2 else F.max_pool3d
    vals, idx = pool(x, k, s, p, dilation=ones, return_indices=True)
    return {"Out": [vals], "Mask": [idx.to(torch.int32)]}


@register_op("max_pool2d_with_index", inputs=("X",), outputs=("Out", "Mask"))
def _max_pool2d_with_index(ctx, op, ins):
    """Max pool and the flat H*W index of each window's max."""
    return _max_pool_with_index(op, ins["X"][0], 2)


@register_op("max_pool3d_with_index", inputs=("X",), outputs=("Out", "Mask"))
def _max_pool3d_with_index(ctx, op, ins):
    """Max pool and the flat D*H*W index of each window's max."""
    return _max_pool_with_index(op, ins["X"][0], 3)


@register_op("unpool", inputs=("X", "Indices"), outputs=("Out",),
             no_grad=("Indices",))
def _unpool(ctx, op, ins):
    """The inverse of ``max_pool2d_with_index``: each value added at its
    flat index of an output (in - 1) * stride - 2 * pad + ksize a
    side."""
    x, idx = ins["X"][0], ins["Indices"][0]
    n, c, h, w = x.shape
    ks = _tup(op.attrs.get("ksize", [2, 2]), 2)
    ss = _tup(op.attrs.get("strides", ks), 2)
    ps = _tup(op.attrs.get("paddings", [0, 0]), 2)
    oh = (h - 1) * ss[0] - 2 * ps[0] + ks[0]
    ow = (w - 1) * ss[1] - 2 * ps[1] + ks[1]
    flat = torch.zeros((n, c, oh * ow), dtype=x.dtype, device=x.device)
    out = flat.scatter_add(2, idx.reshape(n, c, -1).long(),
                           x.reshape(n, c, -1))
    return {"Out": [out.reshape(n, c, oh, ow)]}


@register_op("trilinear_interp", inputs=("X", "OutSize"), outputs=("Out",),
             no_grad=("OutSize",))
def _trilinear_interp(ctx, op, ins):
    """NCDHW, one linear pass an axis (D, then H, then W) at JAX's
    source coordinates: i * (in - 1) / (out - 1) with ``align_corners``,
    else max((i + 0.5) * in / out - 0.5, 0)."""
    x = ins["X"][0]
    align = bool(op.attrs.get("align_corners", True))
    sizes = [int(op.attrs.get(a, 0)) for a in ("out_d", "out_h", "out_w")]

    def axis(v, out_len, dim):
        in_len = v.shape[dim]
        i = torch.arange(out_len, device=v.device)
        if align and out_len > 1:
            coords = i * (in_len - 1) / (out_len - 1)
        else:
            coords = torch.clamp((i + 0.5) * torch.tensor(
                in_len / out_len, dtype=torch.float32) - 0.5, min=0)
        lo = torch.clamp(torch.floor(coords).long(), 0, in_len - 1)
        hi = torch.clamp(lo + 1, 0, in_len - 1)
        shape = [1] * v.dim()
        shape[dim] = out_len
        t = (coords - lo).to(v.dtype).reshape(shape)
        return (v.index_select(dim, lo) * (1 - t)
                + v.index_select(dim, hi) * t)

    out = x
    for k, size in enumerate(sizes):
        out = axis(out, size or x.shape[2 + k], 2 + k)
    return {"Out": [out]}

