"""Detection ops, part two: torch lowerings with the semantics of
``paddle_tpu/ops/detection2.py`` (its 10 lowerings: deformable
sampling, position-sensitive ROI pooling, perspective ROIs, the mAP
metric, target assignment and sampling; reference
operators/deformable_conv_op.cc, deformable_conv_v1_op.cc,
deformable_psroi_pooling_op.cc, psroi_pool_op.cc, prroi_pool_op.cc,
detection/roi_perspective_transform_op.cc, detection_map_op.cc,
detection/rpn_target_assign_op.cc, generate_proposal_labels_op.cc,
generate_mask_labels_op.cc).

As in JAX, outputs the reference emits with data-dependent row counts
keep their full static extent with validity masks or weights, and the
sampling grids are bilinear gathers at JAX's static sample counts,
here one batched gather for all rois (or output positions) at once.

``detection_map`` keeps JAX's sequential matching (a detection is a
true positive when it matches a ground truth no earlier detection of
its class matched) as one comparison of each detection against the
earlier ones. ``generate_proposal_labels`` draws its ranking jitter
from the op's generator (``LoweringContext.op_generator``), where JAX
draws from the op's key.
"""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .detection import INF, _roi_chunks, _sample_offsets, _stable_argsort


def _sample(x, b, y, xx):
    """Bilinear samples of image ``b`` of ``x`` [N, C, H, W] at (y, xx),
    zero outside (-1, H) x (-1, W), as JAX's ``_bilinear``
    (``paddle_tpu/ops/detection2.py:25-40``); ``b``, ``y``, ``xx``
    broadcast to one shape S -> [*S, C]."""
    H, W = x.shape[2], x.shape[3]
    valid = (y > -1.0) & (y < H) & (xx > -1.0) & (xx < W)
    y = torch.clamp(y, 0.0, H - 1.0)
    xx = torch.clamp(xx, 0.0, W - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(xx).long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    ly, lx = (y - y0)[..., None], (xx - x0)[..., None]
    v = (x[b, :, y0, x0] * (1 - ly) * (1 - lx)
         + x[b, :, y0, x1] * (1 - ly) * lx
         + x[b, :, y1, x0] * ly * (1 - lx)
         + x[b, :, y1, x1] * ly * lx)
    return torch.where(valid[..., None], v, torch.zeros_like(v))


def _deformable_conv(ctx, op, ins, with_mask):
    x = ins["Input"][0]          # [N, C, H, W]
    offset = ins["Offset"][0]    # [N, 2*dg*kh*kw, Ho, Wo]
    w = ins["Filter"][0]         # [O, C/g, kh, kw]
    mask = ins["Mask"][0] if (with_mask and ins.get("Mask")) else None
    sh, sw = [int(v) for v in op.attrs.get("strides", [1, 1])][:2]
    ph, pw = [int(v) for v in op.attrs.get("paddings", [0, 0])][:2]
    dh, dw = [int(v) for v in op.attrs.get("dilations", [1, 1])][:2]
    groups = int(op.attrs.get("groups", 1))
    dg = int(op.attrs.get("deformable_groups", 1))
    N, C, H, W = x.shape
    O, Cg, kh, kw = w.shape
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    K = kh * kw
    cpg = C // dg  # channels per deformable group
    dev = x.device
    ys0 = (torch.arange(Ho, device=dev) * sh - ph)[:, None, None, None]
    xs0 = (torch.arange(Wo, device=dev) * sw - pw)[None, :, None, None]
    ky = (torch.arange(kh, device=dev) * dh)[None, None, :, None]
    kx = (torch.arange(kw, device=dev) * dw)[None, None, None, :]
    # [N, dg, K, 2, Ho, Wo] -> [N, dg, Ho, Wo, kh, kw] a coordinate
    off = offset.reshape(N, dg, K, 2, Ho, Wo).permute(0, 1, 4, 5, 2, 3)
    oy = off[..., 0].reshape(N, dg, Ho, Wo, kh, kw)
    ox = off[..., 1].reshape(N, dg, Ho, Wo, kh, kw)
    yy = ys0 + ky + oy
    xx = xs0 + kx + ox
    xg = x.reshape(N * dg, cpg, H, W)
    b = (torch.arange(N, device=dev)[:, None] * dg
         + torch.arange(dg, device=dev)[None, :])[..., None, None, None, None]
    vals = _sample(xg, b, yy, xx)   # [N, dg, Ho, Wo, kh, kw, cpg]
    if mask is not None:
        m = mask.reshape(N, dg, K, Ho, Wo).permute(0, 1, 3, 4, 2).reshape(
            N, dg, Ho, Wo, kh, kw, 1)
        vals = vals * m
    # -> [N, Ho, Wo, kh, kw, C], channel g * cpg + c
    patches = vals.permute(0, 2, 3, 4, 5, 1, 6).reshape(N, Ho, Wo, kh, kw, C)
    cpg2 = C // groups
    opg = O // groups
    outs = []
    for g in range(groups):
        p = patches[..., g * cpg2:(g + 1) * cpg2]
        f = w[g * opg:(g + 1) * opg]
        outs.append(torch.einsum("nhwklc,ockl->nohw", p, f))
    return {"Output": [torch.cat(outs, dim=1)]}


@register_op("deformable_conv", inputs=("Input", "Offset", "Mask", "Filter"),
             outputs=("Output",))
def _deformable_conv_v2(ctx, op, ins):
    return _deformable_conv(ctx, op, ins, with_mask=True)


@register_op("deformable_conv_v1", inputs=("Input", "Offset", "Filter"),
             outputs=("Output",))
def _deformable_conv_v1(ctx, op, ins):
    return _deformable_conv(ctx, op, ins, with_mask=False)


def _iou_corner(a, b):
    """Corner-box IoU with JAX's 1e-10 union guard, ``a`` [..., 4]
    broadcast against ``b`` [..., 4]."""
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(ix2 - ix1, min=0.0) * torch.clamp(iy2 - iy1, min=0.0)
    ua = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
          + (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]) - inter)
    return inter / torch.clamp(ua, min=1e-10)


def _pair_iou(a, b):
    """[A, B] IoU of every row of ``a`` [A, 4] against ``b`` [B, 4]."""
    return _iou_corner(a[:, None, :], b[None, :, :])


def _roi_batch_idx(ins, slot, R, n_images):
    """Each roi's image: JAX's ``jnp.repeat(arange, nums,
    total_repeat_length=R)`` (the last image past the counts), as the
    running sum's ``searchsorted``."""
    dev = ins["ROIs"][0].device
    if ins.get(slot):
        nums = ins[slot][0].reshape(-1)
        idx = torch.searchsorted(torch.cumsum(nums, 0),
                                 torch.arange(R, device=dev).to(nums.dtype),
                                 right=True)
        return torch.clamp(idx, max=min(nums.shape[0], n_images) - 1)
    return torch.zeros((R,), dtype=torch.int64, device=dev)


def _pool_bins(x, bidx, rois, scale, ph, pw, n, lo, extent, select):
    """Mean of n x n bilinear samples a bin: rois [R, 4] mapped by
    ``lo`` / ``extent`` to (x1, y1, rh, rw); ``select`` (ph * pw groups
    of channels) picks bin (i, j)'s channel group i * pw + j -> [R, oc,
    ph, pw], else all channels -> [R, C, ph, pw]."""
    N, C, H, W = x.shape
    R = rois.shape[0]
    iy = _sample_offsets(ph, n, x).reshape(-1)
    ix = _sample_offsets(pw, n, x).reshape(-1)
    outs = []
    for sl in _roi_chunks(R, ph * n * pw * n * C):
        x1, y1, rh, rw = extent(lo(rois[sl], scale))
        ys = y1[:, None] + iy[None, :] * (rh / ph)[:, None]
        xs = x1[:, None] + ix[None, :] * (rw / pw)[:, None]
        vals = _sample(x, bidx[sl][:, None, None], ys[:, :, None],
                       xs[:, None, :])          # [r, ph*n, pw*n, C]
        r = vals.shape[0]
        vals = vals.reshape(r, ph, n, pw, n, C).mean(dim=(2, 4))
        if select:
            oc = C // (ph * pw)
            vals = vals.reshape(r, ph, pw, oc, ph * pw)
            sel = (torch.arange(ph, device=x.device)[:, None] * pw
                   + torch.arange(pw, device=x.device)[None, :])
            vals = torch.gather(vals, 4, sel[None, :, :, None, None].expand(
                r, ph, pw, oc, 1))[..., 0]
        outs.append(vals.permute(0, 3, 1, 2))
    return torch.cat(outs, 0)


@register_op("psroi_pool", inputs=("X", "ROIs", "RoisNum"), outputs=("Out",),
             no_grad=("ROIs", "RoisNum"))
def _psroi_pool(ctx, op, ins):
    """Position-sensitive ROI average pooling (reference
    psroi_pool_op.cc): bin (i, j) pools channel group (i * pw + j),
    2 x 2 samples a bin as JAX's."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    scale = float(op.attrs.get("spatial_scale", 1.0))
    ph = int(op.attrs.get("pooled_height", 1))
    pw = int(op.attrs.get("pooled_width", 1))
    bidx = _roi_batch_idx(ins, "RoisNum", rois.shape[0], x.shape[0])

    def lo(r, s):
        return (torch.round(r[:, 0]) * s, torch.round(r[:, 1]) * s,
                (torch.round(r[:, 2]) + 1.0) * s,
                (torch.round(r[:, 3]) + 1.0) * s)

    def extent(c):
        x1, y1, x2, y2 = c
        return x1, y1, torch.clamp(y2 - y1, min=0.1), \
            torch.clamp(x2 - x1, min=0.1)

    return {"Out": [_pool_bins(x, bidx, rois, scale, ph, pw, 2, lo, extent,
                               select=True)]}


def _scaled(r, s):
    return r[:, 0] * s, r[:, 1] * s, r[:, 2] * s, r[:, 3] * s


@register_op("prroi_pool", inputs=("X", "ROIs", "BatchRoINums"),
             outputs=("Out",), no_grad=("ROIs", "BatchRoINums"))
def _prroi_pool(ctx, op, ins):
    """Precise ROI pooling (reference prroi_pool_op.cc), JAX's form:
    the mean of 4 x 4 bilinear samples a bin."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    scale = float(op.attrs.get("spatial_scale", 1.0))
    ph = int(op.attrs.get("pooled_height", 1))
    pw = int(op.attrs.get("pooled_width", 1))
    bidx = _roi_batch_idx(ins, "BatchRoINums", rois.shape[0], x.shape[0])

    def extent(c):
        x1, y1, x2, y2 = c
        return x1, y1, torch.clamp(y2 - y1, min=1e-3), \
            torch.clamp(x2 - x1, min=1e-3)

    return {"Out": [_pool_bins(x, bidx, rois, scale, ph, pw, 4, _scaled,
                               extent, select=False)]}


@register_op("deformable_psroi_pooling",
             inputs=("Input", "ROIs", "Trans", "RoisNum"),
             outputs=("Output", "TopCount"), no_grad=("ROIs", "RoisNum"))
def _deformable_psroi_pooling(ctx, op, ins):
    """PS-ROI pooling with learned per-part offsets (reference
    deformable_psroi_pooling_op.cc): each bin's sampling window shifts
    by trans * trans_std * roi_size."""
    x, rois = ins["Input"][0], ins["ROIs"][0]
    trans = ins["Trans"][0] if ins.get("Trans") else None
    scale = float(op.attrs.get("spatial_scale", 1.0))
    oc = int(op.attrs.get("output_dim", 1))
    ph = int(op.attrs.get("pooled_height", 1))
    pw = int(op.attrs.get("pooled_width", 1))
    trans_std = float(op.attrs.get("trans_std", 0.1))
    N, C, H, W = x.shape
    R = rois.shape[0]
    n = 2
    dev = x.device
    bidx = _roi_batch_idx(ins, "RoisNum", R, N)
    x1, y1, x2, y2 = _scaled(rois, scale)
    rh = torch.clamp(y2 - y1, min=0.1)
    rw = torch.clamp(x2 - x1, min=0.1)
    iy = _sample_offsets(ph, n, x)   # [ph, n]
    ix = _sample_offsets(pw, n, x)   # [pw, n]
    if trans is not None:
        t = trans.reshape(R, 2, -1)[:, :, :ph * pw].reshape(R, 2, ph, pw)
        dy, dx = t[:, 0], t[:, 1]
    else:
        dy = dx = torch.zeros((R, ph, pw), dtype=x.dtype, device=dev)
    r3 = (slice(None), None, None, None)
    # [R, ph, pw, n] each
    ybins = y1[r3] + iy[None, :, None, :] * (rh / ph)[r3] + \
        (dy * trans_std * rh[:, None, None])[..., None]
    xbins = x1[r3] + ix[None, None, :, :] * (rw / pw)[r3] + \
        (dx * trans_std * rw[:, None, None])[..., None]
    # every (sample y, sample x) of each bin: [R, ph, pw, n, n]
    vals = _sample(x.reshape(N, oc * ph * pw, H, W),
                   bidx[:, None, None, None, None], ybins[..., :, None],
                   xbins[..., None, :])
    vals = vals.mean(dim=(3, 4)).reshape(R, ph, pw, oc, ph * pw)
    sel = (torch.arange(ph, device=dev)[:, None] * pw
           + torch.arange(pw, device=dev)[None, :])
    out = torch.gather(vals, 4, sel[None, :, :, None, None].expand(
        R, ph, pw, oc, 1))[..., 0].permute(0, 3, 1, 2)
    return {"Output": [out], "TopCount": [torch.ones_like(out)]}


@register_op("roi_perspective_transform", inputs=("X", "ROIs", "RoisNum"),
             outputs=("Out", "Mask", "TransformMatrix", "Out2InIdx",
                      "Out2InWeights"),
             no_grad=("ROIs", "RoisNum"), stop_gradient=True)
def _roi_perspective_transform(ctx, op, ins):
    """Warp quadrilateral ROIs to fixed rectangles (reference
    detection/roi_perspective_transform_op.cc): per ROI solve the 8-dof
    homography mapping the output rect onto the quad (JAX's 8 x 8
    system plus 1e-6 I), then bilinear sample."""
    x, rois = ins["X"][0], ins["ROIs"][0]  # rois [R, 8] quad corners
    scale = float(op.attrs.get("spatial_scale", 1.0))
    th = int(op.attrs.get("transformed_height", 1))
    tw = int(op.attrs.get("transformed_width", 1))
    N, C, H, W = x.shape
    R = rois.shape[0]
    dev, dt = x.device, x.dtype
    bidx = _roi_batch_idx(ins, "RoisNum", R, N)
    src = [(0.0, 0.0), (tw - 1.0, 0.0), (tw - 1.0, th - 1.0), (0.0, th - 1.0)]
    dst = rois.reshape(R, 4, 2) * scale
    zero = torch.zeros((R,), dtype=dt, device=dev)
    one = torch.ones((R,), dtype=dt, device=dev)
    rows, rhs = [], []
    for k, (sx, sy) in enumerate(src):
        dx, dy = dst[:, k, 0], dst[:, k, 1]
        rows.append(torch.stack([one * sx, one * sy, one, zero, zero, zero,
                                 -dx * sx, -dx * sy], -1))
        rows.append(torch.stack([zero, zero, zero, one * sx, one * sy, one,
                                 -dy * sx, -dy * sy], -1))
        rhs.extend([dx, dy])
    A = torch.stack(rows, 1)           # [R, 8, 8]
    b = torch.stack(rhs, 1)            # [R, 8]
    h = torch.linalg.solve(A + 1e-6 * torch.eye(8, dtype=dt, device=dev),
                           b)
    Hm = torch.cat([h, one[:, None]], 1).reshape(R, 3, 3)
    gy, gx = torch.meshgrid(torch.arange(th, dtype=dt, device=dev),
                            torch.arange(tw, dtype=dt, device=dev),
                            indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1),
                       torch.ones(th * tw, dtype=dt, device=dev)])
    mapped = Hm @ pts                  # [R, 3, th*tw]
    den = torch.clamp(torch.abs(mapped[:, 2]), min=1e-6)
    sign = torch.sign(mapped[:, 2] + 1e-12)
    mx = mapped[:, 0] / den * sign
    my = mapped[:, 1] / den * sign
    vals = _sample(x, bidx[:, None], my, mx)        # [R, th*tw, C]
    valid = (mx > -1) & (mx < W) & (my > -1) & (my < H)
    zi = torch.zeros((1,), dtype=torch.int32, device=dev)
    return {"Out": [vals.permute(0, 2, 1).reshape(R, C, th, tw)],
            "Mask": [valid.reshape(R, 1, th, tw).to(torch.int32)],
            "TransformMatrix": [Hm.reshape(R, 9)],
            "Out2InIdx": [zi], "Out2InWeights": [zi.to(torch.float32)]}


@register_op("detection_map", inputs=("DetectRes", "Label", "HasState",
                                      "PosCount", "TruePos", "FalsePos"),
             outputs=("MAP", "AccumPosCount", "AccumTruePos",
                      "AccumFalsePos"),
             stop_gradient=True)
def _detection_map(ctx, op, ins):
    """Mean average precision (reference detection_map_op.cc), one
    batch's integral or 11-point AP over dense padded detections.
    DetectRes rows: [label, score, x1, y1, x2, y2] (label < 0 = pad);
    Label rows: [label, x1, y1, x2, y2] or [label, difficult, x1, ...].
    The accumulator state passes through, as JAX's."""
    det = ins["DetectRes"][0]
    gt = ins["Label"][0]
    iou_t = float(op.attrs.get("overlap_threshold", 0.5))
    ap_type = str(op.attrs.get("ap_type", "integral"))
    class_num = int(op.attrs.get("class_num", 21))
    bg = int(op.attrs.get("background_label", 0))
    eval_difficult = bool(op.attrs.get("evaluate_difficult", True))
    has_difficult = bool(op.attrs.get("has_difficult", gt.shape[1] == 6))
    dev = det.device
    M, G = det.shape[0], gt.shape[0]
    gl = gt[:, 0]
    gbox = gt[:, -4:]
    # VOC convention: with evaluate_difficult=False, difficult gts are
    # neither counted in npos nor penalized when matched
    difficult = (gt[:, 1] > 0) if has_difficult else \
        torch.zeros((G,), dtype=torch.bool, device=dev)
    dl, ds, dbox = det[:, 0], det[:, 1], det[:, 2:6]
    dvalid = dl >= 0
    gvalid = gl >= 0
    ious = _pair_iou(dbox, gbox)                      # [M, G]
    earlier = torch.ones((M, M), dtype=torch.bool, device=dev).tril(-1)
    ninf = torch.full_like(ds, -INF)
    aps = []
    for c in range(class_num):
        if c == bg:
            continue
        c = float(c)
        counted = gvalid & (eval_difficult | ~difficult)
        npos = (counted & (gl == c)).sum()
        dmask = dvalid & (dl == c)
        order = _stable_argsort(-torch.where(dmask, ds, ninf))
        matched = (ious > iou_t) & (gl[None, :] == c) & gvalid[None, :]
        best = torch.argmax(torch.where(matched, ious,
                                        torch.full_like(ious, -1.0)), dim=1)
        has = matched.any(1)
        sorted_best = best[order]
        sorted_has = has[order] & dmask[order]
        # JAX's scan: a hit is a true positive unless an earlier hit in
        # the sorted order took the same ground truth
        taken = (earlier & sorted_has[None, :]
                 & (sorted_best[None, :] == sorted_best[:, None])).any(1)
        tps = sorted_has & ~taken
        # matches to skipped difficult gts are ignored entirely
        ignored = sorted_has & difficult[sorted_best] & (not eval_difficult)
        tps = tps & ~ignored
        fps = dmask[order] & ~tps & ~ignored
        ctp = torch.cumsum(tps.to(torch.float32), 0)
        cfp = torch.cumsum(fps.to(torch.float32), 0)
        recall = ctp / torch.clamp(npos.to(torch.float32), min=1.0)
        precision = ctp / torch.clamp(ctp + cfp, min=1e-10)
        if ap_type == "11point":
            # jnp.linspace(0, 1, 11): i * float32(0.1)
            pts = torch.arange(11, dtype=torch.float32, device=dev) * \
                torch.tensor(0.1, dtype=torch.float32, device=dev)
            ap = torch.where(recall[None, :] >= pts[:, None],
                             precision[None, :],
                             torch.zeros_like(precision)[None, :]).amax(
                1).mean()
        else:  # integral
            drecall = torch.diff(recall, prepend=torch.zeros(
                1, dtype=recall.dtype, device=dev))
            ap = (precision * drecall).sum()
        aps.append(torch.where(npos > 0, ap, torch.full_like(ap, float("nan"))))
    mAP = torch.nanmean(torch.stack(aps)) * 100.0 if aps else \
        torch.full((), float("nan"), device=dev)

    def passthru(slot, shape):
        return ins[slot][0] if ins.get(slot) else \
            torch.zeros(shape, dtype=torch.float32, device=dev)

    return {
        "MAP": [torch.where(torch.isnan(mAP), torch.zeros_like(mAP),
                            mAP).reshape(1)],
        "AccumPosCount": [passthru("PosCount", (1, 1))],
        "AccumTruePos": [passthru("TruePos", (1, 2))],
        "AccumFalsePos": [passthru("FalsePos", (1, 2))],
    }


def _encode(ga, ra):
    """JAX's box targets of ``ga`` against ``ra`` (both [R, 4], widths
    guarded at 1e-6)."""
    rw = torch.clamp(ra[:, 2] - ra[:, 0], min=1e-6)
    rh = torch.clamp(ra[:, 3] - ra[:, 1], min=1e-6)
    rcx = ra[:, 0] + rw * 0.5
    rcy = ra[:, 1] + rh * 0.5
    gw = torch.clamp(ga[:, 2] - ga[:, 0], min=1e-6)
    gh = torch.clamp(ga[:, 3] - ga[:, 1], min=1e-6)
    gcx = ga[:, 0] + gw * 0.5
    gcy = ga[:, 1] + gh * 0.5
    return torch.stack([(gcx - rcx) / rw, (gcy - rcy) / rh,
                        torch.log(gw / rw), torch.log(gh / rh)], 1)


def _crowd(ins, like):
    if ins.get("IsCrowd"):
        return ins["IsCrowd"][0].reshape(-1) != 0
    return torch.zeros(like.shape, dtype=torch.bool, device=like.device)


@register_op("retinanet_target_assign",
             inputs=("Anchor", "GtBoxes", "GtLabels", "IsCrowd", "ImInfo"),
             outputs=("LocationIndex", "ScoreIndex", "TargetLabel",
                      "TargetBBox", "BBoxInsideWeight", "ForegroundNumber"),
             stop_gradient=True)
def _retinanet_target_assign(ctx, op, ins):
    """Anchor -> gt assignment for RetinaNet (reference
    rpn_target_assign_op.cc RetinanetTargetAssign): IoU >= pos_thresh
    is positive (label = gt label), IoU < neg_thresh is background
    (label 0), in-between ignored (-1). Index outputs are the full
    anchor range, the mask in TargetLabel / BBoxInsideWeight."""
    anchors = ins["Anchor"][0]       # [A, 4]
    gtb = ins["GtBoxes"][0]          # [G, 4]
    gtl = ins["GtLabels"][0].reshape(-1)  # [G]
    pos_t = float(op.attrs.get("positive_overlap", 0.5))
    neg_t = float(op.attrs.get("negative_overlap", 0.4))
    A = anchors.shape[0]
    gvalid = (gtl > 0) & ~_crowd(ins, gtl)
    ious = _pair_iou(anchors, gtb)
    ious = torch.where(gvalid[None, :], ious, torch.full_like(ious, -1.0))
    best_gt = torch.argmax(ious, dim=1)
    best_iou = ious.amax(1)
    pos = best_iou >= pos_t
    neg = best_iou < neg_t
    label = torch.where(pos, gtl[best_gt],
                        torch.where(neg, 0, -1).to(gtl.dtype))
    w = pos.to(torch.float32)[:, None]
    ar = torch.arange(A, dtype=torch.int32, device=anchors.device)
    return {
        "LocationIndex": [ar],
        "ScoreIndex": [ar.clone()],
        "TargetLabel": [label.to(torch.int32).reshape(A, 1)],
        "TargetBBox": [_encode(gtb[best_gt], anchors) * w],
        "BBoxInsideWeight": [w.expand(A, 4).contiguous()],
        "ForegroundNumber": [pos.sum().to(torch.int32).reshape(1, 1)],
    }


@register_op("generate_proposal_labels",
             inputs=("RpnRois", "GtClasses", "IsCrowd", "GtBoxes", "ImInfo"),
             outputs=("Rois", "LabelsInt32", "BboxTargets",
                      "BboxInsideWeights", "BboxOutsideWeights"),
             stop_gradient=True)
def _generate_proposal_labels(ctx, op, ins):
    """Sample training ROIs for the RCNN head (reference
    detection/generate_proposal_labels_op.cc), JAX's static form: label
    each proposal by its best-IoU gt (fg >= fg_thresh, bg in [bg_lo,
    bg_hi)), rank each pool by IoU plus a jitter of at most 1e-3 drawn
    uniformly from the op's generator, and keep the top of each."""
    rois = ins["RpnRois"][0]         # [R, 4]
    gtc = ins["GtClasses"][0].reshape(-1)
    gtb = ins["GtBoxes"][0]
    bs = int(op.attrs.get("batch_size_per_im", 256))
    fg_frac = float(op.attrs.get("fg_fraction", 0.25))
    fg_t = float(op.attrs.get("fg_thresh", 0.5))
    bg_hi = float(op.attrs.get("bg_thresh_hi", 0.5))
    bg_lo = float(op.attrs.get("bg_thresh_lo", 0.0))
    R = rois.shape[0]
    bs = min(bs, R)
    n_fg = max(1, int(bs * fg_frac))
    n_bg = bs - n_fg
    ious = _pair_iou(rois, gtb)
    ious = torch.where(((gtc > 0) & ~_crowd(ins, gtc))[None, :], ious,
                       torch.full_like(ious, -1.0))
    best_gt = torch.argmax(ious, dim=1)
    best_iou = ious.amax(1)
    is_fg = best_iou >= fg_t
    is_bg = (best_iou < bg_hi) & (best_iou >= bg_lo)
    u = torch.rand((R,), generator=ctx.op_generator(op),
                   device=ctx.device).to(rois.device) if not rois.is_meta \
        else torch.zeros((R,), device=rois.device)
    jitter = u * 1e-3
    ninf = torch.full_like(best_iou, -INF)
    fg_idx = _stable_argsort(-torch.where(is_fg, best_iou + jitter,
                                          ninf))[:n_fg]
    bg_idx = _stable_argsort(-torch.where(is_bg, jitter, ninf))[:n_bg]
    keep = torch.cat([fg_idx, bg_idx])
    sel_rois = rois[keep]
    # under-filled pools pull in rows that are neither fg nor bg: a slot
    # is valid only if drawn from its own pool; invalid slots get label
    # -1 and zero weights
    slot_is_fg = is_fg[fg_idx]
    slot_is_bg = is_bg[bg_idx] & ~is_fg[bg_idx]
    sel_fg = torch.cat([slot_is_fg, torch.zeros((n_bg,), dtype=torch.bool,
                                                device=rois.device)])
    valid = torch.cat([slot_is_fg, slot_is_bg])
    labels = torch.where(sel_fg, gtc[best_gt[keep]],
                         torch.where(valid, 0, -1).to(gtc.dtype)).to(
        torch.int32)
    w = sel_fg.to(torch.float32)[:, None]
    ww = w.expand(bs, 4).contiguous()
    return {
        "Rois": [sel_rois],
        "LabelsInt32": [labels.reshape(-1, 1)],
        "BboxTargets": [_encode(gtb[best_gt[keep]], sel_rois) * w],
        "BboxInsideWeights": [ww],
        "BboxOutsideWeights": [ww.clone()],
    }


@register_op("generate_mask_labels",
             inputs=("ImInfo", "GtClasses", "IsCrowd", "GtSegms", "Rois",
                     "LabelsInt32"),
             outputs=("MaskRois", "RoiHasMaskInt32", "MaskInt32"),
             stop_gradient=True)
def _generate_mask_labels(ctx, op, ins):
    """Mask-RCNN mask targets (reference
    detection/generate_mask_labels_op.cc): each foreground ROI's matched
    gt polygon rasterized into a resolution x resolution grid over the
    ROI by the even-odd crossing rule. GtSegms is [G, V, 2] polygons
    (padded by repeating the last vertex); the output is JAX's
    class-expanded [R, num_classes * M * M], -1 off the target class."""
    rois = ins["Rois"][0]                       # [R, 4]
    labels = ins["LabelsInt32"][0].reshape(-1)  # [R]
    segms = ins["GtSegms"][0]                   # [G, V, 2]
    gtc = ins["GtClasses"][0].reshape(-1)
    M = int(op.attrs.get("resolution", 14))
    num_classes = int(op.attrs.get("num_classes", 81))
    R = rois.shape[0]
    dev = rois.device
    seg_box = torch.stack([segms[:, :, 0].amin(1), segms[:, :, 1].amin(1),
                           segms[:, :, 0].amax(1), segms[:, :, 1].amax(1)], 1)
    ious = _pair_iou(rois, seg_box)
    ious = torch.where(((gtc > 0) & ~_crowd(ins, gtc))[None, :], ious,
                       torch.full_like(ious, -1.0))
    poly = segms[torch.argmax(ious, dim=1)]     # [R, V, 2]
    grid = (torch.arange(M, device=dev) + 0.5) / M
    gx = rois[:, 0:1] + grid[None, :] * torch.clamp(rois[:, 2] - rois[:, 0],
                                                    min=1e-6)[:, None]
    gy = rois[:, 1:2] + grid[None, :] * torch.clamp(rois[:, 3] - rois[:, 1],
                                                    min=1e-6)[:, None]
    px, py = poly[:, None, None, :, 0], poly[:, None, None, :, 1]
    qx, qy = torch.roll(px, -1, dims=-1), torch.roll(py, -1, dims=-1)
    yy = gy[:, :, None, None]                    # [R, M, 1, 1]
    xx = gx[:, None, :, None]                    # [R, 1, M, 1]
    cond = ((py <= yy) & (qy > yy)) | ((qy <= yy) & (py > yy))
    t = (yy - py) / torch.where(qy != py, qy - py,
                                torch.full_like(qy, 1e-9))
    cx = px + t * (qx - px)
    masks = ((cond & (cx > xx)).sum(-1) % 2).to(torch.int32)   # [R, M, M]
    is_fg = labels > 0
    flat = (masks * is_fg[:, None, None].to(torch.int32)).reshape(R, M * M)
    exp = torch.full((R, num_classes, M * M), -1, dtype=torch.int32,
                     device=dev)
    exp[torch.arange(R, device=dev), labels.long()] = flat
    return {
        "MaskRois": [rois],
        "RoiHasMaskInt32": [is_fg.to(torch.int32).reshape(R, 1)],
        "MaskInt32": [exp.reshape(R, num_classes * M * M)],
    }
