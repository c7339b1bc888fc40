"""Detection ops, part one: torch lowerings with the semantics of
``paddle_tpu/ops/detection.py`` (its 24 lowerings; reference
operators/detection/, roi_align_op.cc, roi_pool_op.cc).

The JAX package computes every one of these outside any Pallas kernel,
so they are plain torch ops here, on the card as on the CPU. Outputs
whose row counts depend on the data keep JAX's fixed extent with
validity masks or counts.

Greedy NMS (``_greedy_nms``) is JAX's ``fori_loop`` (:150-177) run for
every (image, class) pair at once: each iteration picks the best live
box of each pair (the first of equal scores, as ``jnp.argmax``) and
suppresses the boxes whose IoU with it, one row computed from the
picked box, passes the threshold (decayed by ``eta`` once an
iteration, as JAX's). JAX runs ``max_picks`` iterations over an M x M
IoU matrix; an iteration after a pair's last candidate picks nothing,
so the loop stops once no pair has one. A pair also stops at ``cap``
picks: its later picks score below (or tie at a higher index than)
its first ``cap``, so a caller that keeps the best ``cap`` rows of all
pairs never sees them. ``nms_top_k > 0`` caps the picks a pair, as in
JAX.

Sorts are stable, as ``jnp.argsort``; ``lax.top_k``'s order among ties
(the lower index first) is ``beam.top_k_lower_index_first``'s.

Two faults of JAX's are not copied (ROADMAP §C): ``box_clip`` clips
each image to its own ``ImInfo`` row, and ``distribute_fpn_proposals``
routes the rows of every image ``RoisNum`` counts.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .beam import top_k_lower_index_first

INF = float("inf")


def _clip(x, lo=None, hi=None):
    """``jnp.clip``: maximum with ``lo``, then minimum with ``hi``;
    either may be a tensor."""
    if lo is not None:
        x = torch.maximum(x, lo) if torch.is_tensor(lo) else \
            torch.clamp(x, min=lo)
    if hi is not None:
        x = torch.minimum(x, hi) if torch.is_tensor(hi) else \
            torch.clamp(x, max=hi)
    return x


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _stable_argsort(x, dim=-1):
    return torch.sort(x, dim=dim, stable=True).indices


def _rank(order):
    """The inverse permutation of ``order`` along its last axis:
    ``jnp.argsort(order)``."""
    idx = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, idx)


def _from_numpy(ctx, op, key, build):
    """Arrays that depend on attrs and static shapes only, built by
    ``build()`` in numpy once per (op, key) and kept on the run's
    device."""
    cache = ctx.constant(op, dict)
    hit = cache.get(key)
    if hit is None:
        hit = [torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)
               for a in build()]
        cache[key] = hit
    return hit


@register_op("box_coder", inputs=("PriorBox", "PriorBoxVar", "TargetBox"),
             outputs=("OutputBox",), stop_gradient=True)
def _box_coder(ctx, op, ins):
    prior = ins["PriorBox"][0]  # [M, 4] (xmin, ymin, xmax, ymax)
    target = ins["TargetBox"][0]
    code_type = op.attrs.get("code_type", "encode_center_size")
    norm = bool(op.attrs.get("box_normalized", True))
    off = 0.0 if norm else 1.0
    pw = prior[:, 2] - prior[:, 0] + off
    ph = prior[:, 3] - prior[:, 1] + off
    pcx = prior[:, 0] + pw / 2
    pcy = prior[:, 1] + ph / 2
    if ins.get("PriorBoxVar"):
        pv = ins["PriorBoxVar"][0]
    else:
        pv = torch.ones((4,), dtype=prior.dtype, device=prior.device)
    if "encode" in code_type:
        tw = target[:, 2] - target[:, 0] + off
        th = target[:, 3] - target[:, 1] + off
        tcx = target[:, 0] + tw / 2
        tcy = target[:, 1] + th / 2
        out = torch.stack([
            (tcx - pcx) / pw / pv[..., 0],
            (tcy - pcy) / ph / pv[..., 1],
            torch.log(tw / pw) / pv[..., 2],
            torch.log(th / ph) / pv[..., 3]], dim=-1)
    else:
        t = target  # [N, M, 4]
        ocx = pv[..., 0] * t[..., 0] * pw + pcx
        ocy = pv[..., 1] * t[..., 1] * ph + pcy
        ow = torch.exp(pv[..., 2] * t[..., 2]) * pw
        oh = torch.exp(pv[..., 3] * t[..., 3]) * ph
        out = torch.stack([ocx - ow / 2, ocy - oh / 2, ocx + ow / 2 - off,
                           ocy + oh / 2 - off], dim=-1)
    return {"OutputBox": [out]}


@register_op("iou_similarity", inputs=("X", "Y"), outputs=("Out",),
             stop_gradient=True)
def _iou_similarity(ctx, op, ins):
    x, y = ins["X"][0], ins["Y"][0]  # [N, 4], [M, 4]
    norm = bool(op.attrs.get("box_normalized", True))
    return {"Out": [_pairwise_iou(x, y, normalized=norm)]}


def _prior_box_arrays(attrs, h, w, ih, iw):
    """JAX's numpy construction (``paddle_tpu/ops/detection.py:65-115``)."""
    min_sizes = [float(s) for s in attrs.get("min_sizes", [])]
    max_sizes = [float(s) for s in attrs.get("max_sizes", [])]
    ars = [float(a) for a in attrs.get("aspect_ratios", [1.0])]
    flip = bool(attrs.get("flip", False))
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    clip = bool(attrs.get("clip", False))
    offset = float(attrs.get("offset", 0.5))
    sw, sh = iw / w, ih / h
    full_ars = []
    for a in ars:
        full_ars.append(a)
        if flip and a != 1.0:
            full_ars.append(1.0 / a)
    boxes = []
    for ms_i, ms in enumerate(min_sizes):
        sizes = [(ms, ms)]
        for a in full_ars:
            if a != 1.0:
                sizes.append((ms * (a ** 0.5), ms / (a ** 0.5)))
        if max_sizes:
            mx = max_sizes[ms_i]
            sizes.insert(1, ((ms * mx) ** 0.5, (ms * mx) ** 0.5))
        boxes.append(sizes)
    cy, cx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cx = (cx + offset) * sw
    cy = (cy + offset) * sh
    all_boxes = []
    for sizes in boxes:
        for bw, bh in sizes:
            all_boxes.append(np.stack([(cx - bw / 2) / iw, (cy - bh / 2) / ih,
                                       (cx + bw / 2) / iw, (cy + bh / 2) / ih],
                                      axis=-1))
    out = np.stack(all_boxes, axis=2).reshape(h, w, -1, 4)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.tile(np.array(variances, dtype=np.float32), out.shape[:3] + (1,))
    return out.astype(np.float32), var


@register_op("prior_box", inputs=("Input", "Image"),
             outputs=("Boxes", "Variances"), stop_gradient=True)
def _prior_box(ctx, op, ins):
    feat, img = ins["Input"][0], ins["Image"][0]
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    boxes, var = _from_numpy(ctx, op, (h, w, ih, iw),
                             lambda: _prior_box_arrays(op.attrs, h, w, ih, iw))
    return {"Boxes": [boxes], "Variances": [var]}


@register_op("box_clip", inputs=("Input", "ImInfo"), outputs=("Output",),
             stop_gradient=True)
def _box_clip(ctx, op, ins):
    """Each image's boxes clipped to its own ``ImInfo`` row (height,
    width) when the boxes carry the image dim, [N, ..., 4] against [N,
    3]; else to the first row. JAX's clips every image to the first
    row's size (ROADMAP §C)."""
    boxes, im_info = ins["Input"][0], ins["ImInfo"][0]
    info = im_info.reshape(-1, im_info.shape[-1])
    if boxes.dim() > 2 and info.shape[0] == boxes.shape[0] > 1:
        shape = (-1,) + (1,) * (boxes.dim() - 2)
        h, w = (info[:, 0] - 1).reshape(shape), (info[:, 1] - 1).reshape(shape)
    else:
        h, w = info[0, 0] - 1, info[0, 1] - 1
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    out = torch.stack([_clip(boxes[..., 0], zero, w),
                       _clip(boxes[..., 1], zero, h),
                       _clip(boxes[..., 2], zero, w),
                       _clip(boxes[..., 3], zero, h)], dim=-1)
    return {"Output": [out]}


# -- pairwise helpers -------------------------------------------------------


def _pairwise_iou(a, b, normalized=True):
    """[..., N, M] IoU of boxes ``a`` [..., N, 4] against ``b`` [..., M,
    4] (leading dims broadcast)."""
    off = 0.0 if normalized else 1.0
    area_a = (a[..., 2] - a[..., 0] + off) * (a[..., 3] - a[..., 1] + off)
    area_b = (b[..., 2] - b[..., 0] + off) * (b[..., 3] - b[..., 1] + off)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + off, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :]
                               - inter, min=1e-10)


def _iou_row(a, b, area_b, off):
    """Row ``j`` of ``_pairwise_iou(boxes, boxes)``: ``a`` [..., 1, 4] the
    picked boxes, ``b`` [..., M, 4] all boxes, ``area_b`` their areas."""
    area_a = (a[..., 2] - a[..., 0] + off) * (a[..., 3] - a[..., 1] + off)
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt + off, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-10)


def _greedy_nms(boxes, scores, iou_threshold, score_threshold, max_picks,
                eta=1.0, normalized=True, cap=None, stats=None):
    """JAX's greedy hard NMS for a batch of pairs -> picked mask shaped
    as ``scores`` [..., M]; ``boxes`` [..., M, 4] broadcasts against it
    (one box set for every class of an image). A pair stops at ``cap``
    picks (module docstring). ``stats``, a dict, gets the iterations run
    under ``"nms_iterations"``."""
    M = scores.shape[-1]
    lead = scores.shape[:-1]
    off = 0.0 if normalized else 1.0
    area_b = (boxes[..., 2] - boxes[..., 0] + off) * \
        (boxes[..., 3] - boxes[..., 1] + off)
    boxes = boxes.expand(*lead, M, 4)
    # a suppressed or filtered box scores -inf (JAX's ``sup`` mask)
    s = torch.where(scores < score_threshold,
                    torch.full_like(scores, -INF), scores)
    picked = torch.zeros(scores.shape, dtype=torch.bool,
                         device=scores.device)
    n_picked = torch.zeros(lead, dtype=torch.int64, device=scores.device)
    # JAX's threshold is a float32 scalar decayed in float32
    thr = np.float32(iou_threshold)
    limit = int(max_picks)
    cap = limit if cap is None else min(int(cap), limit)
    done = 0
    for _ in range(limit if not scores.is_meta else 0):
        live = torch.where((n_picked >= cap)[..., None],
                           torch.full_like(s, -INF), s)
        j = torch.argmax(live, dim=-1, keepdim=True)       # first max
        ok = torch.gather(live, -1, j)[..., 0] > -INF
        if not bool(ok.any()):
            break
        done += 1
        pj = torch.gather(boxes, -2, j[..., None].expand(*lead, 1, 4))
        iou = _iou_row(pj, boxes, area_b, off)
        s = torch.where(ok[..., None] & (iou > float(thr)),
                        torch.full_like(s, -INF), s)
        s = s.scatter(-1, j, -INF)
        picked = picked.scatter(-1, j, torch.gather(picked, -1, j)
                                | ok[..., None])
        n_picked = n_picked + ok
        if eta < 1.0 and thr > 0.5:
            thr = np.float32(thr * np.float32(eta))
    if stats is not None:
        stats["nms_iterations"] = stats.get("nms_iterations", 0) + done
    return picked


def _nms_rows(scores, boxes, picked, K, M):
    """The best ``K`` picks of each image over all its classes, JAX's
    ``order = argsort(-flat_scores)[:K]``: (rows [B, K, 6], box index
    [B, K] (-1 padding), counts [B])."""
    B = scores.shape[0]
    flat_valid = picked.reshape(B, -1)
    flat = scores.reshape(B, -1)
    flat_scores = torch.where(flat_valid, flat, torch.full_like(flat, -INF))
    order = _stable_argsort(-flat_scores, dim=1)[:, :K]
    lbl = torch.div(order, M, rounding_mode="floor").to(scores.dtype)
    s = torch.gather(flat, 1, order)
    box_idx = (order % M).to(torch.int32)
    bsel = torch.gather(boxes, 1, box_idx.long()[..., None].expand(B, K, 4))
    valid = torch.gather(flat_valid, 1, order)
    row = torch.cat([torch.where(valid, lbl, torch.full_like(lbl, -1.0))[
        ..., None], (s * valid)[..., None], bsel * valid[..., None]], dim=-1)
    return (row, torch.where(valid, box_idx, torch.full_like(box_idx, -1)),
            valid.sum(1).to(torch.int32))


def multiclass_nms_rows(op, boxes, scores, stats=None):
    """``multiclass_nms`` with the picked boxes' indices: (Out,
    box index, NmsRoisNum). ``multiclass_nms2`` reads the index, which
    JAX passes as an undeclared ``_BoxIndex`` output."""
    if boxes.dim() == 2:
        boxes, scores = boxes[None], scores[None]
    M = boxes.shape[1]
    C = scores.shape[1]
    bg = int(op.attrs.get("background_label", 0))
    s_thresh = float(op.attrs.get("score_threshold", 0.0))
    n_thresh = float(op.attrs.get("nms_threshold", 0.3))
    eta = float(op.attrs.get("nms_eta", 1.0))
    nms_top_k = int(op.attrs.get("nms_top_k", -1))
    keep_top_k = int(op.attrs.get("keep_top_k", -1))
    normalized = bool(op.attrs.get("normalized", True))
    max_picks = M if nms_top_k <= 0 else min(nms_top_k, M)
    K = M * C if keep_top_k <= 0 else min(keep_top_k, M * C)
    live = scores
    if 0 <= bg < C:
        # JAX drops the background class's picks after its NMS
        is_bg = torch.arange(C, device=scores.device)[None, :, None] == bg
        live = torch.where(is_bg, torch.full_like(scores, -INF), scores)
    picked = _greedy_nms(boxes[:, None], live, n_thresh, s_thresh, max_picks,
                         eta, normalized, cap=K, stats=stats)
    return _nms_rows(scores, boxes, picked, K, M)


@register_op("multiclass_nms", inputs=("BBoxes", "Scores"),
             outputs=("Out", "NmsRoisNum"), stop_gradient=True)
def _multiclass_nms(ctx, op, ins):
    """Reference multiclass_nms_op.cc: per-class score filter + NMS,
    then cross-class keep_top_k. BBoxes [B, M, 4], Scores [B, C, M];
    Out [B, keep_top_k, 6] rows (label, score, x1, y1, x2, y2), invalid
    rows labeled -1; NmsRoisNum [B] valid detections an image."""
    out, _, num = multiclass_nms_rows(op, ins["BBoxes"][0], ins["Scores"][0])
    return {"Out": [out], "NmsRoisNum": [num]}


@register_op("multiclass_nms2", inputs=("BBoxes", "Scores"),
             outputs=("Out", "Index", "NmsRoisNum"), stop_gradient=True)
def _multiclass_nms2(ctx, op, ins):
    """``multiclass_nms`` and each row's box in the input BBoxes (-1 for
    padding)."""
    out, idx, num = multiclass_nms_rows(op, ins["BBoxes"][0],
                                        ins["Scores"][0])
    return {"Out": [out], "Index": [idx], "NmsRoisNum": [num]}


@register_op("yolo_box", inputs=("X", "ImgSize"), outputs=("Boxes", "Scores"),
             stop_gradient=True)
def _yolo_box(ctx, op, ins):
    """Reference yolo_box_op.cc: decode a YOLOv3 head.
    X [N, an*(5+cls), H, W] -> Boxes [N, H*W*an, 4], Scores
    [N, H*W*an, cls]; boxes scaled to ImgSize, conf_thresh zeroing."""
    x, img_size = ins["X"][0], ins["ImgSize"][0]
    anchors = [int(a) for a in op.attrs["anchors"]]
    class_num = int(op.attrs["class_num"])
    conf_thresh = float(op.attrs.get("conf_thresh", 0.005))
    downsample = int(op.attrs.get("downsample_ratio", 32))
    clip_bbox = bool(op.attrs.get("clip_bbox", True))
    scale_x_y = float(op.attrs.get("scale_x_y", 1.0))
    an = len(anchors) // 2
    N, _, H, W = x.shape
    dev = x.device
    x = x.reshape(N, an, 5 + class_num, H, W)
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]
    gy = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    aw = torch.tensor(anchors[0::2], dtype=torch.float32,
                      device=dev)[None, :, None, None]
    ah = torch.tensor(anchors[1::2], dtype=torch.float32,
                      device=dev)[None, :, None, None]
    sig = torch.sigmoid
    bias = (scale_x_y - 1.0) * 0.5
    cx = (sig(x[:, :, 0]) * scale_x_y - bias + gx) / W
    cy = (sig(x[:, :, 1]) * scale_x_y - bias + gy) / H
    bw = torch.exp(x[:, :, 2]) * aw / (downsample * W)
    bh = torch.exp(x[:, :, 3]) * ah / (downsample * H)
    conf = sig(x[:, :, 4])
    probs = sig(x[:, :, 5:]) * conf[:, :, None]
    probs = torch.where(conf[:, :, None] < conf_thresh,
                        torch.zeros_like(probs), probs)
    imh = img_size[:, 0].to(torch.float32)[:, None, None, None]
    imw = img_size[:, 1].to(torch.float32)[:, None, None, None]
    x1 = (cx - bw / 2) * imw
    y1 = (cy - bh / 2) * imh
    x2 = (cx + bw / 2) * imw
    y2 = (cy + bh / 2) * imh
    if clip_bbox:
        zero = torch.zeros((), dtype=x1.dtype, device=dev)
        x1 = _clip(x1, zero, imw - 1)
        y1 = _clip(y1, zero, imh - 1)
        x2 = _clip(x2, zero, imw - 1)
        y2 = _clip(y2, zero, imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)  # [N, an, H, W, 4]
    boxes = boxes.permute(0, 2, 3, 1, 4).reshape(N, H * W * an, 4)
    scores = probs.permute(0, 3, 4, 1, 2).reshape(N, H * W * an, class_num)
    return {"Boxes": [boxes], "Scores": [scores]}


def _anchor_arrays(attrs, H, W):
    """JAX's numpy construction (``paddle_tpu/ops/detection.py:285-317``)."""
    sizes = [float(s) for s in attrs.get("anchor_sizes", [64.0])]
    ratios = [float(r) for r in attrs.get("aspect_ratios", [1.0])]
    stride = [float(s) for s in attrs.get("stride", [16.0, 16.0])]
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    offset = float(attrs.get("offset", 0.5))
    base = []
    for r in ratios:
        for s in sizes:
            area = stride[0] * stride[1]
            area_ratios = area / r
            bw = np.round(np.sqrt(area_ratios))
            bh = np.round(bw * r)
            scale_w = s / stride[0]
            scale_h = s / stride[1]
            w_half = 0.5 * (scale_w * bw - 1)
            h_half = 0.5 * (scale_h * bh - 1)
            base.append((-w_half, -h_half, w_half, h_half))
    base = np.asarray(base, np.float32)  # [A, 4]
    cx = (np.arange(W, dtype=np.float32) + offset) * stride[0]
    cy = (np.arange(H, dtype=np.float32) + offset) * stride[1]
    cxg, cyg = np.meshgrid(cx, cy)  # [H, W]
    shift = np.stack([cxg, cyg, cxg, cyg], -1)[:, :, None, :]
    anchors = shift + base[None, None]
    var = np.tile(np.asarray(variances, np.float32), (H, W, base.shape[0], 1))
    return anchors, var


@register_op("anchor_generator", inputs=("Input",),
             outputs=("Anchors", "Variances"), stop_gradient=True)
def _anchor_generator(ctx, op, ins):
    """Reference detection/anchor_generator_op.cc: dense anchors from
    anchor_sizes x aspect_ratios at every feature-map cell."""
    H, W = ins["Input"][0].shape[2], ins["Input"][0].shape[3]
    anchors, var = _from_numpy(ctx, op, (H, W),
                               lambda: _anchor_arrays(op.attrs, H, W))
    return {"Anchors": [anchors], "Variances": [var]}


def _density_arrays(attrs, H, W, ih, iw):
    """JAX's numpy construction (``paddle_tpu/ops/detection.py:320-365``)."""
    fixed_sizes = [float(s) for s in attrs.get("fixed_sizes", [])]
    fixed_ratios = [float(r) for r in attrs.get("fixed_ratios", [1.0])]
    densities = [int(d) for d in attrs.get("densities", [])]
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    clip = bool(attrs.get("clip", False))
    offset = float(attrs.get("offset", 0.5))
    sh = float(attrs.get("step_h", 0.0)) or ih / H
    sw = float(attrs.get("step_w", 0.0)) or iw / W
    boxes = []
    for fs, dens in zip(fixed_sizes, densities):
        for ar in fixed_ratios:
            bw = fs * np.sqrt(ar)
            bh = fs / np.sqrt(ar)
            step = fs / dens
            for di in range(dens):
                for dj in range(dens):
                    sx = -fs / 2.0 + step / 2.0 + dj * step
                    sy = -fs / 2.0 + step / 2.0 + di * step
                    boxes.append((sx, sy, bw, bh))
    cy, cx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    ccx = (cx + offset) * sw
    ccy = (cy + offset) * sh
    out = []
    for sx, sy, bw, bh in boxes:
        bx = ccx + sx
        by = ccy + sy
        out.append(np.stack([(bx - bw / 2) / iw, (by - bh / 2) / ih,
                             (bx + bw / 2) / iw, (by + bh / 2) / ih], -1))
    arr = np.stack(out, 2).astype(np.float32)  # [H, W, A, 4]
    if clip:
        arr = np.clip(arr, 0.0, 1.0)
    var = np.tile(np.asarray(variances, np.float32), arr.shape[:3] + (1,))
    return arr, var


@register_op("density_prior_box", inputs=("Input", "Image"),
             outputs=("Boxes", "Variances"), stop_gradient=True)
def _density_prior_box(ctx, op, ins):
    """Reference detection/density_prior_box_op.cc: dense grid of
    fixed-size priors with per-size densities."""
    feat, img = ins["Input"][0], ins["Image"][0]
    H, W = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    boxes, var = _from_numpy(ctx, op, (H, W, ih, iw),
                             lambda: _density_arrays(op.attrs, H, W, ih, iw))
    return {"Boxes": [boxes], "Variances": [var]}


def _roi_batch_idx(ins, R, n_images):
    """Each roi's image from ``RoisNum``'s counts (JAX's ``searchsorted``
    over their running sum); a roi past the counts takes the last
    image, as JAX's clamped gather does."""
    dev = ins["ROIs"][0].device
    if ins.get("RoisNum"):
        rn = ins["RoisNum"][0]
        idx = torch.searchsorted(torch.cumsum(rn, 0),
                                 torch.arange(R, device=dev).to(rn.dtype),
                                 right=True)
        return torch.clamp(idx, max=n_images - 1)
    return torch.zeros((R,), dtype=torch.int64, device=dev)


def _bilinear_grid(img, b, ys, xs):
    """JAX's clamped bilinear sample of image ``b[r]`` of ``img``
    [N, C, H, W] at every (ys[r, i], xs[r, j]) pair -> [R, Y, X, C]."""
    H, W = img.shape[2], img.shape[3]
    y = torch.clamp(ys, 0.0, H - 1.0)[:, :, None]
    x = torch.clamp(xs, 0.0, W - 1.0)[:, None, :]
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    ly, lx = (y - y0)[..., None], (x - x0)[..., None]
    r = b[:, None, None]

    def at(yi, xi):
        return img[r, :, yi, xi]

    return (at(y0, x0) * (1 - ly) * (1 - lx) + at(y0, x1) * (1 - ly) * lx
            + at(y1, x0) * ly * (1 - lx) + at(y1, x1) * ly * lx)


def _sample_offsets(p, n, like):
    """[p, n]: bin i's sample k at ``i + (k + 0.5) / n``."""
    dev = like.device
    return (torch.arange(p, device=dev)[:, None]
            + (torch.arange(n, device=dev)[None, :] + 0.5) / n).to(like.dtype)


def _roi_chunks(R, per_roi, budget=1 << 25):
    """Slices of at most ``budget`` sampled values, for rois whose
    samples take ``per_roi`` values each."""
    step = max(1, budget // max(per_roi, 1))
    return [slice(i, min(i + step, R)) for i in range(0, R, step)] or \
        [slice(0, 0)]


@register_op("roi_align", inputs=("X", "ROIs", "RoisNum"), outputs=("Out",),
             no_grad=("ROIs", "RoisNum"))
def _roi_align(ctx, op, ins):
    """Reference operators/roi_align_op.cc: average of bilinear samples
    per output bin. sampling_ratio <= 0 (adaptive in the reference)
    takes JAX's static 2x2 grid."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    scale = float(op.attrs.get("spatial_scale", 1.0))
    ph = int(op.attrs.get("pooled_height", 1))
    pw = int(op.attrs.get("pooled_width", 1))
    sr = int(op.attrs.get("sampling_ratio", -1))
    n = sr if sr > 0 else 2
    N, C, H, W = x.shape
    R = rois.shape[0]
    bidx = _roi_batch_idx(ins, R, N)
    iy = _sample_offsets(ph, n, x).reshape(-1)
    ix = _sample_offsets(pw, n, x).reshape(-1)
    outs = []
    for sl in _roi_chunks(R, ph * n * pw * n * C):
        roi = rois[sl]
        x1, y1 = roi[:, 0] * scale, roi[:, 1] * scale
        x2, y2 = roi[:, 2] * scale, roi[:, 3] * scale
        rh = torch.clamp(y2 - y1, min=1.0)
        rw = torch.clamp(x2 - x1, min=1.0)
        ys = y1[:, None] + iy[None, :] * (rh / ph)[:, None]
        xs = x1[:, None] + ix[None, :] * (rw / pw)[:, None]
        vals = _bilinear_grid(x, bidx[sl], ys, xs)
        r = vals.shape[0]
        vals = vals.reshape(r, ph, n, pw, n, C).mean(dim=(2, 4))
        outs.append(vals.permute(0, 3, 1, 2))
    return {"Out": [torch.cat(outs, 0)]}


@register_op("roi_pool", inputs=("X", "ROIs", "RoisNum"),
             outputs=("Out", "Argmax"), no_grad=("ROIs", "RoisNum"))
def _roi_pool(ctx, op, ins):
    """Reference operators/roi_pool_op.cc: max over each quantized bin,
    as JAX's: over a static 4x4 nearest-neighbour sample grid a bin.
    ``amax`` shares the gradient of a tie evenly, as JAX's reduce-max."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    scale = float(op.attrs.get("spatial_scale", 1.0))
    ph = int(op.attrs.get("pooled_height", 1))
    pw = int(op.attrs.get("pooled_width", 1))
    n = 4
    N, C, H, W = x.shape
    R = rois.shape[0]
    bidx = _roi_batch_idx(ins, R, N)
    iy = _sample_offsets(ph, n, x).reshape(-1)
    ix = _sample_offsets(pw, n, x).reshape(-1)
    x1 = torch.round(rois[:, 0] * scale)
    y1 = torch.round(rois[:, 1] * scale)
    x2 = torch.round(rois[:, 2] * scale)
    y2 = torch.round(rois[:, 3] * scale)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    ys = torch.clamp(y1[:, None] + iy[None, :] * (rh / ph)[:, None], 0,
                     H - 1).to(torch.int32).long()
    xs = torch.clamp(x1[:, None] + ix[None, :] * (rw / pw)[:, None], 0,
                     W - 1).to(torch.int32).long()
    vals = x[bidx[:, None, None], :, ys[:, :, None], xs[:, None, :]]
    vals = torch.amax(vals.reshape(R, ph, n, pw, n, C), dim=(2, 4))
    out = vals.permute(0, 3, 1, 2)
    return {"Out": [out], "Argmax": [torch.zeros(out.shape, dtype=torch.int32,
                                                 device=out.device)]}


@register_op("sigmoid_focal_loss", inputs=("X", "Label", "FgNum"),
             outputs=("Out",), no_grad=("Label", "FgNum"))
def _sigmoid_focal_loss(ctx, op, ins):
    """Reference detection/sigmoid_focal_loss_op.cc: per-class sigmoid
    focal loss; Label in [0, C] where 0 = background, normalized by
    fg_num."""
    x = ins["X"][0]  # [N, C] logits
    label = ins["Label"][0].reshape(-1)
    fg = torch.clamp(ins["FgNum"][0].reshape(()).to(x.dtype), min=1.0)
    gamma = float(op.attrs.get("gamma", 2.0))
    alpha = float(op.attrs.get("alpha", 0.25))
    C = x.shape[1]
    t = (label[:, None] == torch.arange(1, C + 1, device=x.device)[
        None, :]).to(x.dtype)
    p = torch.sigmoid(x)
    # -log_sigmoid(x) = softplus(-x), JAX's form
    ce = t * _softplus(-x) + (1 - t) * _softplus(x)
    w = t * alpha * (1 - p) ** gamma + (1 - t) * (1 - alpha) * p ** gamma
    return {"Out": [w * ce / fg]}


@register_op("bipartite_match", inputs=("DistMat",),
             outputs=("ColToRowMatchIndices", "ColToRowMatchDist"),
             stop_gradient=True)
def _bipartite_match(ctx, op, ins):
    """Reference detection/bipartite_match_op.cc: greedy global
    bipartite matching of a [N, M] distance matrix, JAX's loop of
    min(N, M) picks of the global maximum (the first of equal ones);
    'per_prediction' also matches each leftover column's best row at
    or above dist_threshold. Dense batch form: [B, N, M]."""
    dist = ins["DistMat"][0]
    batched = dist.dim() == 3
    if not batched:
        dist = dist[None]
    match_type = op.attrs.get("match_type", "bipartite")
    thresh = float(op.attrs.get("dist_threshold", 0.5))
    B, N, M = dist.shape
    dev = dist.device
    used_r = torch.zeros((B, N), dtype=torch.bool, device=dev)
    used_c = torch.zeros((B, M), dtype=torch.bool, device=dev)
    idx = torch.full((B, M), -1, dtype=torch.int32, device=dev)
    dd = torch.zeros((B, M), dtype=dist.dtype, device=dev)
    for _ in range(min(N, M)):
        masked = torch.where(used_r[:, :, None] | used_c[:, None, :],
                             torch.full_like(dist, -INF), dist)
        flat = torch.argmax(masked.reshape(B, -1), dim=1)
        r = torch.div(flat, M, rounding_mode="floor")
        c = flat % M
        best = masked.reshape(B, -1).gather(1, flat[:, None])[:, 0]
        ok = best > 0
        used_r = used_r.scatter(1, r[:, None], ok[:, None]
                                | used_r.gather(1, r[:, None]))
        used_c = used_c.scatter(1, c[:, None], ok[:, None]
                                | used_c.gather(1, c[:, None]))
        idx = idx.scatter(1, c[:, None], torch.where(
            ok, r.to(torch.int32), idx.gather(1, c[:, None])[:, 0])[:, None])
        dval = dist.reshape(B, -1).gather(1, flat[:, None])[:, 0]
        dd = dd.scatter(1, c[:, None], torch.where(
            ok, dval, dd.gather(1, c[:, None])[:, 0])[:, None])
    if match_type == "per_prediction":
        best_r = torch.argmax(dist, dim=1)
        best_v = dist.amax(1)
        extra = (idx < 0) & (best_v >= thresh)
        idx = torch.where(extra, best_r.to(torch.int32), idx)
        dd = torch.where(extra, best_v, dd)
    if not batched:
        idx, dd = idx[0], dd[0]
    return {"ColToRowMatchIndices": [idx], "ColToRowMatchDist": [dd]}


@register_op("target_assign", inputs=("X", "MatchIndices", "NegIndices"),
             outputs=("Out", "OutWeight"), stop_gradient=True)
def _target_assign(ctx, op, ins):
    """Reference detection/target_assign_op.cc: out[i, j] =
    X[i, match_indices[i, j]] (mismatch_value where unmatched);
    NegIndices rows get mismatch_value with weight 1."""
    x = ins["X"][0]  # [B, M, K] targets
    mi = ins["MatchIndices"][0]  # [B, P] row indices into M or -1
    mismatch = op.attrs.get("mismatch_value", 0)
    K = x.shape[-1]
    safe = torch.clamp(mi, 0, x.shape[1] - 1).long()
    gathered = torch.gather(x, 1, safe[..., None].expand(*safe.shape, K))
    matched = (mi >= 0)[..., None]
    miss = torch.full_like(gathered, mismatch)
    out = torch.where(matched, gathered, miss)
    w = matched.to(torch.float32)
    if ins.get("NegIndices"):
        neg = ins["NegIndices"][0]  # [B, P] 0/1 mask (dense form)
        out = torch.where(neg[..., None] > 0, miss, out)
        w = torch.maximum(w, (neg > 0)[..., None].to(torch.float32))
    return {"Out": [out], "OutWeight": [w]}


@register_op("mine_hard_examples", inputs=("ClsLoss", "MatchIndices",
                                           "MatchDist"),
             outputs=("NegIndices", "UpdatedMatchIndices"), stop_gradient=True)
def _mine_hard_examples(ctx, op, ins):
    """Reference detection/mine_hard_examples_op.cc (max_negative
    mining): per image, negatives = unmatched priors by loss, highest
    first (a stable sort: equal losses in prior order), keeping
    neg_pos_ratio * num_pos of them. NegIndices is a 0/1 mask [B, P]."""
    loss = ins["ClsLoss"][0]  # [B, P]
    mi = ins["MatchIndices"][0]  # [B, P]
    ratio = float(op.attrs.get("neg_pos_ratio", 3.0))
    P = loss.shape[1]
    pos = mi >= 0
    n_pos = pos.sum(1).to(torch.int32)
    n_neg = torch.minimum((n_pos * ratio).to(torch.int32), P - n_pos)
    neg_loss = torch.where(pos, torch.full_like(loss, -INF), loss)
    rank = _rank(_stable_argsort(-neg_loss, dim=1))
    neg = (rank < n_neg[:, None]) & ~pos & torch.isfinite(loss)
    return {"NegIndices": [neg.to(torch.int32)], "UpdatedMatchIndices": [mi]}


@register_op("box_decoder_and_assign", inputs=("PriorBox", "PriorBoxVar",
                                               "TargetBox", "BoxScore"),
             outputs=("DecodeBox", "OutputAssignBox"), stop_gradient=True)
def _box_decoder_and_assign(ctx, op, ins):
    """Reference detection/box_decoder_and_assign_op.cc: decode
    per-class deltas against priors, then assign each roi its
    best-scoring class's box."""
    prior = ins["PriorBox"][0]  # [R, 4]
    pv = ins["PriorBoxVar"][0] if ins.get("PriorBoxVar") else \
        torch.ones((4,), dtype=prior.dtype, device=prior.device)
    deltas = ins["TargetBox"][0]  # [R, C*4]
    scores = ins["BoxScore"][0]  # [R, C]
    R, C = scores.shape
    d = deltas.reshape(R, C, 4)
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    ocx = pv[..., 0] * d[..., 0] * pw[:, None] + pcx[:, None]
    ocy = pv[..., 1] * d[..., 1] * ph[:, None] + pcy[:, None]
    ow = torch.exp(pv[..., 2] * d[..., 2]) * pw[:, None]
    oh = torch.exp(pv[..., 3] * d[..., 3]) * ph[:, None]
    dec = torch.stack([ocx - ow / 2, ocy - oh / 2, ocx + ow / 2 - 1,
                       ocy + oh / 2 - 1], -1)  # [R, C, 4]
    best = torch.argmax(scores, dim=1)
    assign = torch.gather(dec, 1, best[:, None, None].expand(R, 1, 4))[:, 0]
    return {"DecodeBox": [dec.reshape(R, C * 4)], "OutputAssignBox": [assign]}


@register_op("polygon_box_transform", inputs=("Input",), outputs=("Output",),
             stop_gradient=True)
def _polygon_box_transform(ctx, op, ins):
    """Reference detection/polygon_box_transform_op.cc (EAST text):
    even channels: out = 4*x_grid - in; odd channels: 4*y_grid - in."""
    x = ins["Input"][0]  # [N, 2k, H, W]
    N, C, H, W = x.shape
    gx = torch.arange(W, dtype=x.dtype, device=x.device)[None, None, None, :]
    gy = torch.arange(H, dtype=x.dtype, device=x.device)[None, None, :, None]
    is_x = (torch.arange(C, device=x.device) % 2 == 0)[None, :, None, None]
    return {"Output": [torch.where(is_x, 4 * gx - x, 4 * gy - x)]}


# -- the proposal pipeline and YOLO training --------------------------------


@register_op("generate_proposals", inputs=("Scores", "BboxDeltas", "ImInfo",
                                           "Anchors", "Variances"),
             outputs=("RpnRois", "RpnRoiProbs", "RpnRoisNum"),
             stop_gradient=True)
def _generate_proposals(ctx, op, ins):
    """Reference detection/generate_proposals_op.cc: decode anchor
    deltas, clip, drop tiny boxes, pre-NMS top-k, NMS, post-NMS top-k.
    Dense outputs [N, post_nms_topN, 4] + per-image counts."""
    return generate_proposals(op, ins)


def generate_proposals(op, ins, stats=None):
    scores = ins["Scores"][0]        # [N, A, H, W]
    deltas = ins["BboxDeltas"][0]    # [N, 4A, H, W]
    im_info = ins["ImInfo"][0]       # [N, 3]
    anchors = ins["Anchors"][0].reshape(-1, 4)    # [H*W*A, 4]
    var = ins["Variances"][0].reshape(-1, 4) if ins.get("Variances") else \
        torch.ones_like(anchors)
    pre_n = int(op.attrs.get("pre_nms_topN", 6000))
    post_n = int(op.attrs.get("post_nms_topN", 1000))
    thresh = float(op.attrs.get("nms_thresh", 0.7))
    min_size = float(op.attrs.get("min_size", 0.1))
    N, A, H, W = scores.shape
    M = A * H * W
    pre_n = min(pre_n, M)
    post_n = min(post_n, pre_n)
    sc = scores.permute(0, 2, 3, 1).reshape(N, M)
    d = deltas.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2).reshape(N, M, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + aw * 0.5
    acy = anchors[:, 1] + ah * 0.5
    info = im_info[:, None, :]
    cx = var[:, 0] * d[..., 0] * aw + acx
    cy = var[:, 1] * d[..., 1] * ah + acy
    w = torch.exp(torch.clamp(var[:, 2] * d[..., 2], max=10.0)) * aw
    h = torch.exp(torch.clamp(var[:, 3] * d[..., 3], max=10.0)) * ah
    zero = torch.zeros((), dtype=sc.dtype, device=sc.device)
    x1 = _clip(cx - w * 0.5, zero, info[..., 1] - 1)
    y1 = _clip(cy - h * 0.5, zero, info[..., 0] - 1)
    x2 = _clip(cx + w * 0.5, zero, info[..., 1] - 1)
    y2 = _clip(cy + h * 0.5, zero, info[..., 0] - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=2)      # [N, M, 4]
    keep = ((x2 - x1 + 1) >= min_size * info[..., 2]) & \
        ((y2 - y1 + 1) >= min_size * info[..., 2])
    s = torch.where(keep, sc, torch.full_like(sc, -INF))
    top_s, top_i = top_k_lower_index_first(s, pre_n)
    top_b = torch.gather(boxes, 1, top_i[..., None].expand(N, pre_n, 4))
    picked = _greedy_nms(top_b, top_s, thresh, -INF, post_n,
                         normalized=False, stats=stats)
    ps = torch.where(picked & torch.isfinite(top_s), top_s,
                     torch.full_like(top_s, -INF))
    fs, fi = top_k_lower_index_first(ps, post_n)
    valid = torch.isfinite(fs)
    rois = torch.gather(top_b, 1, fi[..., None].expand(N, post_n, 4)) * \
        valid[..., None]
    return {"RpnRois": [rois],
            "RpnRoiProbs": [torch.where(valid, fs, torch.zeros_like(fs))[
                ..., None]],
            "RpnRoisNum": [valid.sum(1).to(torch.int32)]}


@register_op("distribute_fpn_proposals", inputs=("FpnRois", "RoisNum"),
             outputs=("MultiFpnRois", "RestoreIndex", "MultiLevelRoIsNum"),
             stop_gradient=True)
def _distribute_fpn_proposals(ctx, op, ins):
    """Reference detection/distribute_fpn_proposals_op.cc: route each
    roi to its FPN level by scale. Each level's output keeps the full
    [R, 4] buffer with that level's rois compacted to the front."""
    rois = ins["FpnRois"][0]  # [R, 4]
    min_lv = int(op.attrs["min_level"])
    max_lv = int(op.attrs["max_level"])
    refer_lv = int(op.attrs["refer_level"])
    refer_sc = float(op.attrs["refer_scale"])
    R = rois.shape[0]
    dev = rois.device
    ar = torch.arange(R, device=dev)
    # dense padding rows (beyond the images' RoisNum counts, packed in
    # order) are routed nowhere; JAX reads the first image's count alone
    # (ROADMAP §C)
    if ins.get("RoisNum"):
        valid = ar < ins["RoisNum"][0].sum()
    else:
        valid = torch.ones((R,), dtype=torch.bool, device=dev)
    w = torch.clamp(rois[:, 2] - rois[:, 0] + 1.0, min=1.0)
    h = torch.clamp(rois[:, 3] - rois[:, 1] + 1.0, min=1.0)
    scale = torch.sqrt(w * h)
    lv = torch.floor(refer_lv + torch.log2(scale / refer_sc + 1e-8))
    lv = torch.clamp(lv, min_lv, max_lv).to(torch.int32)
    lv = torch.where(valid, lv, torch.full_like(lv, -1))
    outs, nums = [], []
    for L in range(min_lv, max_lv + 1):
        mask = lv == L
        order = _stable_argsort(torch.where(mask, 0, 1) * (R + 1) + ar)
        outs.append(rois[order] * mask[order][:, None])
        nums.append(mask.sum().to(torch.int32))
    # RestoreIndex: roi i's row in concat(MultiFpnRois) of this padded
    # layout, level slot * R + rank within its level
    same = (lv[:, None] == lv[None, :]) & (ar[None, :] < ar[:, None])
    rank = same.sum(1)
    restore = torch.where(valid, (lv - min_lv) * R + rank,
                          torch.zeros_like(rank)).to(torch.int32)
    return {"MultiFpnRois": outs, "RestoreIndex": [restore[:, None]],
            "MultiLevelRoIsNum": [torch.stack(nums)]}


@register_op("collect_fpn_proposals", inputs=("MultiLevelRois",
                                              "MultiLevelScores",
                                              "MultiLevelRoIsNum"),
             outputs=("FpnRois", "RoisNum"), stop_gradient=True)
def _collect_fpn_proposals(ctx, op, ins):
    """Reference detection/collect_fpn_proposals_op.cc: merge all
    levels, keep the post_nms_topN highest-scoring. MultiLevelRoIsNum
    masks the dense per-level padding so fake rois never win top-k."""
    rois = torch.cat(ins["MultiLevelRois"], dim=0)
    scores = torch.cat([s.reshape(-1) for s in ins["MultiLevelScores"]], 0)
    if ins.get("MultiLevelRoIsNum"):
        nums = ins["MultiLevelRoIsNum"][0].reshape(-1)
        valid = torch.cat([
            torch.arange(lvl.shape[0], device=rois.device) < nums[i]
            for i, lvl in enumerate(ins["MultiLevelRois"])])
        scores = torch.where(valid, scores, torch.full_like(scores, -INF))
    post = min(int(op.attrs.get("post_nms_topN", rois.shape[0])),
               rois.shape[0])
    top_s, top_i = top_k_lower_index_first(scores, post)
    keep = torch.isfinite(top_s)
    return {"FpnRois": [rois[top_i] * keep[:, None]],
            "RoisNum": [keep.sum().to(torch.int32).reshape(1)]}


@register_op("rpn_target_assign", inputs=("Anchor", "GtBoxes", "IsCrowd",
                                          "ImInfo"),
             outputs=("LocationIndex", "ScoreIndex", "TargetBBox",
                      "TargetLabel", "BBoxInsideWeight"), stop_gradient=True)
def _rpn_target_assign(ctx, op, ins):
    """Reference detection/rpn_target_assign_op.cc, JAX's deterministic
    dense form: fg = anchors with IoU >= pos_thresh (plus each gt's
    best anchor), bg = IoU < neg_thresh; the reference's random
    subsampling becomes top-by-IoU subsampling (fixed sizes)."""
    anchors = ins["Anchor"][0].reshape(-1, 4)
    gt = ins["GtBoxes"][0].reshape(-1, 4)
    batch = int(op.attrs.get("rpn_batch_size_per_im", 256))
    fg_frac = float(op.attrs.get("rpn_fg_fraction", 0.5))
    pos_t = float(op.attrs.get("rpn_positive_overlap", 0.7))
    neg_t = float(op.attrs.get("rpn_negative_overlap", 0.3))
    A = anchors.shape[0]
    n_fg = max(int(batch * fg_frac), 1)
    n_bg = batch - n_fg
    # zero-padded gt rows and crowd boxes take no part
    gt_area = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    valid_gt = gt_area > 0
    if ins.get("IsCrowd"):
        valid_gt = valid_gt & (ins["IsCrowd"][0].reshape(-1) == 0)
    iou = _pairwise_iou(anchors, gt, normalized=False)  # [A, G]
    iou = torch.where(valid_gt[None, :], iou, torch.zeros_like(iou))
    best_iou = iou.amax(1)
    best_gt = torch.argmax(iou, dim=1)
    # each valid gt's best anchor is always fg (reference rule)
    gt_best_anchor = torch.argmax(iou, dim=0)  # [G]
    forced = ((torch.arange(A, device=anchors.device)[:, None]
               == gt_best_anchor[None, :]) & valid_gt[None, :]).any(1)
    is_fg = (best_iou >= pos_t) | forced
    is_bg = (best_iou < neg_t) & ~is_fg
    ninf = torch.full_like(best_iou, -INF)
    fg_score, fg_idx = top_k_lower_index_first(
        torch.where(is_fg, best_iou, ninf), min(n_fg, A))
    fg_valid = torch.isfinite(fg_score)
    bg_score, bg_idx = top_k_lower_index_first(
        torch.where(is_bg, -best_iou, ninf), min(n_bg, A))  # easiest first
    bg_valid = torch.isfinite(bg_score)
    loc_idx = torch.where(fg_valid, fg_idx, torch.zeros_like(fg_idx)).to(
        torch.int32)
    score_idx = torch.cat([loc_idx, torch.where(
        bg_valid, bg_idx, torch.zeros_like(bg_idx)).to(torch.int32)])
    # unfilled slots get label -1 (ignore, the reference convention)
    labels = torch.cat([
        torch.where(fg_valid, 1, -1).to(torch.int32),
        torch.where(bg_valid, 0, -1).to(torch.int32)])
    a = anchors[loc_idx.long()]
    g = gt[best_gt[loc_idx.long()]]
    aw = a[:, 2] - a[:, 0] + 1.0
    ah = a[:, 3] - a[:, 1] + 1.0
    gw = g[:, 2] - g[:, 0] + 1.0
    gh = g[:, 3] - g[:, 1] + 1.0
    tx = ((g[:, 0] + gw / 2) - (a[:, 0] + aw / 2)) / aw
    ty = ((g[:, 1] + gh / 2) - (a[:, 1] + ah / 2)) / ah
    tw = torch.log(gw / aw)
    th = torch.log(gh / ah)
    tgt = torch.stack([tx, ty, tw, th], dim=1) * fg_valid[:, None]
    return {
        "LocationIndex": [loc_idx],
        "ScoreIndex": [score_idx],
        "TargetBBox": [tgt],
        "TargetLabel": [labels[:, None]],
        "BBoxInsideWeight": [fg_valid[:, None].to(torch.float32)
                             * torch.ones((1, 4), device=anchors.device)],
    }


@register_op("retinanet_detection_output", inputs=("BBoxes", "Scores",
                                                   "Anchors", "ImInfo"),
             outputs=("Out", "NmsRoisNum"), stop_gradient=True)
def _retinanet_detection_output(ctx, op, ins):
    """Reference detection/retinanet_detection_output_op.cc: decode
    per-level predictions against anchors, then class-wise NMS over all
    levels at once."""
    deltas = torch.cat([b.reshape(b.shape[0], -1, 4) for b in ins["BBoxes"]],
                       dim=1)
    scores = torch.cat([s.reshape(s.shape[0], -1, s.shape[-1])
                        for s in ins["Scores"]], dim=1)
    anchors = torch.cat([a.reshape(-1, 4) for a in ins["Anchors"]], dim=0)
    im_info = ins["ImInfo"][0]
    s_thresh = float(op.attrs.get("score_threshold", 0.05))
    n_thresh = float(op.attrs.get("nms_threshold", 0.3))
    keep_k = int(op.attrs.get("keep_top_k", 100))
    nms_k = int(op.attrs.get("nms_top_k", 1000))
    N, M, C = scores.shape
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    info = im_info[:, None, :]
    cx = deltas[..., 0] * aw + anchors[:, 0] + aw * 0.5
    cy = deltas[..., 1] * ah + anchors[:, 1] + ah * 0.5
    w = torch.exp(torch.clamp(deltas[..., 2], max=10.0)) * aw
    h = torch.exp(torch.clamp(deltas[..., 3], max=10.0)) * ah
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    boxes = torch.stack([_clip(cx - w / 2, zero, info[..., 1] - 1),
                         _clip(cy - h / 2, zero, info[..., 0] - 1),
                         _clip(cx + w / 2, zero, info[..., 1] - 1),
                         _clip(cy + h / 2, zero, info[..., 0] - 1)], 2)
    st = scores.transpose(1, 2)  # [N, C, M]
    K = min(keep_k, M * C)
    picked = _greedy_nms(boxes[:, None], st, n_thresh, s_thresh,
                         min(nms_k, M), normalized=False, cap=K)
    out, _, num = _nms_rows(st, boxes, picked, K, M)
    return {"Out": [out], "NmsRoisNum": [num]}


@register_op("locality_aware_nms", inputs=("BBoxes", "Scores"),
             outputs=("Out",), stop_gradient=True)
def _locality_aware_nms(ctx, op, ins):
    """Reference detection/locality_aware_nms_op.cc (EAST text): merge
    overlapping boxes by score-weighted averaging, then standard NMS."""
    boxes = ins["BBoxes"][0]
    scores = ins["Scores"][0]
    if boxes.dim() == 3:
        boxes, scores = boxes[0], scores[0]
    if scores.dim() == 2:
        scores = scores[0] if scores.shape[0] == 1 else scores.amax(0)
    n_thresh = float(op.attrs.get("nms_threshold", 0.3))
    s_thresh = float(op.attrs.get("score_threshold", 0.0))
    keep_k = int(op.attrs.get("keep_top_k", boxes.shape[0]))
    M = boxes.shape[0]
    iou = _pairwise_iou(boxes, boxes)
    # locality merge: each box becomes the score-weighted mean of its
    # high-overlap neighbours; its score the sum (reference weighted_merge)
    wgt = torch.where(iou > n_thresh, scores[None, :].expand(M, M),
                      torch.zeros_like(iou))
    merged = (wgt @ boxes) / torch.clamp(wgt.sum(1, keepdim=True), min=1e-8)
    mscores = wgt.sum(1)
    valid = _greedy_nms(merged, mscores, n_thresh, s_thresh, min(keep_k, M),
                        normalized=False)
    order = _stable_argsort(-torch.where(valid, mscores,
                                         torch.full_like(mscores, -INF)))[
        :keep_k]
    v = valid[order]
    row = torch.cat([torch.where(v, 0.0, -1.0).to(boxes.dtype)[:, None],
                     (mscores[order] * v)[:, None], merged[order] * v[:, None]],
                    dim=1)
    return {"Out": [row]}


@register_op("yolov3_loss", inputs=("X", "GTBox", "GTLabel", "GTScore"),
             outputs=("Loss", "ObjectnessMask", "GTMatchMask"),
             no_grad=("GTBox", "GTLabel", "GTScore"))
def _yolov3_loss(ctx, op, ins):
    """Reference detection/yolov3_loss_op.cc: per-gt best-anchor
    assignment, xy/wh regression + objectness + class BCE; anchors with
    IoU > ignore_thresh against any gt are excluded from the no-object
    loss."""
    x = ins["X"][0]                 # [N, mask*(5+C), H, W]
    gtbox = ins["GTBox"][0]         # [N, B, 4] (cx, cy, w, h; normalized)
    gtlabel = ins["GTLabel"][0]     # [N, B]
    anchors = [int(a) for a in op.attrs["anchors"]]
    amask = [int(a) for a in op.attrs.get(
        "anchor_mask", list(range(len(anchors) // 2)))]
    C = int(op.attrs["class_num"])
    ignore = float(op.attrs.get("ignore_thresh", 0.7))
    down = int(op.attrs.get("downsample_ratio", 32))
    use_label_smooth = bool(op.attrs.get("use_label_smooth", False))
    an_num = len(amask)
    N, _, H, W = x.shape
    B = gtbox.shape[1]
    dev = x.device
    x = x.reshape(N, an_num, 5 + C, H, W)
    input_size = down * H
    all_w = torch.tensor(anchors[0::2], dtype=torch.float32, device=dev)
    all_h = torch.tensor(anchors[1::2], dtype=torch.float32, device=dev)
    mask_w, mask_h = all_w[amask], all_h[amask]

    def bce(logit, t):
        return _softplus(logit) - t * logit

    gtscore = (ins["GTScore"][0] if ins.get("GTScore")
               else torch.ones(gtlabel.shape, dtype=torch.float32,
                               device=dev))
    losses, objs, matches = [], [], []
    for n in range(N):
        xi, gb, gl, gs = x[n], gtbox[n], gtlabel[n], gtscore[n]
        # gt -> best anchor over ALL anchors by wh IoU
        gw = gb[:, 2] * input_size
        gh = gb[:, 3] * input_size
        inter = torch.minimum(gw[:, None], all_w[None, :]) * \
            torch.minimum(gh[:, None], all_h[None, :])
        wh_iou = inter / (gw[:, None] * gh[:, None]
                          + all_w[None, :] * all_h[None, :] - inter + 1e-9)
        best = torch.argmax(wh_iou, dim=1)
        valid_gt = (gb[:, 2] > 0) & (gb[:, 3] > 0)
        local = torch.full((B,), -1, dtype=torch.int64, device=dev)
        for li, a in enumerate(amask):
            local = torch.where(best == a, li, local)
        gi = torch.clamp((gb[:, 0] * W).to(torch.int32), 0, W - 1).long()
        gj = torch.clamp((gb[:, 1] * H).to(torch.int32), 0, H - 1).long()
        responsible = valid_gt & (local >= 0)
        tx = gb[:, 0] * W - gi
        ty = gb[:, 1] * H - gj
        tw = torch.log(torch.clamp(gw / torch.clamp(all_w[best], min=1e-9),
                                   min=1e-9))
        th = torch.log(torch.clamp(gh / torch.clamp(all_h[best], min=1e-9),
                                   min=1e-9))
        scale = 2.0 - gb[:, 2] * gb[:, 3]  # small boxes weigh more
        li = torch.where(responsible, local, torch.zeros_like(local))
        cell = (li * H + gj) * W + gi
        obj_t = torch.zeros(an_num * H * W, dtype=torch.float32,
                            device=dev).scatter_reduce(
            0, cell, torch.where(responsible, gs, torch.zeros_like(gs)),
            "amax").reshape(an_num, H, W)
        # jax.nn.one_hot: a label out of [0, C) is a row of zeros
        onehot = F.one_hot(gl.long().clamp(0, C - 1), C).to(torch.float32) \
            * ((gl >= 0) & (gl < C))[:, None]
        if use_label_smooth:
            onehot = onehot * (1 - 1.0 / C) + 1.0 / C * 0.5
        cls_t = torch.zeros(an_num * H * W, C, dtype=torch.float32,
                            device=dev).index_add(
            0, cell, onehot * responsible[:, None]).reshape(an_num, H, W, C)
        # per-gt coordinate losses gathered at the responsible cell
        px = xi[li, 0, gj, gi]
        py = xi[li, 1, gj, gi]
        pw = xi[li, 2, gj, gi]
        ph = xi[li, 3, gj, gi]
        coord = (bce(px, tx) + bce(py, ty)
                 + 0.5 * ((pw - tw) ** 2 + (ph - th) ** 2)) * scale * gs
        coord_loss = torch.where(responsible, coord,
                                 torch.zeros_like(coord)).sum()
        # ignore mask: predicted boxes with IoU > thresh vs any gt
        with torch.no_grad():
            gxs = torch.arange(W, dtype=torch.float32, device=dev)[
                None, None, :]
            gys = torch.arange(H, dtype=torch.float32, device=dev)[
                None, :, None]
            pcx = (torch.sigmoid(xi[:, 0]) + gxs) / W
            pcy = (torch.sigmoid(xi[:, 1]) + gys) / H
            pww = torch.exp(torch.clamp(xi[:, 2], max=10.0)) * \
                mask_w[:, None, None] / input_size
            phh = torch.exp(torch.clamp(xi[:, 3], max=10.0)) * \
                mask_h[:, None, None] / input_size
            px1, px2 = pcx - pww / 2, pcx + pww / 2
            py1, py2 = pcy - phh / 2, pcy + phh / 2
            k4 = (slice(None), None, None, None)
            gx1 = (gb[:, 0] - gb[:, 2] / 2)[k4]
            gx2 = (gb[:, 0] + gb[:, 2] / 2)[k4]
            gy1 = (gb[:, 1] - gb[:, 3] / 2)[k4]
            gy2 = (gb[:, 1] + gb[:, 3] / 2)[k4]
            ix = torch.clamp(torch.minimum(px2, gx2) - torch.maximum(px1, gx1),
                             min=0)
            iy = torch.clamp(torch.minimum(py2, gy2) - torch.maximum(py1, gy1),
                             min=0)
            inter_p = ix * iy
            u = pww * phh + (gb[:, 2] * gb[:, 3])[k4] - inter_p
            ious = torch.where(valid_gt[k4], inter_p / torch.clamp(u, min=1e-9),
                               torch.zeros_like(inter_p))
            best_pred_iou = ious.amax(0) if B else torch.zeros_like(pcx)
            noobj_ok = (best_pred_iou <= ignore) & (obj_t == 0)
        pobj = xi[:, 4]
        obj_loss = torch.where(obj_t > 0, obj_t * bce(pobj, 1.0),
                               torch.zeros_like(pobj)).sum() + \
            torch.where(noobj_ok, bce(pobj, 0.0),
                        torch.zeros_like(pobj)).sum()
        pcls = xi[:, 5:].permute(0, 2, 3, 1)  # [an, H, W, C]
        cls_loss = torch.where((obj_t > 0)[..., None],
                               bce(pcls, torch.clamp(cls_t, 0, 1)),
                               torch.zeros_like(pcls)).sum()
        losses.append(coord_loss + obj_loss + cls_loss)
        objs.append(obj_t)
        matches.append(responsible)
    return {"Loss": [torch.stack(losses)], "ObjectnessMask": [torch.stack(objs)],
            "GTMatchMask": [torch.stack(matches).to(torch.int32)]}
