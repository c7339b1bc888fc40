"""SSD single-shot detector: the port's copy of
``paddle_tpu/models/ssd.py`` (multi-box heads, the matching loss, NMS
inference), building the same Program with the same parameter names.

Reference analogue: python/paddle/fluid/layers/detection.py
(multi_box_head, ssd_loss, detection_output) over
operators/detection/*, as used by the SSD / MobileNet-SSD models.

``ssd_loss_dense`` matches and mines inside the step, as JAX's: a prior
is positive when its best ground-truth IoU reaches the threshold, and
hard negative mining keeps the negatives of highest confidence loss,
ranked by a stable sort (equal losses in prior order, as
``jnp.argsort``). Importing ``paddle_tpu_torch.models`` registers it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import layers
from ..core.framework import Program, program_guard, unique_name
from ..core.registry import register_op
from ..layer_helper import LayerHelper
from ..ops.detection import INF, _pairwise_iou, _rank, _stable_argsort

__all__ = ["multi_box_head", "ssd_loss", "detection_output", "build_ssd",
           "synthetic_det_batch", "match_and_mine"]


def multi_box_head(feats, image, num_classes, min_sizes, max_sizes=None,
                   aspect_ratios=None):
    """Conv loc / conf heads + priors a feature map.

    feats: list of [B, C, H, W] Variables; image: the input image var
    (prior_box reads its spatial extent). Returns (loc [B, P, 4],
    conf [B, P, num_classes], priors [P, 4], prior_vars [P, 4]).
    """
    aspect_ratios = aspect_ratios or [[2.0]] * len(feats)
    locs, confs, priors, pvars = [], [], [], []
    for i, feat in enumerate(feats):
        # priors a cell: min + (geometric-mean max) + one per non-1
        # aspect ratio incl. flipped (mirrors the prior_box lowering)
        full_ars = []
        for a in aspect_ratios[i]:
            full_ars.append(a)
            if a != 1.0:
                full_ars.append(1.0 / a)
        n_priors = 1 + (1 if max_sizes else 0) + sum(
            1 for a in full_ars if a != 1.0)
        loc = layers.conv2d(feat, n_priors * 4, 3, padding=1)
        conf = layers.conv2d(feat, n_priors * num_classes, 3, padding=1)
        # [B, A*4, H, W] -> [B, H*W*A, 4]
        loc = layers.reshape(layers.transpose(loc, [0, 2, 3, 1]), [0, -1, 4])
        conf = layers.reshape(layers.transpose(conf, [0, 2, 3, 1]),
                              [0, -1, num_classes])
        box, var = layers.prior_box(
            feat, image, min_sizes=[min_sizes[i]],
            max_sizes=[max_sizes[i]] if max_sizes else None,
            aspect_ratios=aspect_ratios[i], flip=True, clip=True)
        locs.append(loc)
        confs.append(conf)
        priors.append(layers.reshape(box, [-1, 4]))
        pvars.append(layers.reshape(var, [-1, 4]))
    return (layers.concat(locs, axis=1), layers.concat(confs, axis=1),
            layers.concat(priors, axis=0), layers.concat(pvars, axis=0))


def _encode(gt, pr, pv):
    pw = torch.clamp(pr[..., 2] - pr[..., 0], min=1e-6)
    ph = torch.clamp(pr[..., 3] - pr[..., 1], min=1e-6)
    pcx = pr[..., 0] + pw * 0.5
    pcy = pr[..., 1] + ph * 0.5
    gw = torch.clamp(gt[..., 2] - gt[..., 0], min=1e-6)
    gh = torch.clamp(gt[..., 3] - gt[..., 1], min=1e-6)
    gcx = gt[..., 0] + gw * 0.5
    gcy = gt[..., 1] + gh * 0.5
    t = torch.stack([(gcx - pcx) / pw, (gcy - pcy) / ph,
                     torch.log(gw / pw), torch.log(gh / ph)], -1)
    return t / pv


def match_and_mine(conf, gt_box, gt_label, prior, overlap_threshold=0.5,
                   neg_pos_ratio=3.0):
    """``ssd_loss_dense``'s matching and mining: a prior is positive when
    its best valid ground truth (label > 0; the first of equal IoUs)
    reaches ``overlap_threshold``; its softmax loss against its target
    label (0 for a negative); the hard negatives, the ``neg_pos_ratio``
    x positives (at most P - 1) negatives of highest loss, by a stable
    sort. Returns (positive [B, P], best gt [B, P], loss [B, P], hard
    negative [B, P])."""
    P = conf.shape[1]
    ious = _pairwise_iou(prior, gt_box)              # [B, P, G]
    ious = torch.where((gt_label > 0)[:, None, :], ious,
                       torch.full_like(ious, -1.0))
    best_gt = torch.argmax(ious, dim=2)
    pos = ious.amax(2) >= overlap_threshold
    tgt_label = torch.where(pos, torch.gather(gt_label, 1, best_gt),
                            torch.zeros_like(best_gt, dtype=gt_label.dtype))
    logp = torch.log_softmax(conf, -1)
    conf_loss = -torch.gather(logp, 2, tgt_label.long()[..., None])[..., 0]
    n_pos = pos.sum(1).to(torch.int32)
    n_neg = torch.clamp((neg_pos_ratio * n_pos).to(torch.int32), max=P - 1)
    neg_score = torch.where(pos, torch.full_like(conf_loss, -INF),
                            conf_loss.detach())
    rank = _rank(_stable_argsort(-neg_score, dim=1))
    return pos, best_gt, conf_loss, ~pos & (rank < n_neg[:, None])


@register_op("ssd_loss_dense",
             inputs=("Loc", "Conf", "GtBox", "GtLabel", "Prior", "PVar"),
             outputs=("Loss",),
             no_grad=("GtBox", "GtLabel", "Prior", "PVar"))
def _ssd_loss_dense(ctx, op, ins):
    """JAX's ``ssd_loss_dense`` (``paddle_tpu/models/ssd.py:76-142``) for
    the whole batch at once: the mean over images of (loc_weight *
    smooth-L1 of the positives + conf_weight * softmax loss of the
    positives and the mined negatives) / max(positives, 1)."""
    loc_p = ins["Loc"][0]       # [B, P, 4]
    gtb = ins["GtBox"][0]       # [B, G, 4]
    lw = float(op.attrs.get("loc_weight", 1.0))
    cw = float(op.attrs.get("conf_weight", 1.0))
    B, P, _ = loc_p.shape
    pos, best_gt, conf_loss, hard_neg = match_and_mine(
        ins["Conf"][0], gtb, ins["GtLabel"][0], ins["Prior"][0],
        float(op.attrs.get("overlap_threshold", 0.5)),
        float(op.attrs.get("neg_pos_ratio", 3.0)))
    tgt_loc = _encode(torch.gather(gtb, 1, best_gt[..., None].expand(
        B, P, 4)), ins["Prior"][0], ins["PVar"][0])
    diff = loc_p - tgt_loc
    absd = torch.abs(diff)
    smooth = torch.where(absd < 1.0, 0.5 * diff * diff, absd - 0.5)
    loc_loss = (smooth.sum(-1) * pos.to(smooth.dtype)).sum(1)
    conf_total = (conf_loss * (pos | hard_neg).to(conf_loss.dtype)).sum(1)
    denom = torch.clamp(pos.sum(1).to(torch.float32), min=1.0)
    losses = (lw * loc_loss + cw * conf_total) / denom
    return {"Loss": [losses.mean().reshape(1)]}


def ssd_loss(loc, conf, gt_box, gt_label, prior, pvar,
             overlap_threshold=0.5, neg_pos_ratio=3.0, loc_weight=1.0,
             conf_weight=1.0):
    """Matching + mined SSD loss (reference layers/detection.py
    ssd_loss). gt_box [B, G, 4] (corner form, zero rows = padding),
    gt_label [B, G] int (0 = background / pad)."""
    helper = LayerHelper("ssd_loss")
    out = helper.create_variable_for_type_inference(shape=(1,))
    helper.append_op(
        type="ssd_loss_dense",
        inputs={"Loc": [loc], "Conf": [conf], "GtBox": [gt_box],
                "GtLabel": [gt_label], "Prior": [prior], "PVar": [pvar]},
        outputs={"Loss": [out]},
        attrs={"overlap_threshold": overlap_threshold,
               "neg_pos_ratio": neg_pos_ratio, "loc_weight": loc_weight,
               "conf_weight": conf_weight})
    return out


def detection_output(loc, conf, prior, pvar, nms_threshold=0.45,
                     score_threshold=0.01, keep_top_k=20,
                     background_label=0):
    """Decode + NMS (reference layers/detection.py detection_output):
    box_coder decode_center_size, then multiclass_nms."""
    decoded = layers.box_coder(
        prior_box=prior, prior_box_var=pvar, target_box=loc,
        code_type="decode_center_size", box_normalized=True, axis=0)
    helper = LayerHelper("detection_output")
    scores = layers.transpose(layers.softmax(conf), [0, 2, 1])  # [B, C, P]
    out = helper.create_variable_for_type_inference()
    nums = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(
        type="multiclass_nms",
        inputs={"BBoxes": [decoded], "Scores": [scores]},
        outputs={"Out": [out], "NmsRoisNum": [nums]},
        attrs={"nms_threshold": nms_threshold,
               "score_threshold": score_threshold,
               "keep_top_k": keep_top_k,
               "background_label": background_label})
    return out, nums


def build_ssd(image_size=32, num_classes=4, optimizer=None, max_gt=4):
    """Tiny SSD over a 2-scale conv backbone. Returns
    (main, startup, feeds, fetches)."""
    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        img = layers.data("image", [3, image_size, image_size])
        gt_box = layers.data("gt_box", [max_gt, 4])
        gt_label = layers.data("gt_label", [max_gt], dtype="int64")
        c1 = layers.conv2d(img, 8, 3, stride=2, padding=1, act="relu")
        c2 = layers.conv2d(c1, 16, 3, stride=2, padding=1, act="relu")
        c3 = layers.conv2d(c2, 16, 3, stride=2, padding=1, act="relu")
        loc, conf, prior, pvar = multi_box_head(
            [c2, c3], img, num_classes,
            min_sizes=[image_size * 0.2, image_size * 0.4],
            max_sizes=[image_size * 0.5, image_size * 0.8])
        loss = layers.reduce_sum(ssd_loss(loc, conf, gt_box, gt_label, prior,
                                          pvar))
        if optimizer is not None:
            optimizer.minimize(loss)
        nmsed, nums = detection_output(loc, conf, prior, pvar)
    return main, startup, {"image": "image", "gt_box": "gt_box",
                           "gt_label": "gt_label"}, {
        "loss": loss, "detections": nmsed, "det_nums": nums}


def synthetic_det_batch(rng: np.random.RandomState, batch, image_size=32,
                        num_classes=4, max_gt=4):
    """JAX's synthetic batch: uniform images, 1..max_gt boxes an image
    (labels 1..num_classes-1), zero rows padding."""
    img = rng.rand(batch, 3, image_size, image_size).astype("float32")
    boxes = np.zeros((batch, max_gt, 4), "float32")
    labels = np.zeros((batch, max_gt), "int64")
    for b in range(batch):
        n = rng.randint(1, max_gt + 1)
        for g in range(n):
            cx, cy = rng.rand(2) * 0.6 + 0.2
            w, h = rng.rand(2) * 0.3 + 0.15
            boxes[b, g] = [max(cx - w / 2, 0), max(cy - h / 2, 0),
                           min(cx + w / 2, 1), min(cy + h / 2, 1)]
            labels[b, g] = rng.randint(1, num_classes)
    return {"image": img, "gt_box": boxes, "gt_label": labels}
