"""The detection ops of the port against the JAX package, on the CPU: the
24 lowerings of ``ops/detection.py``, the 10 of ``ops/detection2.py``
and ``ssd_loss_dense`` (``models/ssd.py``), with their layer functions.

Each case is a one-op Program in both packages
(``test_torch_activations.both``), run through the Executors: forward
outputs within rtol 1e-5 / atol 1e-6, integer outputs exactly, and the
input gradients (of a weighted sum of every float output, through
``append_backward``) within rtol 1e-4 / atol 1e-5
(``test_torch_rnn.check_split``).

* ``test_op_sweep_rows``: the rows of tests/test_op_sweep.py's
  ``SPECS`` for these ops.
* ``test_cases``: every other op, and the differentiable ones with
  their gradients, at several attrs.
* Ties, equal to JAX: exactly tied NMS scores, boxes at an IoU exactly
  equal to the NMS threshold (exactly representable corners), tied
  losses in ``mine_hard_examples`` and tied scores under ``lax.top_k``.
* ``test_nms_at_2000_boxes_equals_jax``: M = 2000, C = 5, held to
  JAX's ``fori_loop`` of 2000 iterations over its 2000 x 2000 IoU
  matrix, with every pick kept and with a keep_top_k.
* ``test_jax_op_tests_hold_for_the_port`` / ``_loop_oracles_``: the
  JAX package's own OpTests (tests/test_ops_detection.py,
  test_ops_detection2.py, numeric gradients included) and loop oracles
  (tests/test_detection_hard.py) run against the port, their ``fluid``
  swapped for ``paddle_tpu_torch``.
* ``test_fault_*``: two faults of the reference, not copied (ROADMAP
  §C), shown in both packages: ``box_clip`` clips every image to the
  first image's size, ``distribute_fpn_proposals`` routes the first
  image's rois alone.
* ``test_generate_proposal_labels_from_its_own_draws``: JAX jitters its
  ranking from its op key and the port from its generator, so JAX's
  lowering is run on the port's own draws.
* The layer functions (``layers.detection`` and the 27 ``layers/auto.py``
  rows over these ops) build the same Program as JAX's.
* ``test_every_detection_op_has_a_parity_case``: a ratchet over the ops
  ``ops/detection*.py`` and ``models/ssd.py`` register.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import op_test
import test_detection_hard as hard
import test_ops_detection as jdet
import test_ops_detection2 as jdet2
from test_op_sweep import SPECS
from test_torch_activations import both, run_op
from test_torch_rnn import check_split, f32

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401 (registers ssd_loss_dense)
import paddle_tpu_torch as fluid
import paddle_tpu_torch.models  # noqa: F401
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu.core.framework import unique_name as jax_unique_name
from paddle_tpu.core.registry import LoweringContext as JaxContext
from paddle_tpu.core.registry import get_op_def as jax_op_def
from paddle_tpu_torch.core.registry import (_OP_REGISTRY, LoweringContext,
                                            get_op_def)

MODULES = ("paddle_tpu_torch.ops.detection",
           "paddle_tpu_torch.ops.detection2", "paddle_tpu_torch.models.ssd")


def family_ops():
    return sorted(n for n, d in _OP_REGISTRY.items()
                  if not d.auto_grad and d.lower.__module__ in MODULES)


SWEEP = sorted(n for n in family_ops() if n in SPECS)


def _outs(op_type, n_out=None):
    outs = {s: 1 for s in get_op_def(op_type).output_slots}
    outs.update(n_out or {})
    return outs


@pytest.mark.parametrize("name", SWEEP)
def test_op_sweep_rows(name):
    row = SPECS[name]
    j, t = both(name, row["inputs"], row["attrs"],
                _outs(name, row["n_out"]), grads=tuple(row["grads"]))
    check_split(j, t)


# -- inputs -------------------------------------------------------------------


def boxes(n, seed=0, span=20.0, lo=1.0, hi=10.0, lead=()):
    """Corner boxes x1 < x2, y1 < y2."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(*lead, n, 2) * span
    wh = rng.rand(*lead, n, 2) * (hi - lo) + lo
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def unit_boxes(n, seed=0, lead=()):
    rng = np.random.RandomState(seed)
    xy = rng.rand(*lead, n, 2) * 0.7
    wh = rng.rand(*lead, n, 2) * 0.3 + 0.05
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def u01(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def i32(*shape, lo=0, hi=4, seed=0):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(np.int32)


# boxes on an integer grid: every IoU among them is a ratio of small
# integers, and some equal 0.5 exactly
GRID = np.array([[0, 0, 4, 1], [0, 0, 2, 1], [2, 0, 4, 1], [1, 0, 3, 1],
                 [0, 0, 4, 1], [6, 6, 8, 8], [6, 6, 8, 7], [6, 7, 8, 8]],
                np.float32)

ROIS = np.array([[0, 0, 5, 5], [1, 2, 7, 6], [2.5, 1, 4, 7.5]], np.float32)
QUADS = np.array([[1, 1, 6, 1.5, 5.5, 6, 0.5, 5],
                  [0, 0, 7, 0, 7, 7, 0, 7]], np.float32)
SSD_P, SSD_G, SSD_C = 24, 3, 4
SSD_GT = np.array([[[0.1, 0.1, 0.5, 0.6], [0.4, 0.3, 0.9, 0.8],
                    [0, 0, 0, 0]],
                   [[0.2, 0.5, 0.6, 0.95], [0, 0, 0, 0], [0, 0, 0, 0]]],
                  np.float32)

CASES = {
    "multiclass_nms": ("multiclass_nms",
                       {"BBoxes": boxes(30, lead=(2,)),
                        "Scores": u01(2, 4, 30, seed=1)},
                       {"background_label": 0, "score_threshold": 0.05,
                        "nms_threshold": 0.4, "keep_top_k": 10}, ()),
    "multiclass_nms_topk_eta": ("multiclass_nms",
                                {"BBoxes": boxes(30, lead=(2,)),
                                 "Scores": u01(2, 3, 30, seed=2)},
                                {"background_label": -1,
                                 "score_threshold": 0.1, "nms_top_k": 6,
                                 "nms_threshold": 0.7, "nms_eta": 0.9,
                                 "keep_top_k": -1, "normalized": False},
                                ()),
    "multiclass_nms_2d": ("multiclass_nms",
                          {"BBoxes": unit_boxes(12),
                           "Scores": u01(3, 12, seed=3)},
                          {"background_label": 2, "score_threshold": 0.2,
                           "nms_threshold": 0.3, "keep_top_k": 7}, ()),
    # exactly tied scores (a 0.25 grid) over boxes whose IoUs include
    # 0.5 exactly, at a threshold of 0.5: IoU > 0.5 suppresses, = does not
    "multiclass_nms_ties": ("multiclass_nms",
                            {"BBoxes": GRID[None],
                             "Scores": np.array([[[.5, .5, .75, .5, .75, .25,
                                                   .5, .5],
                                                  [.25] * 8]], np.float32)},
                            {"background_label": -1, "score_threshold": 0.1,
                             "nms_threshold": 0.5, "keep_top_k": 12}, ()),
    "multiclass_nms_ties_normalized": ("multiclass_nms",
                                       {"BBoxes": GRID[None] / 8,
                                        "Scores": np.full((1, 2, 8), 0.5,
                                                          np.float32)},
                                       {"background_label": -1,
                                        "score_threshold": 0.1,
                                        "nms_threshold": 1 / 3,
                                        "keep_top_k": -1}, ()),
    "multiclass_nms2_ties": ("multiclass_nms2",
                             {"BBoxes": GRID[None],
                              "Scores": np.full((1, 2, 8), 0.5, np.float32)},
                             {"background_label": 0, "score_threshold": 0.1,
                              "nms_threshold": 0.5, "keep_top_k": 5}, ()),
    "yolo_box": ("yolo_box", {"X": f32(2, 16, 4, 4, seed=4),
                              "ImgSize": np.array([[64, 64], [48, 80]],
                                                  np.int32)},
                 {"anchors": [10, 13, 16, 30], "class_num": 3,
                  "conf_thresh": 0.3, "downsample_ratio": 16}, ()),
    "yolo_box_unclipped_scaled": ("yolo_box",
                                  {"X": f32(1, 16, 3, 5, seed=5),
                                   "ImgSize": np.array([[40, 60]], np.int32)},
                                  {"anchors": [10, 13, 16, 30],
                                   "class_num": 3, "conf_thresh": 0.01,
                                   "clip_bbox": False, "scale_x_y": 1.2},
                                  ()),
    "anchor_generator": ("anchor_generator", {"Input": f32(1, 8, 3, 5)},
                         {"anchor_sizes": [32.0, 64.0],
                          "aspect_ratios": [0.5, 1.0, 2.0],
                          "stride": [16.0, 16.0]}, ()),
    "prior_box_flip_max": ("prior_box", {"Input": f32(1, 2, 3, 4),
                                         "Image": f32(1, 3, 24, 32)},
                           {"min_sizes": [6.0, 12.0],
                            "max_sizes": [12.0, 20.0],
                            "aspect_ratios": [1.0, 2.0, 3.0], "flip": True,
                            "clip": True}, ()),
    "box_coder_decode": ("box_coder",
                         {"PriorBox": unit_boxes(5),
                          "PriorBoxVar": np.tile(np.array(
                              [0.1, 0.1, 0.2, 0.2], np.float32), (5, 1)),
                          "TargetBox": f32(2, 5, 4, seed=6, scale=0.5)},
                         {"code_type": "decode_center_size"}, ()),
    "box_coder_unnormalized": ("box_coder",
                               {"PriorBox": boxes(4),
                                "TargetBox": boxes(4, seed=7)},
                               {"code_type": "encode_center_size",
                                "box_normalized": False}, ()),
    "roi_align": ("roi_align", {"X": f32(2, 3, 8, 8, seed=8), "ROIs": ROIS,
                                "RoisNum": np.array([2, 1], np.int32)},
                  {"pooled_height": 2, "pooled_width": 3,
                   "spatial_scale": 0.5}, ("X",)),
    "roi_align_sampling_3": ("roi_align", {"X": f32(1, 2, 6, 7, seed=9),
                                           "ROIs": ROIS},
                             {"pooled_height": 3, "pooled_width": 2,
                              "spatial_scale": 1.0, "sampling_ratio": 3},
                             ("X",)),
    # a constant plane makes every bin's max a tie: the gradient is
    # shared evenly among the tied samples, as JAX's reduce-max
    "roi_pool_ties": ("roi_pool", {"X": np.concatenate(
        [f32(2, 2, 8, 8, seed=10), np.ones((2, 1, 8, 8), np.float32)], 1),
        "ROIs": ROIS, "RoisNum": np.array([1, 2], np.int32)},
        {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0},
        ("X",)),
    "roi_pool_scaled": ("roi_pool", {"X": f32(1, 2, 6, 6, seed=11),
                                     "ROIs": ROIS * 1.5},
                        {"pooled_height": 3, "pooled_width": 2,
                         "spatial_scale": 0.5}, ("X",)),
    "sigmoid_focal_loss": ("sigmoid_focal_loss",
                           {"X": f32(6, 3, seed=12),
                            "Label": i32(6, 1, hi=4, seed=12),
                            "FgNum": np.array([3], np.int32)},
                           {"gamma": 2.0, "alpha": 0.25}, ("X",)),
    "sigmoid_focal_loss_gamma_1_5": ("sigmoid_focal_loss",
                                     {"X": f32(5, 4, seed=13),
                                      "Label": i32(5, 1, hi=5, seed=13),
                                      "FgNum": np.array([0], np.int32)},
                                     {"gamma": 1.5, "alpha": 0.4}, ("X",)),
    "bipartite_match": ("bipartite_match", {"DistMat": u01(5, 3, seed=14)},
                        {}, ()),
    "bipartite_match_per_prediction": ("bipartite_match",
                                       {"DistMat": u01(2, 6, 4, seed=15)},
                                       {"match_type": "per_prediction",
                                        "dist_threshold": 0.4}, ()),
    "bipartite_match_ties": ("bipartite_match",
                             {"DistMat": np.array([[0.5, 0.5, 0.25],
                                                   [0.5, 0.5, 0.5],
                                                   [0.0, 0.5, 0.5]],
                                                  np.float32)}, {}, ()),
    "target_assign": ("target_assign",
                      {"X": f32(2, 3, 4, seed=16),
                       "MatchIndices": i32(2, 6, lo=-1, hi=3, seed=16)},
                      {"mismatch_value": 0}, ()),
    "target_assign_negatives": ("target_assign",
                                {"X": f32(2, 3, 4, seed=17),
                                 "MatchIndices": i32(2, 6, lo=-1, hi=3,
                                                     seed=17),
                                 "NegIndices": i32(2, 6, hi=2, seed=18)},
                                {"mismatch_value": -1}, ()),
    "mine_hard_examples": ("mine_hard_examples",
                           {"ClsLoss": u01(2, 10, seed=19),
                            "MatchIndices": np.where(
                                u01(2, 10, seed=20) < 0.2, 0, -1).astype(
                                np.int32),
                            "MatchDist": u01(2, 10, seed=21)},
                           {"neg_pos_ratio": 2.0}, ()),
    # tied losses: the stable sort keeps equal losses in prior order
    "mine_hard_examples_ties": ("mine_hard_examples",
                                {"ClsLoss": np.array(
                                    [[.5, .5, .25, .5, .75, .5, .25, .5],
                                     [.5] * 8], np.float32),
                                 "MatchIndices": np.array(
                                    [[0, -1, -1, -1, -1, -1, -1, -1],
                                     [-1, 1, -1, -1, -1, -1, -1, -1]],
                                    np.int32),
                                 "MatchDist": np.zeros((2, 8), np.float32)},
                                {"neg_pos_ratio": 3.0}, ()),
    "box_decoder_and_assign": ("box_decoder_and_assign",
                               {"PriorBox": boxes(4, seed=22),
                                "PriorBoxVar": np.array([0.1, 0.1, 0.2, 0.2],
                                                        np.float32),
                                "TargetBox": f32(4, 12, seed=23, scale=0.3),
                                "BoxScore": u01(4, 3, seed=24)}, {}, ()),
    "polygon_box_transform": ("polygon_box_transform",
                              {"Input": f32(2, 4, 3, 5, seed=25)}, {}, ()),
    "deformable_conv": ("deformable_conv",
                        {"Input": f32(2, 4, 5, 5, seed=26),
                         "Offset": f32(2, 36, 5, 5, seed=27, scale=0.7),
                         "Mask": u01(2, 18, 5, 5, seed=28),
                         "Filter": f32(6, 2, 3, 3, seed=29)},
                        {"paddings": [1, 1], "groups": 2,
                         "deformable_groups": 2},
                        ("Input", "Offset", "Mask", "Filter")),
    "deformable_conv_v1": ("deformable_conv_v1",
                           {"Input": f32(1, 3, 7, 6, seed=30),
                            "Offset": f32(1, 18, 3, 1, seed=31, scale=0.6),
                            "Filter": f32(4, 3, 3, 3, seed=32)},
                           {"strides": [2, 2], "dilations": [1, 2]},
                           ("Input", "Offset", "Filter")),
    "psroi_pool": ("psroi_pool", {"X": f32(2, 8, 6, 6, seed=33),
                                  "ROIs": ROIS * 2,
                                  "RoisNum": np.array([2, 1], np.int32)},
                   {"output_channels": 2, "spatial_scale": 0.5,
                    "pooled_height": 2, "pooled_width": 2}, ("X",)),
    "prroi_pool": ("prroi_pool", {"X": f32(2, 3, 6, 6, seed=34),
                                  "ROIs": ROIS,
                                  "BatchRoINums": np.array([1, 2], np.int32)},
                   {"spatial_scale": 0.8, "pooled_height": 2,
                    "pooled_width": 3}, ("X",)),
    "deformable_psroi_pooling": ("deformable_psroi_pooling",
                                 {"Input": f32(2, 8, 6, 6, seed=35),
                                  "ROIs": ROIS,
                                  "Trans": f32(3, 2, 2, 2, seed=36),
                                  "RoisNum": np.array([2, 1], np.int32)},
                                 {"output_dim": 2, "pooled_height": 2,
                                  "pooled_width": 2, "spatial_scale": 0.9,
                                  "trans_std": 0.2}, ("Input", "Trans")),
    "roi_perspective_transform": ("roi_perspective_transform",
                                  {"X": f32(1, 2, 8, 8, seed=37),
                                   "ROIs": QUADS},
                                  {"transformed_height": 4,
                                   "transformed_width": 5,
                                   "spatial_scale": 1.0}, ()),
    "detection_map": ("detection_map",
                      {"DetectRes": np.concatenate([
                          i32(10, 1, lo=-1, hi=4, seed=38).astype(np.float32),
                          u01(10, 1, seed=39), boxes(10, seed=40, span=6)],
                          1),
                       "Label": np.concatenate([
                           i32(6, 1, hi=4, seed=41).astype(np.float32),
                           boxes(6, seed=42, span=6)], 1)},
                      {"class_num": 4, "overlap_threshold": 0.3}, ()),
    "detection_map_11point_difficult": (
        "detection_map",
        {"DetectRes": np.concatenate([
            i32(12, 1, lo=1, hi=3, seed=43).astype(np.float32),
            u01(12, 1, seed=44), boxes(12, seed=45, span=5)], 1),
         "Label": np.concatenate([
             i32(6, 1, lo=1, hi=3, seed=46).astype(np.float32),
             i32(6, 1, hi=2, seed=47).astype(np.float32),
             boxes(6, seed=48, span=5)], 1)},
        {"class_num": 3, "overlap_threshold": 0.2, "ap_type": "11point",
         "evaluate_difficult": False}, ()),
    "retinanet_target_assign": ("retinanet_target_assign",
                                {"Anchor": boxes(10, seed=49, span=12),
                                 "GtBoxes": boxes(3, seed=50, span=12),
                                 "GtLabels": np.array([[1], [0], [3]],
                                                      np.int32),
                                 "IsCrowd": np.array([[0], [0], [1]],
                                                     np.int32)},
                                {"positive_overlap": 0.3,
                                 "negative_overlap": 0.1}, ()),
    "generate_mask_labels": ("generate_mask_labels",
                             {"Rois": np.array([[1, 1, 8, 8], [0, 2, 5, 9],
                                                [3, 3, 9, 6]], np.float32),
                              "LabelsInt32": np.array([[1], [0], [3]],
                                                      np.int32),
                              "GtSegms": np.array(
                                  [[[0, 0], [9, 1], [8, 9], [1, 7], [1, 7]],
                                   [[3, 2], [9, 3], [6, 8], [2, 6], [3, 4]]],
                                  np.float32),
                              "GtClasses": np.array([[1], [3]], np.int32)},
                             {"resolution": 6, "num_classes": 4}, ()),
    "ssd_loss_dense": ("ssd_loss_dense",
                       {"Loc": f32(2, SSD_P, 4, seed=51, scale=0.5),
                        "Conf": f32(2, SSD_P, SSD_C, seed=52),
                        "GtBox": SSD_GT,
                        "GtLabel": np.array([[1, 3, 0], [2, 0, 0]],
                                            np.int64),
                        "Prior": unit_boxes(SSD_P, seed=53),
                        "PVar": np.tile(np.array([0.1, 0.1, 0.2, 0.2],
                                                 np.float32), (SSD_P, 1))},
                       {"overlap_threshold": 0.3, "neg_pos_ratio": 2.0},
                       ("Loc", "Conf")),
    # tied scores under lax.top_k (pre- and post-NMS) and NMS's argmax
    "generate_proposals_ties": (
        "generate_proposals",
        {"Scores": np.round(u01(2, 3, 4, 4, seed=54) * 4) / 4,
         "BboxDeltas": f32(2, 12, 4, 4, seed=55, scale=0.1),
         "ImInfo": np.array([[64, 64, 1.0], [48, 56, 1.0]], np.float32),
         "Anchors": (u01(4, 4, 3, 4, seed=56) * 32
                     + np.array([0, 0, 16, 16], np.float32)),
         "Variances": np.ones((4, 4, 3, 4), np.float32)},
        {"pre_nms_topN": 30, "post_nms_topN": 12, "nms_thresh": 0.6,
         "min_size": 1.0}, ()),
    "collect_fpn_proposals_ties": (
        "collect_fpn_proposals",
        {"MultiLevelRois": [boxes(5, seed=57), boxes(5, seed=58)],
         "MultiLevelScores": [np.full((5, 1), 0.5, np.float32),
                              np.array([[.5], [.75], [.5], [.25], [.75]],
                                       np.float32)],
         "MultiLevelRoIsNum": np.array([4, 5], np.int32)},
        {"post_nms_topN": 7}, ()),
    "rpn_target_assign_ties": (
        "rpn_target_assign",
        {"Anchor": GRID * 4, "GtBoxes": np.array([[0, 0, 16, 4],
                                                  [24, 24, 32, 32]],
                                                 np.float32)},
        {"rpn_batch_size_per_im": 6, "rpn_fg_fraction": 0.5,
         "rpn_positive_overlap": 0.5, "rpn_negative_overlap": 0.3}, ()),
    "retinanet_detection_output": (
        "retinanet_detection_output",
        {"BBoxes": [f32(2, 6, 4, seed=59, scale=0.1),
                    f32(2, 4, 4, seed=60, scale=0.1)],
         "Scores": [u01(2, 6, 3, seed=61), u01(2, 4, 3, seed=62)],
         "Anchors": [boxes(6, seed=63, span=30), boxes(4, seed=64, span=30)],
         "ImInfo": np.array([[40, 50, 1.0], [36, 36, 1.0]], np.float32)},
        {"score_threshold": 0.2, "nms_threshold": 0.4, "keep_top_k": 6,
         "nms_top_k": 5}, ()),
    "locality_aware_nms_scores_2d": (
        "locality_aware_nms",
        {"BBoxes": unit_boxes(10, seed=65)[None],
         "Scores": u01(1, 2, 10, seed=66)},
        {"nms_threshold": 0.2, "score_threshold": 0.1, "keep_top_k": 6},
        ()),
    "distribute_fpn_proposals_rois_num": (
        "distribute_fpn_proposals",
        {"FpnRois": boxes(8, seed=67, span=100, lo=8, hi=300),
         "RoisNum": np.array([6], np.int32)},
        {"min_level": 2, "max_level": 4, "refer_level": 3,
         "refer_scale": 112}, ()),
}

N_OUT = {"distribute_fpn_proposals": {"MultiFpnRois": 3}}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cases(name):
    op_type, inputs, attrs, grads = CASES[name]
    j, t = both(op_type, inputs, attrs, _outs(op_type, N_OUT.get(op_type)),
                grads=grads)
    check_split(j, t)


@pytest.mark.parametrize("keep_top_k", [-1, 50])
def test_nms_at_2000_boxes_equals_jax(keep_top_k):
    """JAX runs 2000 iterations over a 2000 x 2000 IoU matrix a class;
    the port stops a pair at its last candidate (or its keep_top_k-th
    pick): the same rows."""
    rng = np.random.RandomState(68)
    M, C = 2000, 5
    xy = rng.rand(1, M, 2) * 0.9
    b = np.concatenate([xy, xy + rng.rand(1, M, 2) * 0.1 + 0.01], -1)
    inputs = {"BBoxes": b.astype(np.float32),
              "Scores": rng.rand(1, C, M).astype(np.float32)}
    attrs = {"background_label": 0, "score_threshold": 0.3,
             "nms_threshold": 0.45, "keep_top_k": keep_top_k}
    j, t = both("multiclass_nms2", inputs, attrs, _outs("multiclass_nms2"))
    check_split(j, t)
    n = int(np.asarray(t["o_NmsRoisNum_0"])[0])
    assert n == keep_top_k if keep_top_k > 0 else n > 100


# -- the JAX package's own OpTests and loop oracles ----------------------------

# OpTest methods of tests/test_ops_detection*.py; TestRoiPoolShapes
# imports paddle_tpu inside its test, so its twin is written out below
OPTESTS = sorted(
    (mod.__name__, cls, meth)
    for mod in (jdet, jdet2)
    for cls in dir(mod)
    if cls.startswith("Test") and cls != "TestRoiPoolShapes"
    for meth in dir(getattr(mod, cls)) if meth.startswith("test"))
FUNCTIONS = [("test_ops_detection2", "test_generate_proposal_labels_sampling"),
             ("test_ops_detection2", "test_generate_mask_labels_square")]
_MODS = {"test_ops_detection": jdet, "test_ops_detection2": jdet2}


@pytest.mark.parametrize("mod,cls,meth", OPTESTS)
def test_jax_op_tests_hold_for_the_port(mod, cls, meth, monkeypatch):
    monkeypatch.setattr(op_test, "fluid", fluid)
    getattr(getattr(_MODS[mod], cls)(), meth)()


@pytest.mark.parametrize("mod,fn", FUNCTIONS)
def test_jax_detection_functions_hold_for_the_port(mod, fn, monkeypatch):
    monkeypatch.setattr(_MODS[mod], "fluid", fluid)
    getattr(_MODS[mod], fn)()


@pytest.mark.parametrize("fn", sorted(n for n in dir(hard)
                                      if n.startswith("test_")))
def test_loop_oracles_hold_for_the_port(fn, monkeypatch):
    monkeypatch.setattr(hard, "fluid", fluid)
    getattr(hard, fn)()


def test_roi_pool_sample_grid_invariants():
    """tests/test_ops_detection.py TestRoiPoolShapes on the port: the
    sample-grid max is at most each bin's true max and at least its
    median."""
    x = np.random.RandomState(7).randn(1, 2, 8, 8).astype("float32")
    out = run_op(fluid, "roi_pool",
                 {"X": x, "ROIs": np.array([[0, 0, 7, 7]], "float32")},
                 {"pooled_height": 2, "pooled_width": 2,
                  "spatial_scale": 1.0}, {"Out": 1, "Argmax": 1})["o_Out_0"]
    assert out.shape == (1, 2, 2, 2)
    for c in range(2):
        for py in range(2):
            for px in range(2):
                patch = x[0, c, py * 4:(py + 1) * 4, px * 4:(px + 1) * 4]
                assert out[0, c, py, px] <= patch.max() + 1e-5
                assert out[0, c, py, px] >= np.median(patch) - 1e-5


# -- faults of the reference, not copied -----------------------------------------


def test_fault_box_clip_clips_each_image_to_its_own_size():
    """JAX clips every image's boxes to the first image's ImInfo; the
    port to each image's own (the reference's box_clip_op)."""
    b = np.array([[[-2, 3, 30, 12], [5, -1, 9, 25]],
                  [[-2, 3, 30, 12], [5, -1, 9, 25]]], np.float32)
    info = np.array([[10, 10, 1], [20, 40, 1]], np.float32)
    j = run_op(jfluid, "box_clip", {"Input": b, "ImInfo": info},
               outs={"Output": 1})["o_Output_0"]
    t = run_op(fluid, "box_clip", {"Input": b, "ImInfo": info},
               outs={"Output": 1})["o_Output_0"]
    want = np.array([[[0, 3, 9, 9], [5, 0, 9, 9]],
                     [[0, 3, 30, 12], [5, 0, 9, 19]]], np.float32)
    np.testing.assert_array_equal(t, want)
    np.testing.assert_array_equal(j[0], want[0])
    np.testing.assert_array_equal(j[1], want[0])      # JAX: image 0's size
    # one image: the two packages agree
    np.testing.assert_array_equal(
        run_op(fluid, "box_clip", {"Input": b[:1], "ImInfo": info[1:]},
               outs={"Output": 1})["o_Output_0"],
        run_op(jfluid, "box_clip", {"Input": b[:1], "ImInfo": info[1:]},
               outs={"Output": 1})["o_Output_0"])


def test_fault_distribute_fpn_proposals_routes_every_images_rois():
    """RoisNum [3, 2] over 8 packed rows: JAX routes the first image's 3
    rows and drops the second's 2; the port routes all 5 and no
    padding."""
    rois = boxes(8, seed=72, span=100, lo=8, hi=300)
    attrs = {"min_level": 2, "max_level": 4, "refer_level": 3,
             "refer_scale": 112}
    outs = {"MultiFpnRois": 3, "RestoreIndex": 1, "MultiLevelRoIsNum": 1}
    res = [run_op(pkg, "distribute_fpn_proposals",
                  {"FpnRois": rois, "RoisNum": np.array([3, 2], np.int32)},
                  attrs, outs)["o_MultiLevelRoIsNum_0"]
           for pkg in (jfluid, fluid)]
    assert int(res[0].sum()) == 3 and int(res[1].sum()) == 5
    one = [run_op(pkg, "distribute_fpn_proposals",
                  {"FpnRois": rois, "RoisNum": np.array([5], np.int32)},
                  attrs, outs) for pkg in (jfluid, fluid)]
    check_split(*one)
    np.testing.assert_array_equal(one[1]["o_MultiLevelRoIsNum_0"], res[1])


# -- generate_proposal_labels: the port's own draws ----------------------------


class _Op:
    def __init__(self, type, attrs, inputs, outputs):
        self.type, self.attrs = type, attrs
        self.inputs, self.outputs = inputs, outputs


def test_generate_proposal_labels_from_its_own_draws(monkeypatch):
    R = 12
    gtb = boxes(3, seed=70, span=40, hi=20)
    # half the proposals near a ground truth, half anywhere
    rois = np.concatenate([np.repeat(gtb, 2, 0) + f32(6, 4, seed=69),
                           boxes(6, seed=71, span=40, hi=20)])
    gtc = np.array([[1], [0], [2]], np.int32)
    crowd = np.array([[0], [0], [1]], np.int32)
    attrs = {"batch_size_per_im": 8, "fg_fraction": 0.5, "fg_thresh": 0.3,
             "bg_thresh_hi": 0.3, "bg_thresh_lo": 0.0, "op_ident": 5}
    slots = ("Rois", "LabelsInt32", "BboxTargets", "BboxInsideWeights",
             "BboxOutsideWeights")
    op = _Op("generate_proposal_labels", attrs,
             {"RpnRois": ["r"], "GtClasses": ["c"], "GtBoxes": ["b"],
              "IsCrowd": ["k"]}, {s: [s] for s in slots})
    ctx = LoweringContext("cpu", seed=11, step=3)
    ins = {"RpnRois": [torch.from_numpy(rois)],
           "GtClasses": [torch.from_numpy(gtc)],
           "GtBoxes": [torch.from_numpy(gtb)],
           "IsCrowd": [torch.from_numpy(crowd)]}
    got = get_op_def("generate_proposal_labels").lower(ctx, op, ins)
    u = torch.rand((R,), generator=ctx.op_generator(op)).numpy()
    assert ((u >= 0) & (u < 1)).all()
    again = get_op_def("generate_proposal_labels").lower(ctx, op, ins)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(u))
    want = jax_op_def("generate_proposal_labels").lower(
        JaxContext(), op, {s: [jnp.asarray(v[0].numpy())]
                           for s, v in ins.items()})
    for s in slots:
        a, b = np.asarray(want[s][0]), got[s][0].numpy()
        assert a.shape == b.shape, s
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=s)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                       err_msg=s)
        np.testing.assert_array_equal(again[s][0].numpy(), b, err_msg=s)
    labels = got["LabelsInt32"][0].numpy().ravel()
    assert (labels > 0).any() and (labels == 0).any()


# -- the layer functions -------------------------------------------------------


def _layer_program(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    names = jax_unique_name if pkg is jfluid else fluid.unique_name
    with pkg.program_guard(main, startup), names.guard():
        build(pkg.layers)
    return main


def _d(L, name, shape, dtype="float32"):
    return L.data(name, shape, append_batch_size=False, dtype=dtype)


LAYERS = {
    "iou_similarity": lambda L: L.iou_similarity(_d(L, "x", [5, 4]),
                                                 _d(L, "y", [3, 4])),
    "box_coder": lambda L: L.box_coder(_d(L, "p", [6, 4]), _d(L, "v", [6, 4]),
                                       _d(L, "t", [2, 6, 4]),
                                       code_type="decode_center_size"),
    "prior_box": lambda L: L.prior_box(_d(L, "f", [1, 4, 3, 3]),
                                       _d(L, "i", [1, 3, 12, 12]), [4.0],
                                       max_sizes=[8.0], aspect_ratios=[2.0],
                                       flip=True),
    "sigmoid_focal_loss": lambda L: L.sigmoid_focal_loss(
        _d(L, "x", [6, 3]), _d(L, "l", [6, 1], "int32"),
        _d(L, "f", [1], "int32")),
    "deformable_conv": lambda L: L.deformable_conv(
        _d(L, "x", [1, 2, 5, 5]), _d(L, "o", [1, 18, 5, 5]),
        _d(L, "w", [3, 2, 3, 3]), mask=_d(L, "m", [1, 9, 5, 5]),
        paddings=[1, 1]),
    "deformable_roi_pooling": lambda L: L.deformable_roi_pooling(
        _d(L, "x", [1, 8, 6, 6]), _d(L, "r", [3, 4]), _d(L, "t", [3, 2, 2, 2]),
        output_dim=2, pooled_height=2, pooled_width=2),
    "psroi_pool": lambda L: L.psroi_pool(_d(L, "x", [1, 8, 6, 6]),
                                         _d(L, "r", [3, 4]),
                                         output_channels=2, pooled_height=2,
                                         pooled_width=2),
    "prroi_pool": lambda L: L.prroi_pool(_d(L, "x", [1, 3, 6, 6]),
                                         _d(L, "r", [3, 4]), pooled_height=2,
                                         pooled_width=2),
    "roi_align": lambda L: L.roi_align(_d(L, "x", [2, 3, 8, 8]),
                                       _d(L, "r", [3, 4]),
                                       _d(L, "n", [2], "int32"),
                                       pooled_height=2, pooled_width=2),
    "roi_pool": lambda L: L.roi_pool(_d(L, "x", [1, 3, 8, 8]),
                                     _d(L, "r", [3, 4]), pooled_height=2,
                                     pooled_width=2),
    "roi_perspective_transform": lambda L: L.roi_perspective_transform(
        _d(L, "x", [1, 2, 8, 8]), _d(L, "r", [2, 8]), transformed_height=3,
        transformed_width=4),
    "anchor_generator": lambda L: L.anchor_generator(
        _d(L, "x", [1, 4, 3, 5]), anchor_sizes=[32.0, 64.0]),
    "bipartite_match": lambda L: L.bipartite_match(_d(L, "d", [5, 3])),
    "box_clip": lambda L: L.box_clip(_d(L, "b", [4, 4]),
                                     _d(L, "i", [1, 3])),
    "box_decoder_and_assign": lambda L: L.box_decoder_and_assign(
        _d(L, "p", [4, 4]), _d(L, "v", [4]), _d(L, "t", [4, 12]),
        _d(L, "s", [4, 3])),
    "density_prior_box": lambda L: L.density_prior_box(
        _d(L, "f", [1, 2, 3, 3]), _d(L, "i", [1, 3, 12, 12]),
        densities=[2], fixed_sizes=[4.0]),
    "multiclass_nms": lambda L: L.multiclass_nms(
        _d(L, "b", [2, 8, 4]), _d(L, "s", [2, 3, 8]), keep_top_k=5),
    "locality_aware_nms": lambda L: L.locality_aware_nms(
        _d(L, "b", [8, 4]), _d(L, "s", [8]), keep_top_k=4),
    "yolo_box": lambda L: L.yolo_box(_d(L, "x", [1, 16, 4, 4]),
                                     _d(L, "s", [1, 2], "int32"),
                                     anchors=[10, 13, 16, 30], class_num=3),
    "yolov3_loss": lambda L: L.yolov3_loss(
        _d(L, "x", [1, 16, 4, 4]), _d(L, "g", [1, 2, 4]),
        _d(L, "l", [1, 2], "int32"), anchors=[10, 13, 16, 30],
        anchor_mask=[0, 1], class_num=3),
    "target_assign": lambda L: L.target_assign(
        _d(L, "x", [2, 3, 4]), _d(L, "m", [2, 6], "int32")),
    "rpn_target_assign": lambda L: L.rpn_target_assign(
        _d(L, "a", [12, 4]), _d(L, "g", [2, 4]), rpn_batch_size_per_im=6),
    "retinanet_target_assign": lambda L: L.retinanet_target_assign(
        _d(L, "a", [10, 4]), _d(L, "g", [3, 4]), _d(L, "l", [3, 1], "int32")),
    "retinanet_detection_output": lambda L: L.retinanet_detection_output(
        [_d(L, "b", [1, 6, 4])], [_d(L, "s", [1, 6, 3])],
        [_d(L, "a", [6, 4])], _d(L, "i", [1, 3]), keep_top_k=4),
    "generate_proposals": lambda L: L.generate_proposals(
        _d(L, "s", [1, 3, 4, 4]), _d(L, "d", [1, 12, 4, 4]),
        _d(L, "i", [1, 3]), _d(L, "a", [4, 4, 3, 4]),
        _d(L, "v", [4, 4, 3, 4]), pre_nms_topN=20, post_nms_topN=5),
    "generate_proposal_labels": lambda L: L.generate_proposal_labels(
        _d(L, "r", [12, 4]), _d(L, "c", [3, 1], "int32"),
        gt_boxes=_d(L, "b", [3, 4]), batch_size_per_im=8),
    "generate_mask_labels": lambda L: L.generate_mask_labels(
        _d(L, "c", [2, 1], "int32"), _d(L, "g", [2, 5, 2]),
        _d(L, "r", [3, 4]), _d(L, "l", [3, 1], "int32"), num_classes=4,
        resolution=6),
    "collect_fpn_proposals": lambda L: L.collect_fpn_proposals(
        [_d(L, "r0", [5, 4]), _d(L, "r1", [5, 4])],
        [_d(L, "s0", [5, 1]), _d(L, "s1", [5, 1])], post_nms_top_n=6),
    "distribute_fpn_proposals": lambda L: L.distribute_fpn_proposals(
        _d(L, "r", [8, 4])),
    "polygon_box_transform": lambda L: L.polygon_box_transform(
        _d(L, "x", [1, 4, 3, 5])),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_functions_build_jax_programs(name):
    j = _layer_program(jfluid, LAYERS[name])
    t = _layer_program(fluid, LAYERS[name])
    jd, td = j.to_dict(), t.to_dict()
    for b in jd["blocks"] + td["blocks"]:
        for op in b["ops"]:
            op["attrs"].pop("op_ident", None)
            op["attrs"].pop("op_callstack", None)
    assert td["blocks"][0]["ops"] == jd["blocks"][0]["ops"]
    assert td["blocks"][0]["vars"] == jd["blocks"][0]["vars"]


def test_every_detection_op_has_a_parity_case():
    covered = (set(SWEEP) | {c[0] for c in CASES.values()}
               | {"generate_proposal_labels"})
    missing = sorted(set(family_ops()) - covered)
    assert not missing, f"registered without a parity case: {missing}"
    assert len(family_ops()) == 35
    exported = {n for n in dir(fluid.layers) if not n.startswith("_")
                and callable(getattr(fluid.layers, n))}
    assert set(LAYERS) <= exported
    assert len(LAYERS) == 30
