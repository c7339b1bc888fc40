"""Table-driven layer wrappers over registered ops: the port's copy of
``paddle_tpu/layers/auto.py``.

Reference: python/paddle/fluid/layers/{nn,detection,tensor,...}.py —
hundreds of near-identical functions whose body is create_var +
append_op. One spec row per layer generates a real function (a true
positional / keyword signature via exec) that emits the op. The rows
are the JAX package's (``paddle_tpu/layers/auto.py``) but those a
hand-written layer of the port covers.

Spec row: name: (op_type, [(arg, slot, required)], [(attr, default)],
[outputs], stop_gradient) — a slot not required is fed only when its
argument is not None.

Output shapes come from running the op's own lowering on ``meta``
tensors (no data, no device), with -1 / None dims taken as 1, as the
JAX package's ``jax.eval_shape`` pass does; an op whose lowering reads
values to the host (or fails) leaves its outputs shape-less.
"""

from __future__ import annotations

import torch

from .. import ops as _ops  # noqa: F401 (registers the rows' lowerings)
from ..core.executor import torch_dtype
from ..core.registry import LoweringContext, get_op_def
from ..layer_helper import LayerHelper

__all__ = []  # populated by _generate below


def _infer_shapes(op_type, ins, attrs, out_slots):
    """{slot: [(shape, dtype)]} from the lowering on meta tensors, or
    None when an input has no shape or the lowering cannot run so."""
    metas = {}
    for slot, vs in ins.items():
        lst = []
        for v in vs:
            shape = getattr(v, "shape", None)
            if shape is None:
                return None
            try:
                dt = torch_dtype(str(v.dtype or "float32"))
            except (KeyError, TypeError, ValueError):
                return None
            lst.append(torch.empty(
                tuple(1 if (d is None or int(d) < 0) else int(d)
                      for d in shape), dtype=dt, device="meta"))
        metas[slot] = lst

    class _P:
        pass

    op = _P()
    op.type = op_type
    op.attrs = dict(attrs, op_ident=0)
    op.inputs = {s: [getattr(v, "name", "x") for v in vs]
                 for s, vs in ins.items()}
    op.outputs = {s: [f"{op_type}_o"] for s in out_slots}
    try:
        with torch.no_grad():
            res = get_op_def(op_type).lower(LoweringContext("meta"), op,
                                            metas)
    except Exception:  # data-dependent lowerings stay shape-less
        return None
    return {s: [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for t in res.get(s, []) if isinstance(t, torch.Tensor)]
            for s in out_slots}


def _emit(op_type, input_map, attrs, out_slots, stop_gradient):
    helper = LayerHelper(op_type)
    ins = {}
    for slot, val in input_map.items():
        if val is None:
            continue
        ins[slot] = list(val) if isinstance(val, (list, tuple)) else [val]
    inferred = _infer_shapes(op_type, ins, attrs, out_slots)
    outs = {}
    ret = []
    for slot in out_slots:
        shape = dtype = None
        if inferred and inferred.get(slot):
            shape, dtype = inferred[slot][0]
        v = helper.create_variable_for_type_inference(
            dtype=dtype or "float32", shape=shape,
            stop_gradient=stop_gradient)
        outs[slot] = [v]
        ret.append(v)
    helper.append_op(type=op_type, inputs=ins, outputs=outs, attrs=attrs)
    return ret[0] if len(ret) == 1 else tuple(ret)


# name: (op_type, inputs [(arg, slot, required)], attrs [(name, default)],
#        outputs, stop_gradient)
_SPECS = {
    "gather_tree": ("gather_tree", [("ids", "Ids", 1),
                                    ("parents", "Parents", 1)],
                    [], ["Out"], True),
    "chunk_eval": ("chunk_eval", [("input", "Inference", 1),
                                  ("label", "Label", 1),
                                  ("seq_length", "SeqLength", 0)],
                   [("chunk_scheme", "IOB"), ("num_chunk_types", 1),
                    ("excluded_chunk_types", [])],
                   ["Precision", "Recall", "F1-Score", "NumInferChunks",
                    "NumLabelChunks", "NumCorrectChunks"], True),
    "edit_distance": ("edit_distance", [("input", "Hyps", 1),
                                        ("label", "Refs", 1)],
                      [("normalized", True)],
                      ["Out", "SequenceNum"], True),
    "warpctc": ("warpctc", [("input", "Logits", 1), ("label", "Label", 1),
                            ("input_length", "LogitsLength", 0),
                            ("label_length", "LabelLength", 0)],
                [("blank", 0), ("norm_by_times", False)],
                ["Loss"], False),
    "linear_chain_crf": ("linear_chain_crf",
                         [("input", "Emission", 1), ("label", "Label", 1),
                          ("transition", "Transition", 1),
                          ("length", "Length", 0)], [],
                         ["Alpha", "EmissionExps", "TransitionExps",
                          "LogLikelihood"], False),
    "crf_decoding": ("crf_decoding",
                     [("input", "Emission", 1),
                      ("transition", "Transition", 1),
                      ("label", "Label", 0), ("length", "Length", 0)],
                     [], ["ViterbiPath"], True),
    "row_conv": ("row_conv", [("input", "X", 1), ("filter", "Filter", 1)],
                 [], ["Out"], False),
    "im2sequence": ("im2sequence", [("input", "X", 1)],
                    [("kernels", [3, 3]), ("strides", [1, 1]),
                     ("paddings", [0, 0, 0, 0])], ["Out"], False),
    "lod_reset": ("lod_reset", [("x", "X", 1), ("y", "Y", 0)],
                  [("target_lod", [])], ["Out"], False),
    "reorder_lod_tensor_by_rank": ("reorder_lod_tensor_by_rank",
                                   [("x", "X", 1),
                                    ("rank_table", "RankTable", 1)],
                                   [], ["Out"], False),
    "tensor_array_to_tensor": ("tensor_array_to_tensor",
                               [("input", "X", 1)],
                               [("axis", 0), ("use_stack", False)],
                               ["Out", "OutIndex"], False),
    "sequence_conv": ("sequence_conv", [("input", "X", 1),
                                        ("filter", "Filter", 1),
                                        ("length", "Length", 0)],
                      [("contextLength", 3), ("contextStart", -1)],
                      ["Out"], False),
    "sequence_enumerate": ("sequence_enumerate", [("input", "X", 1)],
                           [("win_size", 2), ("pad_value", 0)],
                           ["Out"], True),
    "sequence_expand_as": ("sequence_expand_as",
                           [("x", "X", 1), ("y", "Y", 1)],
                           [], ["Out"], False),
    "sequence_scatter": ("sequence_scatter",
                         [("input", "X", 1), ("index", "Ids", 1),
                          ("updates", "Updates", 1)], [], ["Out"], False),
    "sequence_slice": ("sequence_slice",
                       [("input", "X", 1), ("offset", "Offset", 1),
                        ("length", "Length", 1)], [], ["Out"], False),
    # -- the rows of the ops of ops/vision3d.py and of dygraph.nn's
    # classes (paddle_tpu/layers/auto.py:197-288)
    "conv3d": ("conv3d", [("input", "Input", 1), ("filter", "Filter", 1),
                          ("bias", "Bias", 0)],
               [("strides", [1, 1, 1]), ("paddings", [0, 0, 0]),
                ("dilations", [1, 1, 1]), ("groups", 1)],
               ["Output"], False),
    "conv3d_transpose": ("conv3d_transpose",
                         [("input", "Input", 1), ("filter", "Filter", 1),
                          ("bias", "Bias", 0)],
                         [("strides", [1, 1, 1]), ("paddings", [0, 0, 0]),
                          ("dilations", [1, 1, 1])], ["Output"], False),
    "pool3d": ("pool3d", [("input", "X", 1)],
               [("pooling_type", "max"), ("ksize", [2, 2, 2]),
                ("strides", [2, 2, 2]), ("paddings", [0, 0, 0]),
                ("global_pooling", False), ("exclusive", True)],
               ["Out"], False),
    "adaptive_pool3d": ("pool3d", [("input", "X", 1)],
                        [("pooling_type", "max"), ("ksize", [1, 1, 1]),
                         ("adaptive", True)], ["Out"], False),
    "resize_trilinear": ("trilinear_interp", [("input", "X", 1)],
                         [("out_d", 0), ("out_h", 0), ("out_w", 0),
                          ("align_corners", True)], ["Out"], False),
    "spectral_norm": ("spectral_norm",
                      [("weight", "Weight", 1), ("u", "U", 1),
                       ("v", "V", 1)],
                      [("dim", 0), ("power_iters", 1), ("eps", 1e-12)],
                      ["Out"], False),
    "bilinear_tensor_product": ("bilinear_tensor_product",
                                [("x", "X", 1), ("y", "Y", 1),
                                 ("weight", "Weight", 1),
                                 ("bias", "Bias", 0)], [], ["Out"], False),
    "nce": ("nce", [("input", "Input", 1), ("label", "Label", 1),
                    ("weight", "Weight", 1), ("bias", "Bias", 0)],
            [("num_total_classes", 2), ("num_neg_samples", 10)],
            ["Cost", "SampleLogits", "SampleLabels"], False),
    # -- the rows of the detection ops of ops/detection.py and
    # ops/detection2.py (paddle_tpu/layers/auto.py:154-158, 245-280,
    # 333-464)
    "sigmoid_focal_loss": ("sigmoid_focal_loss",
                           [("x", "X", 1), ("label", "Label", 1),
                            ("fg_num", "FgNum", 1)],
                           [("gamma", 2.0), ("alpha", 0.25)],
                           ["Out"], False),
    "deformable_conv": ("deformable_conv",
                        [("input", "Input", 1), ("offset", "Offset", 1),
                         ("mask", "Mask", 0), ("filter", "Filter", 1)],
                        [("strides", [1, 1]), ("paddings", [0, 0]),
                         ("dilations", [1, 1]), ("groups", 1),
                         ("deformable_groups", 1)], ["Output"], False),
    "deformable_roi_pooling": ("deformable_psroi_pooling",
                               [("input", "Input", 1), ("rois", "ROIs", 1),
                                ("trans", "Trans", 0)],
                               [("spatial_scale", 1.0), ("output_dim", 1),
                                ("pooled_height", 1), ("pooled_width", 1),
                                ("trans_std", 0.1)],
                               ["Output", "TopCount"], False),
    "psroi_pool": ("psroi_pool", [("input", "X", 1), ("rois", "ROIs", 1)],
                   [("output_channels", 1), ("spatial_scale", 1.0),
                    ("pooled_height", 1), ("pooled_width", 1)],
                   ["Out"], False),
    "prroi_pool": ("prroi_pool", [("input", "X", 1), ("rois", "ROIs", 1)],
                   [("spatial_scale", 1.0), ("pooled_height", 1),
                    ("pooled_width", 1)], ["Out"], False),
    "roi_align": ("roi_align", [("input", "X", 1), ("rois", "ROIs", 1),
                                ("rois_num", "RoisNum", 0)],
                  [("pooled_height", 1), ("pooled_width", 1),
                   ("spatial_scale", 1.0), ("sampling_ratio", -1)],
                  ["Out"], False),
    "roi_pool": ("roi_pool", [("input", "X", 1), ("rois", "ROIs", 1),
                              ("rois_num", "RoisNum", 0)],
                 [("pooled_height", 1), ("pooled_width", 1),
                  ("spatial_scale", 1.0)], ["Out", "Argmax"], False),
    "roi_perspective_transform": ("roi_perspective_transform",
                                  [("input", "X", 1), ("rois", "ROIs", 1)],
                                  [("transformed_height", 1),
                                   ("transformed_width", 1),
                                   ("spatial_scale", 1.0)],
                                  ["Out", "Mask", "TransformMatrix",
                                   "Out2InIdx", "Out2InWeights"], True),
    "anchor_generator": ("anchor_generator", [("input", "Input", 1)],
                         [("anchor_sizes", [64.0]),
                          ("aspect_ratios", [1.0]),
                          ("stride", [16.0, 16.0]),
                          ("variances", [0.1, 0.1, 0.2, 0.2])],
                         ["Anchors", "Variances"], True),
    "bipartite_match": ("bipartite_match", [("dist_matrix", "DistMat", 1)],
                        [],
                        ["ColToRowMatchIndices", "ColToRowMatchDist"], True),
    "box_clip": ("box_clip", [("input", "Input", 1),
                              ("im_info", "ImInfo", 1)], [],
                 ["Output"], False),
    "box_decoder_and_assign": ("box_decoder_and_assign",
                               [("prior_box", "PriorBox", 1),
                                ("prior_box_var", "PriorBoxVar", 1),
                                ("target_box", "TargetBox", 1),
                                ("box_score", "BoxScore", 1)],
                               [("box_clip", 0.0)],
                               ["DecodeBox", "OutputAssignBox"], True),
    "density_prior_box": ("density_prior_box",
                          [("input", "Input", 1), ("image", "Image", 1)],
                          [("densities", [1]), ("fixed_sizes", [4.0]),
                           ("fixed_ratios", [1.0]),
                           ("variances", [0.1, 0.1, 0.2, 0.2])],
                          ["Boxes", "Variances"], True),
    "multiclass_nms": ("multiclass_nms", [("bboxes", "BBoxes", 1),
                                          ("scores", "Scores", 1)],
                       [("background_label", 0),
                        ("score_threshold", 0.01), ("nms_top_k", 100),
                        ("nms_threshold", 0.45), ("keep_top_k", 100)],
                       ["Out", "NmsRoisNum"], True),
    "locality_aware_nms": ("locality_aware_nms",
                           [("bboxes", "BBoxes", 1),
                            ("scores", "Scores", 1)],
                           [("background_label", -1),
                            ("score_threshold", 0.01), ("nms_top_k", 100),
                            ("nms_threshold", 0.45), ("keep_top_k", 100)],
                           ["Out"], True),
    "yolo_box": ("yolo_box", [("x", "X", 1), ("img_size", "ImgSize", 1)],
                 [("anchors", []), ("class_num", 1),
                  ("conf_thresh", 0.01), ("downsample_ratio", 32)],
                 ["Boxes", "Scores"], True),
    "yolov3_loss": ("yolov3_loss",
                    [("x", "X", 1), ("gt_box", "GTBox", 1),
                     ("gt_label", "GTLabel", 1), ("gt_score", "GTScore", 0)],
                    [("anchors", []), ("anchor_mask", []),
                     ("class_num", 1), ("ignore_thresh", 0.7),
                     ("downsample_ratio", 32)],
                    ["Loss", "ObjectnessMask", "GTMatchMask"], False),
    "target_assign": ("target_assign",
                      [("input", "X", 1),
                       ("matched_indices", "MatchIndices", 1),
                       ("negative_indices", "NegIndices", 0)],
                      [("mismatch_value", 0)],
                      ["Out", "OutWeight"], True),
    "rpn_target_assign": ("rpn_target_assign",
                          [("anchor_box", "Anchor", 1),
                           ("gt_boxes", "GtBoxes", 1),
                           ("is_crowd", "IsCrowd", 0),
                           ("im_info", "ImInfo", 0)],
                          [("rpn_batch_size_per_im", 256),
                           ("rpn_positive_overlap", 0.7),
                           ("rpn_negative_overlap", 0.3)],
                          ["LocationIndex", "ScoreIndex", "TargetBBox",
                           "TargetLabel", "BBoxInsideWeight"], True),
    "retinanet_target_assign": ("retinanet_target_assign",
                                [("anchor", "Anchor", 1),
                                 ("gt_boxes", "GtBoxes", 1),
                                 ("gt_labels", "GtLabels", 1),
                                 ("is_crowd", "IsCrowd", 0),
                                 ("im_info", "ImInfo", 0)],
                                [("positive_overlap", 0.5),
                                 ("negative_overlap", 0.4)],
                                ["LocationIndex", "ScoreIndex",
                                 "TargetLabel", "TargetBBox",
                                 "BBoxInsideWeight", "ForegroundNumber"],
                                True),
    "retinanet_detection_output": ("retinanet_detection_output",
                                   [("bboxes", "BBoxes", 1),
                                    ("scores", "Scores", 1),
                                    ("anchors", "Anchors", 1),
                                    ("im_info", "ImInfo", 1)],
                                   [("score_threshold", 0.05),
                                    ("nms_top_k", 1000),
                                    ("nms_threshold", 0.3),
                                    ("keep_top_k", 100)], ["Out"], True),
    "generate_proposals": ("generate_proposals",
                           [("scores", "Scores", 1),
                            ("bbox_deltas", "BboxDeltas", 1),
                            ("im_info", "ImInfo", 1),
                            ("anchors", "Anchors", 1),
                            ("variances", "Variances", 1)],
                           [("pre_nms_topN", 6000), ("post_nms_topN", 1000),
                            ("nms_thresh", 0.5), ("min_size", 0.1)],
                           ["RpnRois", "RpnRoiProbs"], True),
    "generate_proposal_labels": ("generate_proposal_labels",
                                 [("rpn_rois", "RpnRois", 1),
                                  ("gt_classes", "GtClasses", 1),
                                  ("is_crowd", "IsCrowd", 0),
                                  ("gt_boxes", "GtBoxes", 1),
                                  ("im_info", "ImInfo", 0)],
                                 [("batch_size_per_im", 256),
                                  ("fg_fraction", 0.25), ("fg_thresh", 0.5),
                                  ("bg_thresh_hi", 0.5),
                                  ("bg_thresh_lo", 0.0)],
                                 ["Rois", "LabelsInt32", "BboxTargets",
                                  "BboxInsideWeights",
                                  "BboxOutsideWeights"], True),
    "generate_mask_labels": ("generate_mask_labels",
                             [("im_info", "ImInfo", 0),
                              ("gt_classes", "GtClasses", 1),
                              ("is_crowd", "IsCrowd", 0),
                              ("gt_segms", "GtSegms", 1),
                              ("rois", "Rois", 1),
                              ("labels_int32", "LabelsInt32", 1)],
                             [("num_classes", 81), ("resolution", 14)],
                             ["MaskRois", "RoiHasMaskInt32", "MaskInt32"],
                             True),
    "collect_fpn_proposals": ("collect_fpn_proposals",
                              [("multi_rois", "MultiLevelRois", 1),
                               ("multi_scores", "MultiLevelScores", 1)],
                              [("post_nms_top_n", 100)],
                              ["FpnRois"], True),
    "distribute_fpn_proposals": ("distribute_fpn_proposals",
                                 [("fpn_rois", "FpnRois", 1)],
                                 [("min_level", 2), ("max_level", 5),
                                  ("refer_level", 4), ("refer_scale", 224)],
                                 ["MultiFpnRois", "RestoreIndex"], True),
    "polygon_box_transform": ("polygon_box_transform",
                              [("input", "Input", 1)], [],
                              ["Output"], True),
    # the rest of the JAX package's rows (activations, image, tensor,
    # random, loss and CTR layers)
    "brelu": ("brelu",
              [("x", "X", 1)],
              [("t_min", 0.0), ("t_max", 24.0)],
              ["Out"],
              False),
    "selu": ("selu",
             [("x", "X", 1)],
             [("scale", 1.0507009873554805), ("alpha", 1.6732632423543772)],
             ["Out"],
             False),
    "size": ("size", [("input", "Input", 1)], [], ["Out"], True),
    "reverse": ("reverse", [("x", "X", 1)], [("axis", 0)], ["Out"], False),
    "lrn": ("lrn",
            [("input", "X", 1)],
            [("n", 5), ("k", 1.0), ("alpha", 0.0001), ("beta", 0.75)],
            ["Out"],
            False),
    "label_smooth": ("label_smooth",
                     [("label", "X", 1), ("prior_dist", "PriorDist", 0)],
                     [("epsilon", 0.1)],
                     ["Out"],
                     False),
    "pixel_shuffle": ("pixel_shuffle",
                      [("x", "X", 1)],
                      [("upscale_factor", 1)],
                      ["Out"],
                      False),
    "space_to_depth": ("space_to_depth",
                       [("x", "X", 1)],
                       [("blocksize", 2)],
                       ["Out"],
                       False),
    "temporal_shift": ("temporal_shift",
                       [("x", "X", 1)],
                       [("seg_num", 1), ("shift_ratio", 0.25)],
                       ["Out"],
                       False),
    "unfold": ("unfold",
               [("x", "X", 1)],
               [("kernel_sizes", [3, 3]),
                ("strides", [1, 1]),
                ("paddings", [0, 0]),
                ("dilations", [1, 1])],
               ["Y"],
               False),
    "diag": ("diag", [("diagonal", "Diagonal", 1)], [], ["Out"], False),
    "is_empty": ("is_empty", [("x", "X", 1)], [], ["Out"], True),
    "isfinite": ("isfinite", [("x", "X", 1)], [], ["Out"], True),
    "has_inf": ("has_inf", [("x", "X", 1)], [], ["Out"], True),
    "has_nan": ("has_nan", [("x", "X", 1)], [], ["Out"], True),
    "multiplex": ("multiplex",
                  [("inputs", "X", 1), ("index", "Ids", 1)],
                  [],
                  ["Out"],
                  False),
    "scatter_nd_add": ("scatter_nd_add",
                       [("ref", "X", 1),
                        ("index", "Index", 1),
                        ("updates", "Updates", 1)],
                       [],
                       ["Out"],
                       False),
    "unique": ("unique", [("x", "X", 1)], [], ["Out", "Index"], True),
    "unique_with_counts": ("unique_with_counts",
                           [("x", "X", 1)],
                           [],
                           ["Out", "Index", "Count"],
                           True),
    "sampling_id": ("sampling_id",
                    [("x", "X", 1)],
                    [("min", 0.0), ("max", 1.0), ("seed", 0)],
                    ["Out"],
                    True),
    "random_crop": ("random_crop",
                    [("x", "X", 1)],
                    [("shape", []), ("seed", 0)],
                    ["Out"],
                    False),
    "crop_tensor": ("crop_tensor",
                    [("x", "X", 1)],
                    [("shape", []), ("offsets", None)],
                    ["Out"],
                    False),
    "uniform_random_batch_size_like": ("uniform_random_batch_size_like",
                                       [("input", "Input", 1)],
                                       [("shape", []),
                                        ("min", -1.0),
                                        ("max", 1.0),
                                        ("seed", 0),
                                        ("input_dim_idx", 0),
                                        ("output_dim_idx", 0)],
                                       ["Out"],
                                       True),
    "gaussian_random_batch_size_like": ("gaussian_random_batch_size_like",
                                        [("input", "Input", 1)],
                                        [("shape", []),
                                         ("mean", 0.0),
                                         ("std", 1.0),
                                         ("seed", 0),
                                         ("input_dim_idx", 0),
                                         ("output_dim_idx", 0)],
                                        ["Out"],
                                        True),
    "add_position_encoding": ("add_position_encoding",
                              [("input", "X", 1)],
                              [("alpha", 1.0), ("beta", 1.0)],
                              ["Out"],
                              False),
    "pad_constant_like": ("pad_constant_like",
                          [("x", "X", 1), ("y", "Y", 1)],
                          [("pad_value", 0.0)],
                          ["Out"],
                          False),
    "cos_sim": ("cos_sim", [("X", "X", 1), ("Y", "Y", 1)], [], ["Out"], False),
    "rank_loss": ("rank_loss",
                  [("label", "Label", 1),
                   ("left", "Left", 1),
                   ("right", "Right", 1)],
                  [],
                  ["Out"],
                  False),
    "margin_rank_loss": ("margin_rank_loss",
                         [("label", "Label", 1),
                          ("left", "X1", 1),
                          ("right", "X2", 1)],
                         [("margin", 0.1)],
                         ["Out"],
                         False),
    "bpr_loss": ("bpr_loss",
                 [("input", "X", 1), ("label", "Label", 1)],
                 [],
                 ["Out"],
                 False),
    "center_loss": ("center_loss",
                    [("input", "X", 1),
                     ("label", "Label", 1),
                     ("centers", "Centers", 1),
                     ("update_center", "CenterUpdateRate", 0)],
                    [("cluster_num", 2), ("alpha", 0.1)],
                    ["Loss"],
                    False),
    "teacher_student_sigmoid_loss": ("teacher_student_sigmoid_loss",
                                     [("input", "X", 1),
                                      ("label", "Label", 1)],
                                     [("soft_max_up_bound", 15.0),
                                      ("soft_max_lower_bound", -15.0)],
                                     ["Y"],
                                     False),
    "mean_iou": ("mean_iou",
                 [("input", "Predictions", 1), ("label", "Labels", 1)],
                 [("num_classes", 2)],
                 ["OutMeanIou", "OutWrong", "OutCorrect"],
                 True),
    "npair_loss": ("npair_loss",
                   [("anchor", "Anchor", 1),
                    ("positive", "Positive", 1),
                    ("labels", "Labels", 1)],
                   [("l2_reg", 0.002)],
                   ["Out"],
                   False),
    "fsp_matrix": ("fsp", [("x", "X", 1), ("y", "Y", 1)], [], ["Out"], False),
    "grid_sampler": ("grid_sampler",
                     [("x", "X", 1), ("grid", "Grid", 1)],
                     [],
                     ["Output"],
                     False),
    "affine_grid": ("affine_grid",
                    [("theta", "Theta", 1)],
                    [("output_shape", [])],
                    ["Output"],
                    False),
    "affine_channel": ("affine_channel",
                       [("x", "X", 1),
                        ("scale", "Scale", 1),
                        ("bias", "Bias", 1)],
                       [("data_layout", "NCHW")],
                       ["Out"],
                       False),
    "data_norm": ("data_norm",
                  [("input", "X", 1),
                   ("batch_size", "BatchSize", 0),
                   ("batch_sum", "BatchSum", 0),
                   ("batch_square_sum", "BatchSquareSum", 0)],
                  [("epsilon", 0.0001)],
                  ["Y"],
                  False),
    "hash": ("hash",
             [("input", "X", 1)],
             [("num_hash", 1), ("mod_by", 65536)],
             ["Out"],
             True),
    "hsigmoid": ("hierarchical_sigmoid",
                 [("input", "X", 1),
                  ("label", "Label", 1),
                  ("weight", "W", 1),
                  ("bias", "Bias", 0)],
                 [("num_classes", 2)],
                 ["Out", "PreOut"],
                 False),
    "similarity_focus": ("similarity_focus",
                         [("input", "X", 1)],
                         [("axis", 1), ("indexes", [0])],
                         ["Out"],
                         True),
    "filter_by_instag": ("filter_by_instag",
                         [("ins", "Ins", 1),
                          ("ins_tag", "Ins_tag", 1),
                          ("filter_tag", "Filter_tag", 1)],
                         [("is_lod", True)],
                         ["Out", "LossWeight", "IndexMap"],
                         False),
    "continuous_value_model": ("cvm",
                               [("input", "X", 1), ("cvm", "CVM", 1)],
                               [("use_cvm", True)],
                               ["Y"],
                               False),
}


def _generate():
    import sys

    mod = sys.modules[__name__]
    for name, (op_type, inputs, attrs, outs, stop_grad) in _SPECS.items():
        args = [a for a, _, _ in inputs]
        kw = [f"{a}={d!r}" for a, d in attrs]
        req = [a for a, _, r in inputs if r]
        opt = [a for a, _, r in inputs if not r]
        sig = ", ".join(req + [f"{a}=None" for a in opt] + kw
                        + ["name=None"])
        slot_map = {a: s for a, s, _ in inputs}
        attr_names = [a for a, _ in attrs]
        body = (
            f"def {name}({sig}):\n"
            f"    _im = {{}}\n"
        )
        for a in args:
            body += f"    _im[{slot_map[a]!r}] = {a}\n"
        body += f"    _attrs = {{}}\n"
        for a in attr_names:
            body += (f"    if {a} is not None:\n"
                     f"        _attrs[{a!r}] = {a}\n")
        body += (f"    return _emit({op_type!r}, _im, _attrs, "
                 f"{outs!r}, {stop_grad!r})\n")
        ns = {"_emit": _emit}
        exec(body, ns)
        fn = ns[name]
        fn.__module__ = __name__
        fn.__doc__ = (f"Layer wrapper over the `{op_type}` op "
                      f"(generated; see ops/ for the lowering and the "
                      f"reference layers/*.py for semantics).")
        setattr(mod, name, fn)
        __all__.append(name)


_generate()
