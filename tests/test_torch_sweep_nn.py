"""The twin of tests/test_op_sweep.py for the ops of ``ops/nn.py`` this
slice ports (the sweep rows through both packages and through the JAX
sweep's ``_run_spec`` on the port, as in ``test_torch_sweep_tensor``),
and cases at other attrs: every interpolation convention (align_corners,
both align_modes, a scale, out equal to in), a grid reaching outside
the image, the loss reductions, a custom tree for
``hierarchical_sigmoid``, max ties under ``maxout`` / ``spp`` /
``pool_with_index`` (JAX splits a tie's gradient), with their gradients.
Forward outputs within rtol 1e-5 / atol 1e-6, gradients within rtol
1e-4 / atol 1e-5 (``test_torch_rnn.check_split``), integer outputs
exactly.

``sync_batch_norm`` in a world is ``tests/test_torch_sync_bn.py``.
"""

import numpy as np
import pytest

from test_torch_activations import both
from test_torch_rnn import check_split, f32
from test_torch_sweep_tensor import outs_of, sweep_check, sweep_rows


@pytest.mark.parametrize("name", sweep_rows("nn"))
def test_sweep_rows(name, monkeypatch):
    sweep_check(name, monkeypatch)


def pos(*shape, seed=0):
    return (np.abs(f32(*shape, seed=seed)) + 0.1).astype(np.float32)


def probs(n, c, seed=0):
    e = np.exp(f32(n, c, seed=seed))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


X4 = f32(2, 3, 5, 7, seed=1)
INTERP = [
    ("bilinear_interp", {"out_h": 9, "out_w": 12}),
    ("bilinear_interp", {"out_h": 9, "out_w": 12, "align_corners": False,
                         "align_mode": 0}),
    ("bilinear_interp", {"out_h": 3, "out_w": 12, "align_corners": False,
                         "align_mode": 1}),
    ("bilinear_interp", {"scale": 1.5}),
    ("bilinear_interp", {"out_h": 5, "out_w": 7}),
    ("nearest_interp", {"out_h": 11, "out_w": 4}),
    ("nearest_interp", {"out_h": 11, "out_w": 14, "align_corners": False}),
    ("nearest_interp", {"scale": 2.0}),
    ("interp_nearest", {"out_h": 3, "out_w": 3, "align_corners": False}),
]

CASES = {f"{op}_{i}": (op, {"X": X4}, attrs, ["X"])
         for i, (op, attrs) in enumerate(INTERP)}
CASES.update({
    "grid_sampler_outside": ("grid_sampler",
                             {"X": f32(2, 3, 4, 6, seed=2),
                              "Grid": (np.random.RandomState(3).rand(
                                  2, 5, 3, 2) * 2.6 - 1.3).astype(
                                  np.float32)}, {}, ["X"]),
    "affine_grid_wide": ("affine_grid", {"Theta": f32(3, 2, 3, seed=4)},
                         {"output_shape": [3, 1, 5, 7]}, ["Theta"]),
    "cross_entropy_soft": ("cross_entropy", {"X": probs(4, 5, seed=5),
                                             "Label": probs(4, 5, seed=6)},
                           {"soft_label": True}, ["X"]),
    "cross_entropy_hard": ("cross_entropy",
                           {"X": probs(4, 5, seed=7),
                            "Label": np.array([[0], [4], [2], [2]],
                                              np.int64)}, {}, ["X"]),
    "instance_norm_affine": ("instance_norm",
                             {"X": f32(2, 3, 4, 5, seed=8),
                              "Scale": f32(3, seed=9),
                              "Bias": f32(3, seed=10)},
                             {"epsilon": 1e-5}, ["X", "Scale", "Bias"]),
    "kldiv_none": ("kldiv_loss", {"X": f32(3, 4, seed=11),
                                  "Target": probs(3, 4, seed=12)},
                   {"reduction": "none"}, ["X"]),
    "kldiv_batchmean": ("kldiv_loss", {"X": f32(3, 4, seed=13),
                                       "Target": probs(3, 4, seed=14)},
                        {"reduction": "batchmean"}, ["X"]),
    "smooth_l1_weights": ("smooth_l1_loss",
                          {"X": f32(4, 3, seed=15), "Y": f32(4, 3, seed=16),
                           "InsideWeight": pos(4, 3, seed=17),
                           "OutsideWeight": pos(4, 3, seed=18)},
                          {"sigma": 2.0}, ["X"]),
    "huber_delta": ("huber_loss", {"X": f32(5, 1, seed=19),
                                   "Y": f32(5, 1, seed=20)},
                    {"delta": 0.5}, ["X"]),
    "label_smooth_prior": ("label_smooth",
                           {"X": probs(3, 4, seed=21),
                            "PriorDist": probs(1, 4, seed=22)},
                           {"epsilon": 0.2}, ["X"]),
    "hsigmoid_custom_tree": ("hierarchical_sigmoid",
                             {"X": f32(3, 5, seed=23), "W": f32(6, 5, seed=24),
                              "Label": np.array([[1], [0], [3]], np.int64),
                              "PathTable": np.array([[0, 2, -1], [0, 1, 3],
                                                     [0, 2, 5]], np.int64),
                              "PathCode": np.array([[1, 0, 0], [0, 1, 1],
                                                    [1, 1, 0]], np.int64)},
                             {"num_classes": 4}, ["X", "W"]),
    "hsigmoid_wide": ("hierarchical_sigmoid",
                      {"X": f32(6, 4, seed=25), "W": f32(12, 4, seed=26),
                       "Label": np.array([[0], [12], [5], [7], [3], [11]],
                                         np.int64),
                       "Bias": f32(12, seed=27)},
                      {"num_classes": 13}, ["X", "W", "Bias"]),
    # equal maxima: JAX's max splits the gradient among them
    "maxout_ties": ("maxout", {"X": np.repeat(f32(1, 2, 2, 2, seed=28), 2,
                                              axis=1)},
                    {"groups": 2}, ["X"]),
    "spp_avg": ("spp", {"X": f32(2, 2, 5, 6, seed=29)},
                {"pyramid_height": 3, "pooling_type": "avg"}, ["X"]),
    "spp_max_ties": ("spp", {"X": np.ones((1, 2, 4, 4), np.float32)},
                     {"pyramid_height": 2}, ["X"]),
    "pool_with_index_stride": ("pool_with_index",
                               {"X": f32(2, 3, 7, 6, seed=30)},
                               {"ksize": [3, 2], "strides": [2, 2]}, ["X"]),
    "lrn_alexnet": ("lrn", {"X": f32(2, 7, 3, 3, seed=31)},
                    {"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75}, ["X"]),
    "unfold_strided": ("unfold", {"X": f32(2, 3, 6, 7, seed=32)},
                       {"kernel_sizes": [3, 2], "strides": [2, 1],
                        "paddings": [1, 0, 1, 1], "dilations": [1, 2]},
                       ["X"]),
    "temporal_shift_half": ("temporal_shift", {"X": f32(6, 4, 2, 2, seed=33)},
                            {"seg_num": 3, "shift_ratio": 0.5}, ["X"]),
    "data_norm_grad": ("data_norm",
                       {"X": f32(4, 3, seed=34),
                        "BatchSize": np.full(3, 10.0, np.float32),
                        "BatchSum": f32(3, seed=35),
                        "BatchSquareSum": pos(3, seed=36) * 20}, {}, ["X"]),
    "add_position_encoding": ("add_position_encoding",
                              {"X": f32(2, 5, 8, seed=37)},
                              {"alpha": 0.5, "beta": 2.0}, ["X"]),
    "conv_shift_grad": ("conv_shift", {"X": f32(2, 7, seed=38),
                                       "Y": f32(2, 3, seed=39)}, {},
                        ["X", "Y"]),
    "l2_normalize_axis0": ("l2_normalize", {"X": f32(3, 4, seed=40)},
                           {"axis": 0}, ["X"]),
    "selu_grad": ("selu", {"X": f32(3, 4, seed=41)}, {}, ["X"]),
    "log_loss_grad": ("log_loss", {"Predicted": probs(4, 1, seed=42) * 0.9,
                                   "Labels": np.array([[1], [0], [1], [0]],
                                                      np.float32)},
                      {"epsilon": 1e-4}, ["Predicted"]),
    "pixel_shuffle_grad": ("pixel_shuffle", {"X": f32(2, 9, 2, 3, seed=43)},
                           {"upscale_factor": 3}, ["X"]),
    "space_to_depth_grad": ("space_to_depth", {"X": f32(1, 3, 6, 4, seed=44)},
                            {"blocksize": 2}, ["X"]),
    "fsp_grad": ("fsp", {"X": f32(2, 3, 4, 4, seed=45),
                         "Y": f32(2, 2, 4, 4, seed=46)}, {}, ["X", "Y"]),
    "affine_channel_grad": ("affine_channel",
                            {"X": f32(2, 3, 2, 2, seed=47),
                             "Scale": f32(3, seed=48),
                             "Bias": f32(3, seed=49)}, {},
                            ["X", "Scale", "Bias"]),
})


@pytest.mark.parametrize("name", sorted(CASES))
def test_cases(name):
    op_type, inputs, attrs, grads = CASES[name]
    j, t = both(op_type, inputs, attrs, outs_of(op_type), grads=grads)
    check_split(j, t)


def test_nearest_indices_are_jax_float32_ones():
    """The source rows and columns of every nearest-interp output in
    both conventions are JAX's exactly (X holds its own flat index)."""
    x = np.arange(1 * 1 * 13 * 17, dtype=np.float32).reshape(1, 1, 13, 17)
    for attrs in ({"out_h": 29, "out_w": 5}, {"out_h": 7, "out_w": 40,
                                              "align_corners": False}):
        j, t = both("nearest_interp", {"X": x}, attrs, outs_of(
            "nearest_interp"))
        np.testing.assert_array_equal(t["o_Out_0"], j["o_Out_0"])
