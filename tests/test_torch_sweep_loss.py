"""The twin of tests/test_op_sweep.py for the losses of ``ops/loss_ext.py``
and the metrics of ``ops/metrics.py`` this slice ports: the sweep rows
through both packages and through the JAX sweep's ``_run_spec`` on the
port (``test_torch_sweep_tensor.sweep_check``), cases at other attrs with
their gradients (``check_split``: forward rtol 1e-5 / atol 1e-6,
gradients 1e-4 / 1e-5), and the stateful ops over three successive
calls, each call fed the state the previous one returned (``auc``'s
histograms, ``precision_recall``'s states, ``mean_iou``'s counts,
``center_loss``' centres, ``average_accumulates``' sums and counters),
held to JAX call by call.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from test_torch_activations import both, check, run_op
from test_torch_rnn import check_split, f32
from test_torch_sweep_tensor import outs_of, sweep_check, sweep_rows


@pytest.mark.parametrize("name", sweep_rows("loss_ext") + sweep_rows(
    "metrics"))
def test_sweep_rows(name, monkeypatch):
    sweep_check(name, monkeypatch)


def labels01(*shape, seed=0):
    return np.random.RandomState(seed).randint(0, 2, shape).astype(
        np.float32)


CASES = {
    "hinge_loss": ("hinge_loss", {"Logits": f32(6, 1, seed=1),
                                  "Labels": labels01(6, 1, seed=2)}, {},
                   ["Logits"]),
    "rank_loss": ("rank_loss", {"Label": labels01(5, 1, seed=3),
                                "Left": f32(5, 1, seed=4),
                                "Right": f32(5, 1, seed=5)}, {},
                  ["Left", "Right"]),
    "margin_rank_loss": ("margin_rank_loss",
                         {"Label": np.sign(f32(5, 1, seed=6)),
                          "X1": f32(5, 1, seed=7), "X2": f32(5, 1, seed=8)},
                         {"margin": 0.3}, ["X1", "X2"]),
    "bpr_loss": ("bpr_loss", {"X": f32(4, 6, seed=9),
                              "Label": np.array([[0], [5], [2], [2]],
                                                np.int64)}, {}, ["X"]),
    "modified_huber": ("modified_huber_loss",
                       {"X": f32(8, 1, seed=10) * 2,
                        "Y": labels01(8, 1, seed=11)}, {}, ["X"]),
    "teacher_student": ("teacher_student_sigmoid_loss",
                        {"X": f32(8, 1, seed=12) * 3,
                         "Label": np.array([[-2], [-1], [0], [0.3], [1],
                                            [1.7], [-1.5], [2]],
                                           np.float32)}, {}, ["X"]),
    "cos_sim": ("cos_sim", {"X": f32(4, 5, seed=13), "Y": f32(4, 5, seed=14)},
                {}, ["X", "Y"]),
    "center_loss_grad": ("center_loss",
                         {"X": f32(5, 4, seed=15),
                          "Label": np.array([[0], [2], [0], [1], [2]],
                                            np.int64),
                          "Centers": f32(3, 4, seed=16),
                          "CenterUpdateRate": np.full(1, 0.2, np.float32)},
                         {"need_update": True}, ["X"]),
    "cvm_off": ("cvm", {"X": np.abs(f32(4, 5, seed=17)),
                        "CVM": np.abs(f32(4, 2, seed=18))},
                {"use_cvm": False}, ["X"]),
    "cvm_grad": ("cvm", {"X": np.abs(f32(4, 5, seed=19)),
                         "CVM": np.abs(f32(4, 2, seed=20))}, {}, ["X"]),
    # pairs tied in score are neutral
    "pn_pair_ties": ("positive_negative_pair",
                     {"Score": np.array([[0.5], [0.5], [0.2], [0.9], [0.2],
                                         [0.7]], np.float32),
                      "Label": np.array([[1], [0], [2], [0], [1], [1]],
                                        np.float32),
                      "QueryID": np.array([[0], [0], [0], [1], [1], [1]],
                                          np.int64)}, {}, []),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cases(name):
    op_type, inputs, attrs, grads = CASES[name]
    j, t = both(op_type, inputs, attrs, outs_of(op_type), grads=grads)
    check_split(j, t)


# -- the stateful ops, three calls each ----------------------------------------


def _three_calls(op_type, feeds, attrs, carry):
    """Call ``op_type`` three times in both packages, each call fed its
    own package's state outputs (``carry``: output slot -> input slot);
    the calls' outputs compared one by one."""
    state = {"jax": {}, "port": {}}
    for k, feed in enumerate(feeds):
        ins_j = dict(feed, **state["jax"])
        ins_t = dict(feed, **state["port"])
        assert k == 0 or ins_j.keys() == ins_t.keys()
        j = run_op(jfluid, op_type, ins_j, attrs, outs_of(op_type))
        t = run_op(fluid, op_type, ins_t, attrs, outs_of(op_type))
        check(j, t, rtol=1e-5, atol=1e-6)
        for out_slot, in_slot in carry.items():
            state["jax"][in_slot] = np.asarray(j[f"o_{out_slot}_0"])
            state["port"][in_slot] = np.asarray(t[f"o_{out_slot}_0"])
    return state


def test_auc_carries_its_histograms():
    rng = np.random.RandomState(21)
    feeds = [{"Predict": rng.rand(40, 2).astype(np.float32),
              "Label": rng.randint(0, 2, (40, 1)).astype(np.int64)}
             for _ in range(3)]
    feeds[0].update(StatPos=np.zeros((1, 256), np.float32),
                    StatNeg=np.zeros((1, 256), np.float32))
    st = _three_calls("auc", feeds, {"num_thresholds": 255},
                      {"StatPosOut": "StatPos", "StatNegOut": "StatNeg"})
    assert st["port"]["StatPos"].sum() + st["port"]["StatNeg"].sum() == 120


def test_precision_recall_carries_its_states():
    rng = np.random.RandomState(22)
    feeds = [{"MaxProbs": rng.rand(10, 1).astype(np.float32),
              "Indices": rng.randint(0, 4, (10, 1)).astype(np.int64),
              "Labels": rng.randint(0, 4, (10, 1)).astype(np.int64),
              "Weights": np.ones((10, 1), np.float32)} for _ in range(3)]
    feeds[0]["StatesInfo"] = np.zeros((4, 4), np.float32)
    _three_calls("precision_recall", feeds, {"class_number": 4},
                 {"AccumStatesInfo": "StatesInfo"})


def test_mean_iou_carries_its_counts():
    rng = np.random.RandomState(23)
    feeds = [{"Predictions": rng.randint(0, 4, (12,)).astype(np.int32),
              "Labels": rng.randint(0, 4, (12,)).astype(np.int32)}
             for _ in range(3)]
    feeds[0].update(InWrongs=np.zeros(4, np.float32),
                    InCorrects=np.zeros(4, np.float32))
    _three_calls("mean_iou", feeds, {"num_classes": 4},
                 {"OutWrong": "InWrongs", "OutCorrect": "InCorrects"})


def test_center_loss_carries_its_centres():
    rng = np.random.RandomState(24)
    feeds = [{"X": rng.randn(6, 4).astype(np.float32),
              "Label": rng.randint(0, 3, (6, 1)).astype(np.int64),
              "CenterUpdateRate": np.full(1, 0.5, np.float32)}
             for _ in range(3)]
    feeds[0]["Centers"] = rng.randn(3, 4).astype(np.float32)
    _three_calls("center_loss", feeds, {"need_update": True},
                 {"CentersOut": "Centers"})


@pytest.mark.parametrize("attrs", [
    {"average_window": 0.5, "max_average_window": 100,
     "min_average_window": 2},
    {"average_window": 1.0, "max_average_window": 2,
     "min_average_window": 1}])
def test_average_accumulates_carries_its_sums(attrs):
    rng = np.random.RandomState(25)
    feeds = [{"param": rng.randn(5).astype(np.float32)} for _ in range(3)]
    feeds[0].update({
        "in_sum_1": np.zeros(5, np.float32),
        "in_sum_2": np.zeros(5, np.float32),
        "in_sum_3": np.zeros(5, np.float32),
        "in_num_accumulates": np.array([0], np.int64),
        "in_old_num_accumulates": np.array([0], np.int64),
        "in_num_updates": np.array([0], np.int64)})
    carry = {f"out_{s}": f"in_{s}" for s in (
        "sum_1", "sum_2", "sum_3", "num_accumulates", "old_num_accumulates",
        "num_updates")}
    st = _three_calls("average_accumulates", feeds, attrs, carry)
    assert int(st["port"]["in_num_updates"][0]) == 3
