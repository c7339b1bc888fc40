"""The port's sequence, LoD and beam-helper ops and the sequence fusions
against the JAX package, on the CPU.

Each case is a one-op Program in both packages
(``test_torch_activations.both``): forward outputs within rtol 1e-5 /
atol 1e-6, integer outputs exactly, and input gradients (of a weighted
sum of every float output) within rtol 1e-4 / atol 1e-5.

* ``test_op_sweep_rows``: the rows of tests/test_op_sweep.py's
  ``SPECS`` for these families, imported from that file, with the
  row's inputs, attrs and gradient slots.
* ``test_cases``: the ops without a row there, and the paths a row does
  not reach: ``sequence_pool``'s max at ties and past a row's length
  (JAX's reduce-max gradient shares the cotangent among tied
  positions), the other pool types with lengths, the rank-table /
  split / merge family, and the fusions.
* ``test_every_sequence_family_op_has_a_parity_case``: a ratchet. Every
  op that ``ops/rnn.py``, ``ops/sequence.py``, ``ops/lod.py``,
  ``ops/beam.py``, ``ops/loss_ext.py`` or ``ops/fused.py`` registers,
  and the sequence helpers of ``ops/tensor.py`` / ``ops/nn.py`` /
  ``ops/math.py``, must have a case here or in the files named in
  ``ELSEWHERE`` (which must name the op).
"""

import os

import numpy as np
import pytest

from test_op_sweep import SPECS
from test_torch_activations import both
from test_torch_rnn import check_split, f32

import paddle_tpu_torch.ops  # noqa: F401 (registers the lowerings)
from paddle_tpu_torch.core.registry import _OP_REGISTRY, get_op_def

FAMILY_MODULES = {"paddle_tpu_torch.ops." + m for m in
                  ("rnn", "sequence", "lod", "beam", "loss_ext", "fused")}
HELPERS = ["gather_tree", "max_sequence_len", "lod_reset", "ctc_align",
           "im2sequence", "row_conv", "log_softmax"]


def family_ops():
    ops = sorted(n for n, d in _OP_REGISTRY.items()
                 if not d.auto_grad and d.lower.__module__ in FAMILY_MODULES)
    return ops + HELPERS


SWEEP = sorted(n for n in family_ops() if n in SPECS)

# ops held to JAX in the other files of this slice (each file names them)
ELSEWHERE = {
    "test_torch_rnn.py": ["fused_lstm", "fused_gru", "lstm_unit", "gru_unit",
                          "lstm", "lstmp", "gru", "attention_lstm",
                          "cudnn_lstm", "recurrent"],
    "test_torch_seq_losses.py": ["warpctc", "linear_chain_crf",
                                 "crf_decoding", "edit_distance",
                                 "chunk_eval"],
    "test_torch_seq2seq.py": ["beam_search", "beam_search_decode"],
}


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


I32 = lambda *a: np.array(a, np.int32)  # noqa: E731
LEN3 = I32(4, 1, 3)
TIES = np.array([[[1.0, 2.0], [3.0, 2.0], [3.0, -1.0], [0.5, 0.0]],
                 [[4.0, 4.0], [9.0, 9.0], [1.0, 1.0], [2.0, 2.0]],
                 [[0.0, 0.0], [0.0, 0.0], [0.0, 5.0], [7.0, 0.0]]],
                np.float32)

CASES = {
    # sequence_pool: every type with lengths; max at ties and past a
    # row's end (row 1 has length 1: its tied 9s are padding)
    "pool_max_ties": ("sequence_pool", {"X": TIES, "Length": LEN3},
                      {"pooltype": "MAX"}, None, ("X",)),
    "pool_max_dense_ties": ("sequence_pool", {"X": TIES},
                            {"pooltype": "MAX"}, None, ("X",)),
    "pool_sum": ("sequence_pool", {"X": f32(3, 4, 2), "Length": LEN3},
                 {"pooltype": "SUM"}, None, ("X",)),
    "pool_sqrt": ("sequence_pool", {"X": f32(3, 4, 2), "Length": LEN3},
                  {"pooltype": "SQRT"}, None, ("X",)),
    "pool_last": ("sequence_pool", {"X": f32(3, 4, 2), "Length": LEN3},
                  {"pooltype": "LAST"}, None, ("X",)),
    "pool_first": ("sequence_pool", {"X": f32(3, 4, 2)},
                   {"pooltype": "FIRST"}, None, ("X",)),
    "conv": ("sequence_conv", {"X": f32(3, 4, 2, seed=1),
                               "Filter": f32(6, 5, seed=2), "Length": LEN3},
             {"contextLength": 3, "contextStart": -1}, None,
             ("X", "Filter")),
    "conv_ahead": ("sequence_conv", {"X": f32(2, 5, 3, seed=3),
                                     "Filter": f32(6, 2, seed=4)},
                   {"contextLength": 2, "contextStart": 0}, None,
                   ("X", "Filter")),
    "enumerate": ("sequence_enumerate",
                  {"X": np.arange(12, dtype=np.int32).reshape(3, 4),
                   "Length": LEN3}, {"win_size": 2, "pad_value": -1},
                  None, ()),
    "erase": ("sequence_erase",
              {"X": np.array([[1, 2, 3, 2], [2, 2, 5, 6], [7, 3, 2, 9]],
                             np.int32), "Length": LEN3},
              {"tokens": [2, 9]}, None, ()),
    "expand_as_steps": ("sequence_expand_as",
                        {"X": f32(2, 2, 3), "Y": f32(2, 4, 3)}, {}, None,
                        ("X",)),
    "expand_as_rows": ("sequence_expand_as",
                       {"X": f32(2, 3), "Y": f32(2, 4, 3)}, {}, None,
                       ("X",)),
    "scatter": ("sequence_scatter",
                {"X": f32(3, 6), "Ids": np.array([[0, 2, 2, 5], [1, 1, 0, 0],
                                                  [5, 4, 3, 2]], np.int32),
                 "Updates": f32(3, 4, seed=5), "Length": LEN3}, {}, None,
                ("X", "Updates")),
    "slice": ("sequence_slice", {"X": f32(3, 5, 2),
                                 "Offset": np.array([[1], [0], [2]], np.int64),
                                 "Length": np.array([[3], [2], [1]], np.int64)},
              {}, None, ("X",)),
    "topk_avg": ("sequence_topk_avg_pooling",
                 {"X": np.array([[[1, 3, 3, 2, 0], [5, 5, 5, 1, 1]],
                                 [[2, 1, 4, 4, 9], [0, 0, 1, 0, 2]]],
                                np.float32), "Length": I32(5, 3)},
                 {"topks": [1, 2, 4]}, None, ("X",)),
    # the LoD family (ops/lod.py)
    "write_read_array": ("write_to_array",
                         {"X": f32(2, 3), "I": np.array([1], np.int64),
                          "Array": f32(3, 2, 3, seed=1)}, {}, None,
                         ("X", "Array")),
    "read_array": ("read_from_array", {"X": f32(3, 2, 3),
                                       "I": np.array([2], np.int64)},
                   {}, None, ("X",)),
    "array_length": ("lod_array_length", {"X": f32(4, 2)}, {}, None, ()),
    "rank_table": ("lod_rank_table", {"X": f32(4, 5, 2),
                                      "Length": I32(2, 5, 2, 4)}, {}, None,
                   ()),
    "reorder": ("reorder_lod_tensor_by_rank",
                {"X": f32(4, 3), "RankTable": np.array(
                    [[1, 5], [3, 4], [0, 2], [2, 2]], np.int64)}, {}, None,
                ("X",)),
    "shrink": ("shrink_rnn_memory",
               {"X": f32(4, 3), "RankTable": np.array(
                   [[1, 5], [3, 4], [0, 2], [2, 2]], np.int64),
                "I": np.array([2], np.int64)}, {}, None, ("X",)),
    "split": ("split_lod_tensor", {"X": f32(4, 3),
                                   "Mask": np.array([[1], [0], [0], [1]],
                                                    np.bool_)},
              {}, None, ("X",)),
    "merge": ("merge_lod_tensor", {"X": f32(4, 3), "Mask": np.array(
        [[1], [0], [0], [1]], np.bool_), "InTrue": f32(4, 3, seed=1),
        "InFalse": f32(4, 3, seed=2)}, {}, None, ("InTrue", "InFalse")),
    "merge_infer": ("merge_lod_tensor_infer", {"X": f32(4, 3), "Mask":
                                               np.array([[0], [1], [1], [0]],
                                                        np.bool_),
                                               "InTrue": f32(4, 3, seed=3),
                                               "InFalse": f32(4, 3, seed=4)},
                    {}, None, ("InTrue", "InFalse")),
    "array_to_lod": ("array_to_lod_tensor", {"X": f32(5, 4, 2),
                                             "RankTable": np.array(
                                                 [[1, 5], [3, 4], [0, 2],
                                                  [2, 2]], np.int64)},
                     {}, None, ("X",)),
    "lod_to_array": ("lod_tensor_to_array", {"X": f32(4, 5, 2),
                                             "RankTable": np.array(
                                                 [[1, 5], [3, 4], [0, 2],
                                                  [2, 2]], np.int64)},
                     {}, None, ("X",)),
    "array_to_tensor_stack": ("tensor_array_to_tensor", {"X": f32(3, 2, 4)},
                              {"axis": 1, "use_stack": True}, None, ("X",)),
    "array_to_tensor_concat": ("tensor_array_to_tensor",
                               {"X": f32(3, 2, 4)},
                               {"axis": -1, "use_stack": False}, None,
                               ("X",)),
    "select_input": ("select_input", {"X": [f32(2, 3), f32(2, 3, seed=1)],
                                      "Mask": np.array([1], np.int32)},
                     {}, None, ("X",)),
    "select_output": ("select_output", {"X": f32(2, 3),
                                        "Mask": np.array([0], np.int32)},
                      {}, {"Out": 3}, ("X",)),
    "log_softmax": ("log_softmax", {"X": f32(3, 5)}, {"axis": -1}, None,
                    ("X",)),
    "log_softmax_axis0": ("log_softmax", {"X": f32(3, 5)}, {"axis": 0},
                          None, ("X",)),
    # the sequence fusions (ops/fused.py)
    "fusion_lstm": ("fusion_lstm", {
        "X": f32(3, 4, 2), "WeightX": f32(2, 12, seed=1),
        "WeightH": f32(3, 12, seed=2), "Bias": f32(12, seed=3),
        "H0": f32(3, 3, seed=4), "C0": f32(3, 3, seed=5), "Length": LEN3},
        {"is_reverse": True}, None,
        ("X", "WeightX", "WeightH", "Bias", "H0", "C0")),
    "fusion_gru": ("fusion_gru", {
        "X": f32(3, 4, 2), "WeightX": f32(2, 9, seed=1),
        "WeightH": f32(3, 9, seed=2), "Bias": f32(9, seed=3),
        "Length": LEN3}, {"origin_mode": True}, None,
        ("X", "WeightX", "WeightH", "Bias")),
    "fused_embedding_fc_lstm": ("fused_embedding_fc_lstm", {
        "Ids": np.array([[1, 4, 0], [2, 2, 3]], np.int64),
        "Embeddings": f32(5, 8, seed=1), "WeightH": f32(2, 8, seed=2),
        "Bias": f32(8, seed=3)}, {}, None,
        ("Embeddings", "WeightH", "Bias")),
    "fused_embedding_seq_pool": ("fused_embedding_seq_pool", {
        "W": f32(6, 3), "Ids": np.array([[1, 0, 5], [2, 2, 0]], np.int64)},
        {"padding_idx": 0, "combiner": "sum"}, None, ("W",)),
    "fused_embedding_seq_pool_mean": ("fused_embedding_seq_pool", {
        "W": f32(6, 3), "Ids": np.array([[1, 0, 5], [2, 2, 0]], np.int64)},
        {"combiner": "mean"}, None, ("W",)),
    "fusion_seqexpand_concat_fc": ("fusion_seqexpand_concat_fc", {
        "X": [f32(2, 3, 4), f32(2, 2, seed=1)], "FCWeight": f32(6, 5, seed=2),
        "FCBias": f32(5, seed=3)}, {"fc_activation": "relu"}, None,
        ("X", "FCWeight", "FCBias")),
    "fusion_seqpool_concat": ("fusion_seqpool_concat", {
        "X": [f32(2, 3, 4), f32(2, 3, 2, seed=1)]}, {"pooltype": "MAX"},
        None, ("X",)),
    "fusion_seqpool_concat_sqrt": ("fusion_seqpool_concat", {
        "X": [f32(2, 3, 4), f32(2, 3, 2, seed=1)]}, {"pooltype": "SQRT"},
        None, ("X",)),
    "fusion_seqpool_cvm_concat": ("fusion_seqpool_cvm_concat", {
        "X": [f32(2, 3, 4), f32(2, 3, 5, seed=1)], "CVM": f32(2, 2)},
        {"pooltype": "SUM", "use_cvm": False}, None, ("X",)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cases(case):
    op_type, ins, attrs, n_out, grads = CASES[case]
    j, t = both(op_type, ins, attrs, _outs(op_type, n_out), grads=grads)
    check_split(j, t)


def test_sequence_pool_max_shares_the_gradient_among_ties():
    """JAX's reduce-max gradient, not ``torch.max(dim)``'s one index:
    the two tied 3s of row 0 take half each; a padded position none."""
    j, t = both("sequence_pool", {"X": TIES, "Length": LEN3},
                {"pooltype": "MAX"}, _outs("sequence_pool"), grads=("X",))
    g = t["X_0@GRAD"]
    w = np.asarray(t["o_Out_0"])  # forward: the maxima
    np.testing.assert_array_equal(w[0], [3.0, 2.0])
    assert g[0, 1, 0] == g[0, 2, 0] != 0           # shared
    assert g[0, 0, 1] == g[0, 1, 1] != 0
    np.testing.assert_array_equal(g[1, 1:], 0)     # past length 1
    np.testing.assert_array_equal(g, j["X_0@GRAD"])


def test_every_sequence_family_op_has_a_parity_case():
    covered = set(SWEEP) | {c[0] for c in CASES.values()}
    here = os.path.dirname(os.path.abspath(__file__))
    for fname, names in ELSEWHERE.items():
        text = open(os.path.join(here, fname)).read()
        for n in names:
            assert f'"{n}"' in text, (fname, n)
        covered |= set(names)
    missing = sorted(set(family_ops()) - covered)
    assert not missing, f"registered without a parity case: {missing}"
