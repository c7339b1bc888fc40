"""The twin of tests/test_op_sweep.py for the ops of ``ops/tensor.py`` the
port lowers since the layer surface was completed, and the sweep helpers
the other ``test_torch_sweep_*`` files import.

Each op's sweep row (``SPECS``) is one op in a Program built in both
packages (``test_torch_activations.both``: every float output weighted
by a fed random array, ``append_backward`` for the row's grad slots);
outputs and gradients are held within the row's ``tol`` (rtol and atol,
1e-5 for every row), integer, index and bool outputs exactly. The same
row then goes through the JAX sweep's own ``_run_spec`` with its module's
``fluid`` swapped for ``paddle_tpu_torch``: the execution tier, the
numpy oracle of ``ORACLES`` (where there is one) and the directional
finite-difference gradient check, on the port.

Random ops cannot draw JAX's bits: the sweep's
``test_random_ops_statistics`` runs on the port, and ``random_crop`` is
held to the window its own draws name, with JAX's lowering run on those
draws. ``hash`` is held bit for bit; JAX raises past num_hash 2, a fault
recorded in ROADMAP §C and pinned here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_op_sweep as sweep
from test_op_sweep import SPECS
from test_torch_activations import both, check, run_op

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu.core.registry import LoweringContext as JaxContext
from paddle_tpu.core.registry import get_op_def as jax_op_def
from paddle_tpu_torch.core.registry import LoweringContext, get_op_def

# the 108 lowerings this slice adds, by the JAX module that holds them
NEW_OPS = {
    "tensor": ["reshape", "transpose", "tile", "top_k_v2", "pad2d",
               "shard_index", "size", "diag", "linspace", "eye", "fill",
               "fill_any_like", "reverse", "crop", "crop_tensor",
               "pad_constant_like", "multiplex", "partial_concat",
               "partial_sum", "is_empty", "unique", "unique_with_counts",
               "scatter_nd_add", "shuffle_batch", "random_crop", "seed",
               "hash"],
    "nn": ["cross_entropy", "sync_batch_norm", "instance_norm",
           "l2_normalize", "norm", "squared_l2_norm", "squared_l2_distance",
           "log_loss", "huber_loss", "smooth_l1_loss", "maxout",
           "kldiv_loss", "nearest_interp", "interp_nearest",
           "bilinear_interp", "add_position_encoding", "affine_channel",
           "affine_grid", "grid_sampler", "pixel_shuffle", "space_to_depth",
           "temporal_shift", "unfold", "lrn", "data_norm", "conv_shift",
           "pool_with_index", "spp", "fsp", "minus", "selu", "l1_norm",
           "label_smooth", "hierarchical_sigmoid"],
    "loss_ext": ["hinge_loss", "rank_loss", "margin_rank_loss", "bpr_loss",
                 "modified_huber_loss", "teacher_student_sigmoid_loss",
                 "cos_sim", "center_loss", "mean_iou",
                 "positive_negative_pair", "cvm"],
    "metrics": ["auc", "precision_recall"],
    "math": ["matmul_v2", "isfinite", "isfinite_v2"],
    "random": ["uniform_random_batch_size_like",
               "truncated_gaussian_random", "randint", "shuffle_channel",
               "sampling_id"],
    "misc": ["squeeze", "unsqueeze", "fill_zeros_like2", "cross_entropy2",
             "gaussian_random_batch_size_like", "sample_logits",
             "similarity_focus", "filter_by_instag", "pyramid_hash",
             "match_matrix_tensor", "var_conv_2d", "py_func",
             "py_func_grad", "expand_pred_like", "brelu", "has_inf",
             "has_nan", "npair_loss"],
    "control": ["print", "logical_print_stub"],
    "persist": ["save", "load", "save_combine", "load_combine"],
    "optim": ["adamw", "average_accumulates"],
}

# sweep rows whose ops draw random numbers: held by statistics and by
# their own draws, not against JAX's bits
RANDOM = {"shuffle_batch", "random_crop", "randint",
          "truncated_gaussian_random", "uniform_random_batch_size_like",
          "gaussian_random_batch_size_like", "sampling_id"}


def sweep_rows(module):
    """The ops of ``module`` with a sweep row that is not random."""
    return sorted(n for n in NEW_OPS[module] if n in SPECS and n not in RANDOM)


def outs_of(op_type, n_out=None):
    outs = {s: 1 for s in get_op_def(op_type).output_slots}
    outs.update(n_out or {})
    return outs


def sweep_check(name, monkeypatch):
    """The sweep row of ``name`` through both packages, then JAX's
    ``_run_spec`` (oracle and finite differences) on the port."""
    row = SPECS[name]
    j, t = both(name, row["inputs"], row["attrs"],
                outs_of(name, row["n_out"]), grads=tuple(row["grads"]))
    check(j, t, rtol=row["tol"], atol=row["tol"])
    monkeypatch.setattr(sweep, "fluid", fluid)
    sweep._run_spec(name, row)


@pytest.mark.parametrize("name", sweep_rows("tensor"))
def test_sweep_rows(name, monkeypatch):
    sweep_check(name, monkeypatch)


def f32(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


CASES = {
    # ties under top_k_v2 keep lax.top_k's order, the lower index first
    "top_k_v2_ties": ("top_k_v2", {"X": np.array([[1, 3, 3, 2, 3, 0]],
                                                 np.float32)},
                      {"k": 4}, ["X"]),
    "pad2d_reflect": ("pad2d", {"X": f32(2, 3, 5, 4)},
                      {"paddings": [2, 1, 3, 1], "mode": "reflect"}, ["X"]),
    "pad2d_edge": ("pad2d", {"X": f32(1, 2, 3, 3, seed=1)},
                   {"paddings": [1, 2, 0, 2], "mode": "edge"}, ["X"]),
    "pad2d_constant": ("pad2d", {"X": f32(1, 2, 3, 3, seed=2)},
                       {"paddings": [1, 0, 2, 1], "pad_value": 0.5}, ["X"]),
    "tile_longer": ("tile", {"X": f32(2, 3, seed=3)},
                    {"repeat_times": [2, 1, 3]}, ["X"]),
    # repeated indices add up
    "scatter_nd_add_repeats": ("scatter_nd_add",
                               {"X": f32(4, 3, seed=4),
                                "Index": np.array([[1], [3], [1]], np.int64),
                                "Updates": f32(3, 3, seed=5)}, {},
                               ["X", "Updates"]),
    "scatter_nd_add_2d": ("scatter_nd_add",
                          {"X": f32(3, 4, 2, seed=6),
                           "Index": np.array([[0, 1], [2, 3], [0, 1]],
                                             np.int32),
                           "Updates": f32(3, 2, seed=7)}, {},
                          ["X", "Updates"]),
    # ids without a 0: the padding zeros follow the sorted values
    "unique_padding": ("unique_with_counts",
                       {"X": np.array([7, 3, 9, 3, 7, 7], np.int64)}, {},
                       []),
    "crop_offsets": ("crop", {"X": f32(4, 5, seed=8)},
                     {"shape": [2, 3], "offsets": [1, 2]}, ["X"]),
    "crop_tensor_rest": ("crop_tensor", {"X": f32(4, 5, seed=9)},
                         {"shape": [-1, 2], "offsets": [1, 3]}, ["X"]),
    "partial_sum_neg": ("partial_sum", {"X": [f32(3, 6, seed=10),
                                              f32(3, 6, seed=11)]},
                        {"start_index": -4, "length": 2}, ["X"]),
    "reverse_axes": ("reverse", {"X": f32(2, 3, 4, seed=12)},
                     {"axis": [0, 2]}, ["X"]),
    "linspace_9": ("linspace", {"Start": np.array([-2.5], np.float32),
                                "Stop": np.array([7.0], np.float32)},
                   {"num": 9}, []),
    "shard_index_ignore": ("shard_index",
                           {"X": np.array([[0], [5], [9], [12], [19]],
                                          np.int64)},
                           {"index_num": 20, "nshards": 3, "shard_id": 1,
                            "ignore_value": -7}, []),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cases(name):
    op_type, inputs, attrs, grads = CASES[name]
    j, t = both(op_type, inputs, attrs, outs_of(op_type), grads=grads)
    check(j, t)


# -- hash --------------------------------------------------------------------------


def _hash_numpy(x, num_hash, mod_by):
    """The uint32 mix in numpy's wrapping uint32 arithmetic, the seed
    term i * 0x85EBCA6B a uint32 product."""
    x = x.astype(np.int64).astype(np.uint32)
    outs = []
    with np.errstate(over="ignore"):
        for i in range(num_hash):
            h = x * np.uint32(0x9E3779B1) + np.uint32(i) * np.uint32(
                0x85EBCA6B)
            h = h ^ (h >> np.uint32(16))
            h = h * np.uint32(0xC2B2AE35)
            h = h ^ (h >> np.uint32(13))
            outs.append((h % np.uint32(mod_by)).astype(np.int64))
    return np.stack(outs, -2) if num_hash > 1 else outs[0]


IDS = np.array([[0], [1], [7], [-3], [65535], [2 ** 31 - 1], [-2 ** 31],
                [123456789]], np.int64)


@pytest.mark.parametrize("num_hash,mod_by", [(1, 65536), (2, 1 << 20),
                                             (2, 1000003)])
def test_hash_equals_jax_bit_for_bit(num_hash, mod_by):
    attrs = {"num_hash": num_hash, "mod_by": mod_by}
    j, t = both("hash", {"X": IDS}, attrs)
    check(j, t)
    np.testing.assert_array_equal(t["o_Out_0"],
                                  _hash_numpy(IDS, num_hash, mod_by))


def test_fault_hash_past_two_seeds():
    """JAX builds the i-th seed term ``jnp.uint32(i * 0x85EBCA6B)`` from a
    Python int, which overflows uint32 from i = 2: its lowering raises at
    num_hash 3 and above. The port wraps the term to 32 bits (the uint32
    product it stands for) and agrees with JAX wherever JAX runs."""
    with pytest.raises(OverflowError):
        run_op(jfluid, "hash", {"X": IDS}, {"num_hash": 4, "mod_by": 997})
    t = run_op(fluid, "hash", {"X": IDS}, {"num_hash": 4, "mod_by": 997})
    np.testing.assert_array_equal(t["o_Out_0"], _hash_numpy(IDS, 4, 997))
    assert t["o_Out_0"].shape == (8, 4, 1)


# -- random ops ------------------------------------------------------------------


def test_random_ops_statistics_hold_for_the_port(monkeypatch):
    """tests/test_op_sweep.py ``test_random_ops_statistics`` (the
    ``*_batch_size_like`` pair, truncated_gaussian_random, randint,
    random_crop, shuffle_batch) on the port."""
    monkeypatch.setattr(sweep, "fluid", fluid)
    sweep.test_random_ops_statistics()


class _Op:
    def __init__(self, type, attrs, inputs=None, outputs=None):
        self.type, self.attrs = type, dict(attrs, op_ident=7)
        self.inputs, self.outputs = inputs or {}, outputs or {}


def test_random_crop_from_its_own_draws(monkeypatch):
    """The window the port crops is where its generator's draws put it,
    and JAX's lowering given those draws crops the same window."""
    x = np.arange(2 * 3 * 9 * 8, dtype=np.float32).reshape(2, 3, 9, 8)
    op = _Op("random_crop", {"shape": [4, 5]})
    ctx = LoweringContext("cpu", seed=3, step=2)
    got = get_op_def("random_crop").lower(ctx, op,
                                          {"X": [torch.from_numpy(x)]})
    gen = ctx.op_generator(op)
    starts = [int(torch.randint(0, n - s + 1, (), generator=gen))
              for n, s in ((9, 4), (8, 5))]
    want = x[:, :, starts[0]:starts[0] + 4, starts[1]:starts[1] + 5]
    np.testing.assert_array_equal(got["Out"][0].numpy(), want)
    draws = iter(starts)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.int32(next(draws)))
    jgot = jax_op_def("random_crop").lower(JaxContext(), op,
                                           {"X": [jnp.asarray(x)]})
    np.testing.assert_array_equal(np.asarray(jgot["Out"][0]), want)


def test_shuffle_batch_is_its_own_permutation():
    x = f32(16, 5, seed=13)
    out = run_op(fluid, "shuffle_batch", {"X": x},
                 outs={"Out": 1, "ShuffleIdx": 1, "SeedOut": 1})
    perm = out["o_ShuffleIdx_0"]
    assert perm.dtype == np.int32
    assert sorted(perm.tolist()) == list(range(16))
    np.testing.assert_array_equal(out["o_Out_0"], x[perm])
