"""Parity cases for the lowerings earlier slices ported whose only CPU
parity was through the layers and Programs that use them (no
``test_torch_*`` file named them): the collectives and sequence ops with
a sweep row (through both packages and through JAX's ``_run_spec`` on the
port, ``test_torch_sweep_tensor.sweep_check``; a collective outside a
world is the identity in both), the comm-setup ops lowered in a Program
in both, one-op cases for the rest (forward rtol 1e-5 / atol 1e-6,
gradients 1e-4 / 1e-5), and the two random fills by their moments. With
the sweep twins this gives every lowering the port registers a parity
case (``test_torch_layer_surface``'s ratchet).
"""

import numpy as np
import pytest

from test_torch_activations import both, run_op
from test_torch_rnn import check_split, f32
from test_torch_sweep_tensor import outs_of, sweep_check

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid

ROWS = ["allreduce", "c_allgather", "c_allreduce_max", "c_allreduce_min",
        "c_allreduce_prod", "c_allreduce_sum", "c_broadcast",
        "c_reducescatter", "c_sync_calc_stream", "c_sync_comm_stream",
        "fusion_seqconv_eltadd_relu", "get_places", "rnn_memory_helper",
        "sequence_concat", "sequence_expand", "sequence_mask",
        "sequence_pad", "sequence_reshape", "sequence_reverse",
        "sequence_softmax", "sequence_unpad", "squeeze2"]


@pytest.mark.parametrize("name", ROWS)
def test_sweep_rows(name, monkeypatch):
    sweep_check(name, monkeypatch)


NOOPS = ["c_comm_init", "c_comm_init_all", "c_gen_nccl_id", "c_wait_comm",
         "c_wait_compute"]


@pytest.mark.parametrize("pkg", [jfluid, fluid], ids=["jax", "port"])
def test_comm_setup_noops_lower(pkg):
    """The comm-setup ops of tests/test_op_sweep.py ``NOOP_OPS`` (its
    ``delete_var`` is the parameter server's, not ported) lower inside a
    Program and leave its result alone, as JAX's
    ``test_comm_setup_noops_lower``."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [2])
        out = pkg.layers.scale(x, scale=2.0)
        for t in NOOPS:
            main.global_block().append_op(
                type=t, attrs={"ring_id": 0, "nranks": 1, "rank": 0})
    (r,) = pkg.Executor(pkg.CPUPlace()).run(
        main, feed={"x": np.ones((1, 2), np.float32)}, fetch_list=[out],
        scope=pkg.Scope())
    np.testing.assert_array_equal(np.asarray(r), [[2.0, 2.0]])


CASES = {
    "assign": ("assign", {"X": f32(3, 4, seed=1)}, {}, ["X"]),
    "assign_value": ("assign_value", {},
                     {"shape": [2, 3], "dtype": "float32",
                      "fp32_values": [0.5, -1.0, 2.0, 3.5, 0.0, 1.25]}, []),
    "fill_zeros_like": ("fill_zeros_like", {"X": f32(2, 5, seed=2)}, {}, []),
    "elementwise_sub": ("elementwise_sub", {"X": f32(2, 3, 4, seed=3),
                                            "Y": f32(3, seed=4)},
                        {"axis": 1}, ["X", "Y"]),
    "matmul": ("matmul", {"X": f32(2, 3, 4, seed=5), "Y": f32(2, 5, 4, seed=6)},
               {"transpose_Y": True, "alpha": 0.5}, ["X", "Y"]),
    "transpose2": ("transpose2", {"X": f32(2, 3, 4, seed=7)},
                   {"axis": [2, 0, 1]}, ["X"]),
    "unsqueeze2": ("unsqueeze2", {"X": f32(2, 3, seed=8)}, {"axes": [0, 3]},
                   ["X"]),
    # without a world the bucket's gradients are already whole
    "collective_bucket_reduce": ("collective_bucket_reduce",
                                 {"X": [f32(3, 2, seed=9), f32(4, seed=10)]},
                                 {}, []),
    "local_sgd_select_sync": ("local_sgd_select",
                              {"Step": np.array([6.0], np.float32),
                               "Avg": f32(3, seed=11),
                               "Param": f32(3, seed=12)}, {"every": 3.0}, []),
    "local_sgd_select_local": ("local_sgd_select",
                               {"Step": np.array([7.0], np.float32),
                                "Avg": f32(3, seed=13),
                                "Param": f32(3, seed=14)}, {"every": 3.0},
                               []),
}
N_OUT = {"collective_bucket_reduce": {"Out": 2}}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cases(name):
    op_type, inputs, attrs, grads = CASES[name]
    j, t = both(op_type, inputs, attrs, outs_of(op_type, N_OUT.get(op_type)),
                grads=grads)
    check_split(j, t)


@pytest.mark.parametrize("op_type,attrs,mean,std", [
    ("gaussian_random", {"shape": [200, 100], "mean": 1.0, "std": 2.0},
     1.0, 2.0),
    ("uniform_random", {"shape": [200, 100], "min": -1.0, "max": 3.0},
     1.0, 4.0 / np.sqrt(12.0))])
def test_random_fills_by_their_moments(op_type, attrs, mean, std):
    out = run_op(fluid, op_type, {}, attrs)["o_Out_0"]
    assert out.shape == (200, 100) and out.dtype == np.float32
    assert abs(out.mean() - mean) < 0.05 and abs(out.std() - std) < 0.05
    if op_type == "uniform_random":
        assert out.min() >= -1.0 and out.max() <= 3.0
