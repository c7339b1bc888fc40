"""The twin of tests/test_op_sweep.py for the ops of ``ops/misc.py``,
``ops/math.py``, ``ops/random.py``, ``ops/control.py``, ``ops/persist.py``
and ``ops/optim.py`` this slice ports: the sweep rows through both
packages and through the JAX sweep's ``_run_spec`` on the port
(``test_torch_sweep_tensor.sweep_check``), the ops without a sweep row
(squeeze, unsqueeze, cross_entropy2, match_matrix_tensor, adamw,
sample_logits with customized samples) through both packages, and the
random ones by their statistics: ``sampling_id``'s frequencies,
``Categorical.sample``'s range, ``sample_logits`` recomputed from its own
draws (as the sweep's ``test_nce_recomputed_from_its_own_samples``).
Forward rtol 1e-5 / atol 1e-6, gradients 1e-4 / 1e-5 (``check_split``).

JAX's own tests of these ops (tests/test_ops_misc.py,
test_ops_persist.py, the distribution tests) run on the port in
``test_torch_jax_op_tests.py``.
"""

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from test_torch_activations import both, run_op
from test_torch_rnn import check_split, f32
from test_torch_sweep_tensor import outs_of, sweep_check, sweep_rows

ROWS = (sweep_rows("misc") + sweep_rows("math") + sweep_rows("random")
        + sweep_rows("control"))


@pytest.mark.parametrize("name", ROWS)
def test_sweep_rows(name, monkeypatch):
    sweep_check(name, monkeypatch)


def probs(n, c, seed=0):
    e = np.exp(f32(n, c, seed=seed))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


B, C, NT = 4, 10, 1

CASES = {
    "squeeze_all": ("squeeze", {"X": f32(2, 1, 3, 1, seed=1)}, {}, ["X"]),
    "squeeze_axes": ("squeeze", {"X": f32(2, 1, 3, 1, seed=2)},
                     {"axes": [-1]}, ["X"]),
    "unsqueeze": ("unsqueeze", {"X": f32(2, 3, seed=3)}, {"axes": [2, 0]},
                  ["X"]),
    "cross_entropy2": ("cross_entropy2",
                       {"X": probs(3, 4, seed=4),
                        "Label": np.array([[1], [3], [0]], np.int64)}, {},
                       ["X"]),
    "match_matrix_tensor": ("match_matrix_tensor",
                            {"X": f32(2, 3, 4, seed=5),
                             "Y": f32(2, 5, 4, seed=6),
                             "W": f32(4, 2, 4, seed=7)}, {"dim_t": 2},
                            ["X", "Y", "W"]),
    "matmul_v2_trans": ("matmul_v2", {"X": f32(2, 4, 3, seed=8),
                                      "Y": f32(5, 4, seed=9)},
                        {"trans_x": True, "trans_y": True}, ["X", "Y"]),
    "brelu_bounds": ("brelu", {"X": np.array([[-1, 0, 1, 2, 3]], np.float32)},
                     {"t_min": 0.0, "t_max": 2.0}, ["X"]),
    "adamw": ("adamw", {"Param": f32(3, 2, seed=10), "Grad": f32(3, 2, seed=11),
                        "LearningRate": np.full(1, 0.01, np.float32),
                        "Moment1": f32(3, 2, seed=12) * 0.1,
                        "Moment2": np.abs(f32(3, 2, seed=13)) * 0.1,
                        "Beta1Pow": np.full(1, 0.9, np.float32),
                        "Beta2Pow": np.full(1, 0.999, np.float32)},
              {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "coeff": 0.02},
              []),
    # customized samples draw nothing: the same columns in both packages
    "sample_logits_customized": (
        "sample_logits",
        {"Logits": f32(B, C, seed=14),
         "Labels": np.array([[1], [4], [4], [9]], np.int64),
         "CustomizedSamples": np.array([[1, 4, 2, 1], [4, 4, 0, 3],
                                        [4, 7, 8, 9], [9, 0, 9, 5]],
                                       np.int64),
         "CustomizedProbabilities": probs(B, 4, seed=15)},
        {"num_samples": 3}, ["Logits"]),
    "has_inf_nan": ("has_nan", {"X": np.array([1, np.nan, 2], np.float32)},
                    {}, []),
    "isfinite_inf": ("isfinite_v2",
                     {"X": np.array([1, np.inf, -np.inf, np.nan], np.float32)},
                     {}, []),
    "shuffle_channel_grad": ("shuffle_channel", {"X": f32(2, 6, 2, 2, seed=16)},
                             {"group": 3}, ["X"]),
    "npair_same_labels": ("npair_loss",
                          {"Anchor": f32(4, 3, seed=17),
                           "Positive": f32(4, 3, seed=18),
                           "Labels": np.array([1, 1, 2, 2], np.float32)},
                          {"l2_reg": 0.01}, ["Anchor", "Positive"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cases(name):
    op_type, inputs, attrs, grads = CASES[name]
    j, t = both(op_type, inputs, attrs, outs_of(op_type), grads=grads)
    check_split(j, t)


def test_sampling_id_frequencies():
    """2000 draws of a row: each category within 4 standard errors of its
    probability, and never one of probability 0."""
    p = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    out = run_op(fluid, "sampling_id", {"X": np.tile(p, (2000, 1))})
    ids = out["o_Out_0"]
    assert ids.shape == (2000,) and ids.dtype == np.int64
    freq = np.bincount(ids, minlength=4) / 2000.0
    se = np.sqrt(p * (1 - p) / 2000.0)
    assert np.all(np.abs(freq - p) <= 4 * se + 1e-9), freq
    assert freq[1] == 0


def test_sample_logits_from_its_own_draws():
    """The sampled columns are the true labels then the op's own draws:
    SampledLogits recomputed from Samples, -1e20 where a draw hits a true
    label, the true columns first."""
    rng = np.random.RandomState(19)
    logits = rng.randn(6, 12).astype(np.float32)
    labels = rng.randint(0, 12, (6, 2)).astype(np.int64)
    out = run_op(fluid, "sample_logits", {"Logits": logits, "Labels": labels},
                 {"num_samples": 5}, outs_of("sample_logits"))
    samples = out["o_Samples_0"]
    assert samples.shape == (6, 7)
    np.testing.assert_array_equal(samples[:, :2], labels)
    assert samples.min() >= 0 and samples.max() < 12
    want = np.take_along_axis(logits, samples, 1)
    hit = (samples[:, None, 2:] == labels[:, :, None]).any(1)
    want[:, 2:][hit] = -1e20
    np.testing.assert_array_equal(out["o_SampledLogits_0"], want)
    np.testing.assert_array_equal(out["o_SampledLabels_0"],
                                  np.tile(np.arange(2), (6, 1)))
    np.testing.assert_allclose(out["o_Probabilities_0"], 1.0 / 12)
    np.testing.assert_array_equal(out["o_LogitsDim_0"], [6, 12])


def test_print_prints_and_passes_through(capfd):
    x = f32(2, 3, seed=20)
    out = run_op(fluid, "print", {"In": x}, {"message": "step values"})
    np.testing.assert_array_equal(out["o_Out_0"], x)
    assert "step values" in capfd.readouterr().out
