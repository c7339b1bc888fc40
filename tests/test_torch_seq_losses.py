"""The port's sequence losses and metrics (``ops/loss_ext.py``:
``warpctc``, ``linear_chain_crf``, ``crf_decoding``, ``edit_distance``,
``chunk_eval``) and ``evaluator.ChunkEvaluator`` / ``EditDistance``
against the JAX package, on the CPU.

One-op Programs in both packages (``test_torch_activations.both``):
forward within rtol 1e-5 / atol 1e-6, integer outputs exactly,
gradients within rtol 1e-4 / atol 1e-5.

* CTC is held to JAX's optax recursion: repeated labels, lengths, a
  blank other than 0, and a label too long for its input (JAX's
  ``log_epsilon`` gives a finite loss near 1e5 where ``F.ctc_loss``
  would give inf; such a row's gradient is held at atol 5e-3, the
  float32 rounding of values near 1e5). JAX's lowering ignores
  ``norm_by_times``, and so does the port's.
* The CRF's Transition is [C + 2, C] (start row, end row, pairs); its
  gradient reaches Emission and Transition. Viterbi ties go to the
  lower tag, as ``jnp.argmax``'s.
* The evaluators accumulate over three batches and ``eval`` the same
  numbers in both packages.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.core.framework import unique_name as jax_unique_name

import paddle_tpu_torch as fluid
from test_torch_activations import both
from test_torch_rnn import check_split, f32


def _i(*rows, dtype=np.int32):
    return np.array(rows, dtype)


CTC_OUTS = {"Loss": 1, "WarpCTCGrad": 1}


@pytest.mark.parametrize("case", ["lengths", "repeats_blank2", "dense",
                                  "infeasible"])
def test_warpctc(case):
    B, T, C = 3, 6, 5
    ins = {"Logits": f32(B, T, C, seed=1)}
    attrs = {"blank": 0, "norm_by_times": False}
    if case == "lengths":
        ins["Label"] = _i([1, 2, 0], [3, 3, 4], [2, 0, 0])
        ins["LogitsLength"] = _i(6, 4, 5)
        ins["LabelLength"] = _i(2, 3, 1)
    elif case == "repeats_blank2":
        attrs = {"blank": 2, "norm_by_times": True}
        ins["Label"] = _i([1, 1, 3], [4, 4, 4], [0, 1, 0])
        ins["LogitsLength"] = _i(6, 6, 5)
        ins["LabelLength"] = _i(3, 2, 3)
    elif case == "dense":
        ins["Label"] = _i([1, 2], [3, 4], [2, 1])
    else:  # 4 labels with repeats need more than 3 frames
        ins["Label"] = _i([1, 1, 1, 1], [2, 3, 0, 0], [4, 4, 0, 0])
        ins["LogitsLength"] = _i(3, 6, 2)
        ins["LabelLength"] = _i(4, 2, 2)
    j, t = both("warpctc", ins, attrs, CTC_OUTS, grads=("Logits",))
    if case == "infeasible":
        # rows 0 and 2 cannot emit their labels: their loss sits near
        # 1e5, where float32's spacing is 0.0078, so their gradients
        # carry that rounding (measured gap 2.4e-3); row 1 is held at
        # the gradient tolerance
        g = "Logits_0@GRAD"
        jg, tg = j.pop(g), t.pop(g)
        np.testing.assert_allclose(tg[1], jg[1], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tg[[0, 2]], jg[[0, 2]], atol=5e-3)
        assert 1e4 < float(np.asarray(t["o_Loss_0"])[0, 0]) < 1e6
    check_split(j, t)


CRF_OUTS = {"Alpha": 1, "EmissionExps": 1, "TransitionExps": 1,
            "LogLikelihood": 1}


@pytest.mark.parametrize("with_len", [False, True])
def test_linear_chain_crf(with_len):
    B, T, C = 3, 5, 4
    ins = {"Emission": f32(B, T, C, seed=1),
           "Transition": f32(C + 2, C, seed=2),
           "Label": np.random.RandomState(3).randint(0, C, (B, T)).astype(
               np.int64)}
    if with_len:
        ins["Length"] = _i(5, 1, 3)
    j, t = both("linear_chain_crf", ins, {}, CRF_OUTS,
                grads=("Emission", "Transition"))
    check_split(j, t)


@pytest.mark.parametrize("case", ["lengths", "ties"])
def test_crf_decoding(case):
    B, T, C = 3, 6, 4
    if case == "ties":
        # small integers: many equal path scores
        rng = np.random.RandomState(4)
        em = rng.randint(0, 2, (B, T, C)).astype(np.float32)
        tr = rng.randint(0, 2, (C + 2, C)).astype(np.float32)
        ins = {"Emission": em, "Transition": tr}
    else:
        ins = {"Emission": f32(B, T, C, seed=1),
               "Transition": f32(C + 2, C, seed=2), "Length": _i(6, 2, 4)}
    j, t = both("crf_decoding", ins, {}, {"ViterbiPath": 1})
    check_split(j, t)


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance(normalized):
    ins = {"Hyps": _i([1, 2, 3, 4], [5, 5, 6, 0], [1, 1, 1, 1],
                      dtype=np.int64),
           "Refs": _i([1, 3, 4, 0, 0], [5, 6, 6, 6, 7], [2, 2, 0, 0, 0],
                      dtype=np.int64),
           "HypsLength": _i(4, 3, 0, dtype=np.int64),
           "RefsLength": _i(3, 5, 2, dtype=np.int64)}
    j, t = both("edit_distance", ins, {"normalized": normalized},
                {"Out": 1, "SequenceNum": 1})
    check_split(j, t)


@pytest.mark.parametrize("case", ["one", "batch"])
def test_chunk_eval(case):
    if case == "one":
        ins = {"Inference": _i([1, 1, 0, 2, 2, 3]),
               "Label": _i([1, 1, 0, 2, 0, 3]), "SeqLength": _i(6)}
    else:
        rng = np.random.RandomState(5)
        lab = rng.randint(0, 4, (4, 9)).astype(np.int32)
        inf = np.where(rng.rand(4, 9) < 0.8, lab,
                       rng.randint(0, 4, (4, 9))).astype(np.int32)
        ins = {"Inference": inf, "Label": lab, "SeqLength": _i(9, 4, 7, 1)}
    outs = {s: 1 for s in ("Precision", "Recall", "F1-Score",
                           "NumInferChunks", "NumLabelChunks",
                           "NumCorrectChunks")}
    j, t = both("chunk_eval", ins, {"num_chunk_types": 3,
                                    "excluded_chunk_types_bg": 0}, outs)
    check_split(j, t)


# -- the evaluators ---------------------------------------------------------------


def _evaluate(pkg, kind, batches):
    names = jax_unique_name if pkg is jfluid else fluid.unique_name
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), names.guard():
        inf = pkg.layers.data("inf", [6], dtype="int64")
        lab = pkg.layers.data("lab", [6], dtype="int64")
        if kind == "chunk":
            ev = pkg.evaluator.ChunkEvaluator(inf, lab, "IOB", 3)
        else:
            ev = pkg.evaluator.EditDistance(inf, lab)
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        for b in batches:
            exe.run(main, feed=b, fetch_list=[])
        got = [np.asarray(v) for v in ev.eval(exe)]
        ev.reset(exe)
        after = [np.asarray(v) for v in ev.eval(exe)]
    return got, after


@pytest.mark.parametrize("kind", ["chunk", "edit"])
def test_evaluators_accumulate_like_jax(kind):
    rng = np.random.RandomState(6)
    batches = []
    for _ in range(3):
        lab = rng.randint(0, 4, (5, 6)).astype(np.int64)
        inf = np.where(rng.rand(5, 6) < 0.7, lab,
                       rng.randint(0, 4, (5, 6))).astype(np.int64)
        batches.append({"inf": inf, "lab": lab})
    jgot, jafter = _evaluate(jfluid, kind, batches)
    tgot, tafter = _evaluate(fluid, kind, batches)
    for a, b in zip(jgot + jafter, tgot + tafter):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    assert any(float(v) > 0 for v in tgot)
    assert all(float(v) == 0 for v in tafter)


def test_detection_map_is_refused_naming_its_roadmap_item():
    """Once refused by name, ``DetectionMAP`` is ported with the
    detection slice: two batches of hand-made detections give JAX's
    per-batch mAPs and their host-side mean."""
    from test_torch_ssd import detection_map_both

    dets = np.array([[[1, 0.9, 0.1, 0.1, 0.5, 0.5],
                      [2, 0.8, 0.5, 0.5, 0.9, 0.9],
                      [1, 0.4, 0.6, 0.1, 0.9, 0.4],
                      [-1, 0, 0, 0, 0, 0]],
                     [[2, 0.7, 0.2, 0.2, 0.6, 0.7],
                      [2, 0.6, 0.0, 0.0, 0.3, 0.3],
                      [1, 0.5, 0.5, 0.5, 0.8, 0.8],
                      [1, 0.3, 0.1, 0.1, 0.4, 0.4]]], np.float32)
    batch = {"gt_label": np.array([[1, 2, 0], [2, 1, 1]], np.int64),
             "gt_box": np.array([[[0.1, 0.1, 0.5, 0.5], [0.5, 0.5, 0.9, 0.9],
                                  [0, 0, 0, 0]],
                                 [[0.2, 0.2, 0.6, 0.6], [0.5, 0.5, 0.8, 0.9],
                                  [0.6, 0.0, 0.9, 0.3]]], np.float32)}
    j, t = detection_map_both(dets, batch, 3)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-6)
    np.testing.assert_allclose([t[0], t[2]], [j[0], j[2]], rtol=1e-6)
    assert 0 < t[0] < 100
