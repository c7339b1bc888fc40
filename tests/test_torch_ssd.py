"""The port's SSD (``models/ssd.py``) and ``DetectionMAP`` against the JAX
package, on the CPU.

* ``build_ssd`` at the default 32 x 32 / 4 classes and at 64 x 64 / 6
  classes builds JAX's Program: op types, parameter names and shapes.
* 16 Adam(2e-3) steps over 8 synthetic batches of 4, as
  tests/test_models_ssd.py, from JAX's startup values
  (``io.load_scope_arrays``): losses and every persistable within
  ``test_torch_rnn.assert_trained_alike``'s rtol 1e-4 / atol 1e-5, and
  the first step's Adam moments within relative L2 1e-4.
* The ``for_test`` clone's detections on the trained weights equal
  JAX's: labels and counts exactly, scores and boxes within rtol 1e-5.
* ``evaluator.DetectionMAP`` (the ``detection_map`` op a image, averaged
  on the host) and ``metrics.DetectionMAP`` over those detections equal
  JAX's within 1e-5.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.metrics as jmetrics
from paddle_tpu.models.ssd import build_ssd as jax_build_ssd

import paddle_tpu_torch as fluid
from paddle_tpu_torch import metrics
from paddle_tpu_torch.io import load_scope_arrays
from paddle_tpu_torch.models.ssd import build_ssd, synthetic_det_batch
from test_torch_rnn import TRAIN_ATOL, TRAIN_RTOL, jax_init

STEPS, BATCH, LR = 16, 4, 2e-3


def _build(pkg, optimizer=None, **kw):
    make = jax_build_ssd if pkg is jfluid else build_ssd
    return make(optimizer=optimizer, **kw)


@pytest.mark.parametrize("size,classes", [(32, 4), (64, 6)])
def test_build_ssd_is_jax_program(size, classes):
    progs = []
    for pkg in (jfluid, fluid):
        main, startup, feeds, fetches = _build(pkg, image_size=size,
                                               num_classes=classes)
        block = main.global_block()
        params = {p.name: tuple(p.shape) for p in main.all_parameters()}
        progs.append(([op.type for op in block.ops], params,
                      {k: v.name for k, v in fetches.items()}, feeds))
    assert progs[1] == progs[0]
    assert len(progs[1][1]) == 14
    assert "ssd_loss_dense" in progs[1][0] and "multiclass_nms" in progs[1][0]


def _train(pkg, batches, init=None, steps=None):
    """(losses, persistables, scope, main, fetches) of ``steps`` Adam
    steps; the port starts from JAX's startup values ``init``."""
    main, startup, _, fetches = _build(pkg, pkg.optimizer.Adam(LR))
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        if init is None:
            init = jax_init(scope, main)
        else:
            load_scope_arrays(scope, init, main, "cpu")
        losses = [float(np.asarray(exe.run(
            main, feed=b, fetch_list=[fetches["loss"]])[0]).reshape(-1)[0])
            for b in batches[:steps]]
    state = {n: np.asarray(scope.get_numpy(n)) for n in init}
    return losses, state, scope, main, fetches, init


@pytest.fixture(scope="module")
def trained():
    rng = np.random.RandomState(0)
    batches = [synthetic_det_batch(rng, BATCH) for _ in range(8)] * 2
    jl, jstate, jscope, jmain, jfetch, init = _train(jfluid, batches)
    tl, tstate, tscope, tmain, tfetch, _ = _train(fluid, batches, init)
    return {"jax": (jl, jstate, jscope, jmain, jfetch),
            "port": (tl, tstate, tscope, tmain, tfetch),
            "init": init, "batches": batches}


def test_ssd_trains_like_jax(trained):
    jl, jstate = trained["jax"][:2]
    tl, tstate = trained["port"][:2]
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    for n in jstate:
        np.testing.assert_allclose(tstate[n], jstate[n], rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, err_msg=n)
    assert np.isfinite(tl).all() and tl[-1] < tl[0] * 0.9, tl


def test_first_adam_moments_match_jax(trained):
    batches = trained["batches"]
    _, jstate, *_, init = _train(jfluid, batches, steps=1)
    tstate = _train(fluid, batches, init, steps=1)[1]
    moments = [n for n in jstate if "_moment1_" in n]
    assert len(moments) == 14
    for n in moments:
        gap = np.linalg.norm(tstate[n] - jstate[n]) / np.linalg.norm(jstate[n])
        assert gap <= 1e-4, (n, gap)


def _detect(pkg, scope, main, fetches, batch):
    """The trained state's detections through the for_test clone of the
    model built without its optimizer (a clone of the training Program
    would step Adam)."""
    main, _, _, fetches = _build(pkg)
    infer = main.clone(for_test=True)
    with pkg.scope_guard(scope):
        dets, nums = pkg.Executor(pkg.CPUPlace()).run(
            infer, feed=batch,
            fetch_list=[fetches["detections"], fetches["det_nums"]])
    return np.asarray(dets), np.asarray(nums)


def test_for_test_clone_detects_like_jax(trained):
    batch = synthetic_det_batch(np.random.RandomState(1), 3)
    jd, jn = _detect(jfluid, *trained["jax"][2:], batch)
    td, tn = _detect(fluid, *trained["port"][2:], batch)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(td[..., 0], jd[..., 0])
    np.testing.assert_allclose(td[..., 1:], jd[..., 1:], rtol=1e-5,
                               atol=1e-6)
    assert jn.sum() > 0


def _map_program(pkg, keep, gts, class_num, ap_version):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        det = pkg.layers.data("det", [keep, 6], append_batch_size=False)
        lab = pkg.layers.data("lab", [gts, 1], append_batch_size=False)
        box = pkg.layers.data("box", [gts, 4], append_batch_size=False)
        ev = pkg.evaluator.DetectionMAP(det, lab, box, class_num=class_num,
                                        overlap_threshold=0.3,
                                        ap_version=ap_version)
    return main, startup, ev


def detection_map_both(dets, batch, class_num, ap_version="integral"):
    """{package: (evaluator eval, per-image MAPs, metrics.DetectionMAP
    eval)} over each image's detections and ground truth."""
    out = {}
    for pkg, mets in ((jfluid, jmetrics), (fluid, metrics)):
        main, startup, ev = _map_program(pkg, dets.shape[1],
                                         batch["gt_box"].shape[1], class_num,
                                         ap_version)
        scope = pkg.Scope()
        m = mets.DetectionMAP()
        maps = []
        with pkg.scope_guard(scope):
            exe = pkg.Executor(pkg.CPUPlace())
            exe.run(startup)
            for i in range(dets.shape[0]):
                feed = {"det": dets[i],
                        "lab": batch["gt_label"][i][:, None].astype(
                            np.float32),
                        "box": batch["gt_box"][i]}
                (v,) = exe.run(main, feed=feed, fetch_list=[ev.cur_map])
                maps.append(float(np.asarray(v).reshape(-1)[0]))
                m.update(v)
            out[pkg.__name__] = (float(ev.eval(exe)), maps, m.eval())
    return out["paddle_tpu"], out["paddle_tpu_torch"]


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
def test_detection_map_evaluators_equal_jax(trained, ap_version):
    batch = synthetic_det_batch(np.random.RandomState(2), 4)
    jd, _ = _detect(jfluid, *trained["jax"][2:], batch)
    j, t = detection_map_both(jd, batch, 4, ap_version)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([t[0], t[2]], [j[0], j[2]], rtol=1e-5,
                               atol=1e-5)
    assert t[0] == pytest.approx(np.mean(t[1]))
    assert t[0] > 0
