"""The slice as a whole on the CPU: ``chip_smoke.py``'s CycleGAN ResNet
generator (``m_generator``: reflection ``pad2d``, ``conv2d``,
``instance_norm``, ``conv2d_transpose``, relu, tanh and an L1 loss under
Adam with beta1 0.5), built with either package at ngf 8, 2 residual
blocks, 32 x 32, batch 2. The port starts from JAX's startup values
(``io.load_scope_arrays``); after 3 Adam steps the losses and every
persistable (parameters, moments, beta powers) are within rtol 1e-4 /
atol 1e-5 of JAX's, and both programs are the same Program.
"""

import os
import sys

import numpy as np

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu_torch.io import load_scope_arrays

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

SIZE, BATCH, NGF, BLOCKS, STEPS = 32, 2, 8, 2, 3
RTOL, ATOL = 1e-4, 1e-5


def _build(pkg):
    main, startup, loss = chip_smoke.m_generator(
        pkg, SIZE, batch=BATCH, ngf=NGF, n_blocks=BLOCKS)
    main.random_seed = startup.random_seed = 5
    return main, startup, loss


def test_generator_is_one_program_in_both_packages():
    jm, js, _ = _build(jfluid)
    tm, ts, _ = _build(fluid)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    types = [op.type for op in tm.global_block().ops]
    for t in ("pad2d", "conv2d", "instance_norm", "conv2d_transpose",
              "relu", "tanh", "instance_norm_grad", "pad2d_grad"):
        assert t in types, t
    # 5 + 2 * BLOCKS instance norms of (scale, bias), as many bias-free
    # convolutions before them, and the last convolution with its bias
    assert len(tm.all_parameters()) == 3 * (5 + 2 * BLOCKS) + 2


def test_three_adam_steps_match_jax():
    feeds = chip_smoke.m_images(np, 7, STEPS, SIZE, BATCH)
    jfluid.set_flags({"optimizer_fuse": "on"})
    fluid.set_flags({"optimizer_fuse": "on"})
    try:
        jm, js, jloss = _build(jfluid)
        tm, ts, tloss = _build(fluid)
        jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js, scope=jscope)
        state = [v.name for v in jm.list_vars()
                 if v.persistable and not v.is_data]
        init = {n: np.asarray(jscope.get_numpy(n)) for n in state}
        tscope, texe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
        texe.run(ts, scope=tscope)
        load_scope_arrays(tscope, init, tm, "cpu")
        for f in feeds:
            lj = np.asarray(jexe.run(jm, feed=f, fetch_list=[jloss],
                                     scope=jscope)[0])
            lt = np.asarray(texe.run(tm, feed=f, fetch_list=[tloss],
                                     scope=tscope)[0])
            np.testing.assert_allclose(lt, lj, rtol=RTOL, atol=ATOL)
        for n in state:
            np.testing.assert_allclose(
                np.asarray(tscope.get_numpy(n)),
                np.asarray(jscope.get_numpy(n)), rtol=RTOL, atol=ATOL,
                err_msg=n)
    finally:
        jfluid.set_flags({"optimizer_fuse": "auto"})
        fluid.set_flags({"optimizer_fuse": "auto"})
