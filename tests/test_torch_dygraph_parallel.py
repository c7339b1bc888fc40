"""``dygraph.DataParallel`` in a gloo world of 2 on the CPU: phase k4's
gate of ``chip_smoke.py`` at a small size.

The world (``python -m paddle_tpu_torch.distributed.launch
--nproc_per_node 2 --backend gloo tests/test_torch_dygraph_parallel.py
--worker DIR``) trains a small conv / batch-norm / linear net under
``DataParallel`` for 2 Momentum steps, each rank on its half of every
batch: ``scale_loss`` (1/2), ``backward()``, ``apply_collective_grads``
(the sum over the world), ``minimize``. The reference is one process
that runs the same two halves through ``backward()`` with each loss
scaled by 1/2, lets the gradients accumulate, then steps; once in the
port and once in the JAX package (from the same initial values).

Gates: the ranks' parameters equal bit for bit after every step; the
world's parameters within 2·lr·steps of the port's reference and
Momentum's velocities within relative L2 1e-4; the world's parameters
within rtol 2e-4 / atol 2e-5 of JAX's reference (the training
tolerance of tests/test_torch_dygraph.py). BatchNorm's running
statistics are not compared: each rank updates them from its own half.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD, ROWS, STEPS, LR = 2, 4, 2, 0.05
VEL_RTOL = 1e-4


def net(dgm):
    from_trace = dgm.base._trace

    class Net(dgm.Layer):
        def __init__(self):
            super().__init__()
            self.conv = dgm.Conv2D(3, 4, 3, padding=1, bias_attr=False)
            self.bn = dgm.BatchNorm(4, act="relu")
            self.pool = dgm.Pool2D(2, "avg", 2)
            self.fc = dgm.Linear(4 * 4 * 4, 5)

        def forward(self, x):
            h = self.pool(self.bn(self.conv(x)))
            (h,) = from_trace("reshape2", {"X": [h]}, ["Out", "XShape"],
                              {"shape": [-1, 64]})[:1]
            return self.fc(h)

    return Net()


def batches():
    rng = np.random.RandomState(7)
    return [(rng.randn(WORLD * ROWS, 3, 8, 8).astype("float32"),
             rng.randint(0, 5, (WORLD * ROWS, 1)).astype("int64"))
            for _ in range(STEPS)]


def loss_of(pkg, dgm, model, x, y):
    trace = dgm.base._trace
    _, per_row = trace("softmax_with_cross_entropy",
                       {"Logits": [model(dgm.to_variable(x))],
                        "Label": [dgm.to_variable(y)]},
                       ["Softmax", "Loss"], {})
    return trace("mean", {"X": [per_row]}, ["Out"], {})[0]


def velocities(opt, model):
    states = opt._eager_states
    return {k: np.asarray(states[id(p)]["velocity"])
            for k, p in model.named_parameters() if id(p) in states}


def trainable(model):
    return {k: p.numpy() for k, p in model.named_parameters()
            if not p.stop_gradient}


def reference(pkg, dgm, guard, init):
    """The two halves of each batch accumulated in one process."""
    with guard():
        model = net(dgm)
        model.set_dict(init)
        opt = pkg.optimizer.Momentum(LR, momentum=0.9)
        for x, y in batches():
            for h in range(WORLD):
                rows = slice(h * ROWS, (h + 1) * ROWS)
                last = loss_of(pkg, dgm, model, x[rows], y[rows]) * 0.5
                last.backward()
            opt.minimize(last, parameter_list=model.parameters())
            model.clear_gradients()
        return trainable(model), velocities(opt, model)


def _worker(out_dir):
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.dygraph as dg

    env = dg.prepare_context()
    rank = env.rank
    init = dict(np.load(os.path.join(out_dir, "init.npz")))
    same = []
    with dg.guard(fluid.CPUPlace()):
        model = net(dg)
        model.set_dict(init)
        dp = dg.DataParallel(model)
        assert dp.nranks == WORLD
        opt = fluid.optimizer.Momentum(LR, momentum=0.9)
        import torch

        for x, y in batches():
            rows = slice(rank * ROWS, (rank + 1) * ROWS)
            loss = dp.scale_loss(loss_of(fluid, dg, dp, x[rows], y[rows]))
            loss.backward()
            dp.apply_collective_grads()
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
            flat = torch.cat([p.value.detach().reshape(-1)
                              for p in model.parameters()
                              if not p.stop_gradient])
            parts = [torch.zeros_like(flat) for _ in range(WORLD)]
            torch.distributed.all_gather(parts, flat)
            same.append(all(torch.equal(parts[0], q) for q in parts[1:]))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 same=np.array(same),
                 **{"p:" + k: v for k, v in trainable(model).items()},
                 **{"v:" + k: v for k, v in velocities(opt, model).items()})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import paddle_tpu as jf
    import paddle_tpu.dygraph as jdg
    import paddle_tpu_torch as fluid
    import paddle_tpu_torch.dygraph as dg
    from paddle_tpu_torch.parallel.env import free_port

    d = tmp_path_factory.mktemp("dp_world")
    with jf.core.dygraph.dygraph_guard():
        init = net(jdg).state_dict()
    np.savez(str(d / "init.npz"), **init)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={WORLD}", f"--started_port={free_port()}",
         "--backend=gloo", f"--run_dir={d / 'run'}",
         os.path.abspath(__file__), "--worker", str(d)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    ref = reference(fluid, dg, lambda: dg.guard(fluid.CPUPlace()), init)
    jref = reference(jf, jdg, jf.core.dygraph.dygraph_guard, init)
    return ranks, ref, jref


def test_ranks_stay_equal_bit_for_bit(world):
    ranks, _, _ = world
    for r in ranks:
        assert r["same"].tolist() == [True] * STEPS
    for k in ranks[0]:
        if k.startswith(("p:", "v:")):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], k)


def test_world_equals_the_accumulated_halves(world):
    ranks, (params, vels), _ = world
    got = ranks[0]
    for k, v in params.items():
        assert np.abs(got["p:" + k] - v).max() <= 2 * LR * STEPS, k
    for k, v in vels.items():
        err = np.linalg.norm(got["v:" + k] - v) / np.linalg.norm(v)
        assert err <= VEL_RTOL, (k, err)


def test_world_equals_jax_accumulated_halves(world):
    ranks, _, (jparams, jvels) = world
    for k, v in jparams.items():
        np.testing.assert_allclose(ranks[0]["p:" + k], v, rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    for k, v in jvels.items():
        np.testing.assert_allclose(ranks[0]["v:" + k], v, rtol=2e-4,
                                   atol=2e-5, err_msg=k)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.path.insert(0, REPO)
        _worker(sys.argv[2])
