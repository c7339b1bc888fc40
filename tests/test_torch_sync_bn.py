"""``sync_batch_norm`` in a gloo world of 2 on the CPU: each rank runs the
op on its half of the batch under ``CompiledProgram.with_data_parallel``,
and Y, MeanOut, VarianceOut and X@GRAD must equal one process's
``batch_norm`` over the whole batch (rtol 1e-5 / atol 1e-6 forward,
1e-4 / 1e-5 for the gradient). The world runs this file as its worker
(``python tests/test_torch_sync_bn.py --worker DIR`` under
``paddle_tpu_torch.distributed.launch``); without a world the op is
``batch_norm``, held against JAX's op in ``test_torch_sweep_nn.py``.

The loss is each rank's sum of Y times a fed weight: the ranks' losses
add up to the whole batch's, so a rank's rows of X@GRAD are the whole
batch's rows, which the statistics' gradients summed over the ranks give.
"""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
N, C, H, W = 6, 3, 4, 5


def inputs():
    rng = np.random.RandomState(17)
    return {"X": (rng.randn(N, C, H, W) * 2 + 0.5).astype(np.float32),
            "Scale": (1 + 0.1 * rng.randn(C)).astype(np.float32),
            "Bias": (0.1 * rng.randn(C)).astype(np.float32),
            "Mean": (0.1 * rng.randn(C)).astype(np.float32),
            "Variance": (1 + 0.1 * rng.rand(C)).astype(np.float32),
            "Wt": rng.randn(N, C, H, W).astype(np.float32)}


def program(fl, op_type, batch):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        L, block = fl.layers, main.global_block()
        x = L.data("X", [batch, C, H, W], append_batch_size=False,
                   stop_gradient=False)
        ins = {"X": [x]}
        for s in ("Scale", "Bias", "Mean", "Variance"):
            ins[s] = [L.data(s, [C], append_batch_size=False)]
        wt = L.data("Wt", [batch, C, H, W], append_batch_size=False)
        outs = {s: [block.create_var(name=f"o_{s}", dtype="float32")]
                for s in ("Y", "MeanOut", "VarianceOut", "SavedMean",
                          "SavedVariance")}
        outs["Y"][0].shape = (batch, C, H, W)
        block.append_op(type=op_type, inputs=ins, outputs=outs,
                        attrs={"epsilon": 1e-5, "momentum": 0.9})
        loss = L.reduce_sum(L.elementwise_mul(outs["Y"][0], wt))
        fl.append_backward(loss)
    return main, loss


FETCH = ["o_Y", "o_MeanOut", "o_VarianceOut", "X@GRAD"]


def _feed(a, rows):
    return {k: (v[rows] if k in ("X", "Wt") else v) for k, v in a.items()}


def _worker(out_dir):
    import paddle_tpu_torch as fl
    from paddle_tpu_torch.parallel.env import init_parallel_env

    env = init_parallel_env()
    rank, n = env.rank, env.world_size
    per = N // n
    main, loss = program(fl, "sync_batch_norm", per)
    prog = fl.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    vals = fl.Executor(fl.CPUPlace()).run(
        prog, feed=_feed(inputs(), slice(rank * per, (rank + 1) * per)),
        fetch_list=FETCH, scope=fl.Scope())
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({k: np.asarray(v).tolist() for k, v in zip(FETCH, vals)},
                  f)


def test_sync_batch_norm_in_a_world_of_two_is_one_batch_norm(tmp_path):
    import paddle_tpu_torch as fl
    from paddle_tpu_torch.parallel.env import free_port

    a = inputs()
    main, _ = program(fl, "batch_norm", N)
    want = dict(zip(FETCH, fl.Executor(fl.CPUPlace()).run(
        main, feed=a, fetch_list=FETCH, scope=fl.Scope())))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={WORLD}", f"--started_port={free_port()}",
         "--backend=gloo", f"--run_dir={tmp_path / 'run'}",
         os.path.abspath(__file__), "--worker", str(tmp_path)],
        capture_output=True, text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    per = N // WORLD
    for r, got in enumerate(ranks):
        rows = slice(r * per, (r + 1) * per)
        np.testing.assert_allclose(np.asarray(got["o_Y"]), want["o_Y"][rows],
                                   rtol=1e-5, atol=1e-6, err_msg=f"Y {r}")
        for k in ("o_MeanOut", "o_VarianceOut"):
            np.testing.assert_allclose(np.asarray(got[k]), want[k],
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k} {r}")
        np.testing.assert_allclose(np.asarray(got["X@GRAD"]),
                                   want["X@GRAD"][rows], rtol=1e-4,
                                   atol=1e-5, err_msg=f"X@GRAD {r}")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.path.insert(0, REPO)
        _worker(sys.argv[2])
