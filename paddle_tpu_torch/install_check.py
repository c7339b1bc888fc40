"""Installation self-check: the port's copy of
``paddle_tpu/install_check.py`` (reference
python/paddle/fluid/install_check.py:46 ``run_check``).

``run_check()`` builds a tiny fc model and runs one SGD step on
``CUDAPlace(0)``, then, when more than one CUDA device is visible, the
same step data-parallel over a world of one process a device (the
port's data parallelism, started through
``paddle_tpu_torch.distributed.launch``), and prints the JAX package's
verdict lines. It runs on the card: with no GPU it raises, and it never
falls back to the CPU. A non-finite loss raises ``RuntimeError``.

    python -c "import paddle_tpu_torch as fluid; fluid.install_check.run_check()"
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

__all__ = ["run_check"]

# the package's parent directory: the launched workers import the package
# from there, as this process does
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _program(fluid, rows):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        x = fluid.layers.data("inp", [rows, 2], append_batch_size=False)
        loss = fluid.layers.mean(fluid.layers.fc(x, 4))
        fluid.optimizer.SGD(0.01).minimize(loss)
    return prog, startup, loss


def _one_step(fluid, place, compiled=False, rank=0):
    """One SGD step of the fc model on ``place`` (two rows a process);
    raises when the loss is not finite."""
    prog, startup, loss = _program(fluid, 2)
    run = prog
    if compiled:
        run = fluid.CompiledProgram(prog).with_data_parallel(
            loss_name=loss.name)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    xv = np.random.RandomState(rank).rand(2, 2).astype("float32")
    (lv,) = exe.run(run, feed={"inp": xv}, fetch_list=[loss], scope=scope)
    lv = float(np.asarray(lv).reshape(-1)[0])
    if not np.isfinite(lv):
        arm = "data-parallel" if compiled else "single-device"
        raise RuntimeError(
            f"install check failed: the {arm} step's loss is {lv}")
    return lv


def _data_parallel_check(nproc: int, backend: str = "nccl",
                         device: str = "cuda", timeout_s: float = 600.0):
    """The data-parallel arm: ``nproc`` processes under the port's
    launcher, each one step of the compiled program on its own device
    (``device`` "cuda": ``CUDAPlace(rank)``). Raises when a rank fails."""
    from .parallel.env import free_port

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    # a free port, not the launcher's fixed default: another world on
    # this host would take the store's port or join this world
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", str(nproc), "--backend", backend,
         "--started_port", str(free_port()),
         os.path.abspath(__file__), "--worker", device],
        env=env, capture_output=True, text=True, timeout=timeout_s)
    if out.returncode != 0:
        raise RuntimeError(
            f"install check failed: the data-parallel step over {nproc} "
            f"processes exited {out.returncode}: "
            f"{(out.stdout + out.stderr)[-2000:]}")


def _worker(device: str):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel.env import init_parallel_env

    env = init_parallel_env()
    place = (fluid.CUDAPlace(env.rank) if device == "cuda"
             else fluid.CPUPlace())
    _one_step(fluid, place, compiled=True, rank=env.rank)


def run_check():
    import torch

    import paddle_tpu_torch as fluid

    _one_step(fluid, fluid.CUDAPlace(0))
    n_dev = torch.cuda.device_count()
    if n_dev > 1:
        _data_parallel_check(n_dev)
        print(f"Your paddle_tpu_torch works well on {n_dev} devices.")
    else:
        print("Your paddle_tpu_torch works well on SINGLE device.")
    print("install check passed.")


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    # run as a script: its own directory must not shadow modules
    _here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _here]
    _worker(sys.argv[2])
