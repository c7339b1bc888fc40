"""A world formed by ``init_parallel_env`` is torn down at exit.

``init_process_group`` and ``new_group`` enter every process group into
c10d's C++ registry, a static object. A rank that formed a world and
returned without destroying it left its groups to the C++ static
destructors, which run after the interpreter has finalized; now and
then a rank aborted there (``terminate called without an active
exception``, exit -6), and the launcher failed the world after every
collective had run.

* ``test_the_world_is_destroyed_before_the_interpreter_finalizes``:
  each worker registers an ``atexit`` probe before it forms the world
  (``atexit`` runs last-in first-out, so the probe runs after any
  teardown the port registers) and records whether a process group is
  still alive. Deterministic: on a port without the teardown both
  ranks record a live world.
* ``test_worlds_that_only_gather_and_return_exit_cleanly``: several
  worlds of 2 at once, whose workers form subgroups, all-gather, leave
  an asynchronous all-reduce unwaited and return; every launch exits 0
  and no rank prints the abort. The abort is rare (about one world in
  a hundred under load), so this is a stress check, not the proof.

Run a worker by hand: python -m paddle_tpu_torch.distributed.launch
--nproc_per_node 2 --backend gloo tests/test_torch_world_exit.py
--worker OUT_DIR
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = 6


def _worker(out_dir):
    import atexit

    import torch
    import torch.distributed as dist

    rank = int(os.environ["PADDLE_TRAINER_ID"])

    def probe():
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"alive": dist.is_initialized()}, f)

    atexit.register(probe)
    from paddle_tpu_torch.parallel.env import init_parallel_env

    init_parallel_env()
    groups = [dist.new_group([0, 1]) for _ in range(3)]
    out = torch.empty(8)
    dist.all_gather_into_tensor(out, torch.full((4,), float(rank)),
                                group=groups[0])
    assert out.tolist() == [0.0] * 4 + [1.0] * 4, out
    # left in flight: the process returns without waiting on it
    dist.all_reduce(torch.ones(1000), async_op=True, group=groups[1])


def _launch(d):
    from paddle_tpu_torch.parallel.env import free_port

    os.makedirs(d, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", f"--started_port={free_port()}",
         "--backend=gloo", f"--run_dir={os.path.join(d, 'run')}",
         os.path.abspath(__file__), "--worker", d],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)


def _finish(proc):
    out, _ = proc.communicate(timeout=120)
    return proc.returncode, out


def test_the_world_is_destroyed_before_the_interpreter_finalizes(tmp_path):
    rc, out = _finish(_launch(str(tmp_path)))
    assert rc == 0, out[-4000:]
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got == {"alive": False}, (r, got)


def test_worlds_that_only_gather_and_return_exit_cleanly(tmp_path):
    procs = [_launch(str(tmp_path / f"w{i}")) for i in range(WORLDS)]
    results = [_finish(p) for p in procs]
    for rc, out in results:
        assert "terminate called" not in out, out[-4000:]
        assert rc == 0, out[-4000:]


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
