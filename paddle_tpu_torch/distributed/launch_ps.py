"""Parameter-server job launcher, the port's counterpart of
``paddle_tpu/distributed/launch_ps.py`` (reference
python/paddle/distributed/launch_ps.py): on one node, spawn
``--server_num`` pserver processes and ``--worker_num`` trainer
processes of the same script under the ``PADDLE_*`` PS contract
(``PADDLE_PSERVERS_IP_PORT_LIST``, ``PADDLE_TRAINERS_NUM``,
``TRAINING_ROLE``, and ``PADDLE_CURRENT_ENDPOINT`` for a pserver or
``PADDLE_TRAINER_ID`` for a trainer)::

    python -m paddle_tpu_torch.distributed.launch_ps --server_num 2 \\
        --worker_num 2 train.py [args]

The script reads its role through ``fleet`` (``PaddleCloudRoleMaker``)
and runs ``fleet.run_server()`` or trains through ``fleet.init_worker()``.
The launcher returns when every trainer has exited, the first failing
trainer's exit code if one failed; the pservers are then sent SIGTERM
(and SIGKILL after a grace period), so no process outlives it.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time


def _parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch_ps")
    p.add_argument("--worker_num", type=int, default=2)
    p.add_argument("--server_num", type=int, default=2)
    p.add_argument("--started_port", type=int, default=6180)
    p.add_argument("--log_dir", default=None)
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _stop(procs, grace: float = 10.0) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.time() + grace
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch_ps(args) -> int:
    server_eps = [f"127.0.0.1:{args.started_port + i}"
                  for i in range(args.server_num)]
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    logs = []

    def spawn(role, idx):
        env = dict(os.environ)
        env.update({"PADDLE_PSERVERS_IP_PORT_LIST": ",".join(server_eps),
                    "PADDLE_TRAINERS_NUM": str(args.worker_num),
                    "TRAINING_ROLE": role})
        if role == "PSERVER":
            env["PADDLE_CURRENT_ENDPOINT"] = server_eps[idx]
        else:
            env["PADDLE_TRAINER_ID"] = str(idx)
        cmd = [sys.executable, "-u", args.training_script] + list(
            args.training_script_args)
        if args.log_dir:
            fd = open(os.path.join(args.log_dir, f"{role.lower()}.{idx}.log"),
                      "w")
            logs.append(fd)
            return subprocess.Popen(cmd, env=env, stdout=fd, stderr=fd)
        return subprocess.Popen(cmd, env=env)

    servers = [spawn("PSERVER", i) for i in range(args.server_num)]
    trainers = []
    rc = 0
    try:
        trainers = [spawn("TRAINER", i) for i in range(args.worker_num)]
        while any(p.poll() is None for p in trainers):
            bad = [p.returncode for p in trainers
                   if p.poll() not in (None, 0)]
            if bad:
                rc = bad[0]
                break
            time.sleep(0.2)
        else:
            rc = next((p.returncode for p in trainers if p.returncode), 0)
    finally:
        _stop(trainers + servers)
        for fd in logs:
            fd.close()
    return rc


if __name__ == "__main__":
    sys.exit(launch_ps(_parse_args()))
