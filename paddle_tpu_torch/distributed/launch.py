"""Elastic multi-process trainer launcher: the port's counterpart of
``paddle_tpu/distributed/launch.py`` (reference
python/paddle/distributed/launch.py:175).

One process a device. Every child gets the reference's contract
(``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``), the restart
generation (``PADDLE_RESTART_COUNT``), ``MASTER_ADDR`` /
``MASTER_PORT`` at rank 0's endpoint, ``FLAGS_selected_gpus`` and
``PADDLE_DIST_BACKEND`` from ``--backend`` (``nccl``, or ``gloo``: the
one backend under which two ranks can share one GPU).

* failure detection: a child that exits nonzero, or whose heartbeat
  file (written by ``distributed.coordinator``) goes stale past
  ``--heartbeat_timeout_s``, fails the world;
* teardown: every survivor gets SIGTERM, then SIGKILL after
  ``--kill_grace_s``;
* world restart: with ``--max_restarts`` > 0 the world is relaunched
  with a fresh rendezvous port and ``PADDLE_RESTART_COUNT`` bumped, and
  a supervised script resumes from its last committed checkpoint;
* exit codes: the first nonzero child exit is propagated once restarts
  are spent, and every child line is prefixed ``[rank N]``.

Usage: python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
           --backend gloo --max_restarts 1 train.py --args...
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

# exit code reported when the failure was a stale heartbeat (the child
# was still "alive"; there is no child exit code to propagate)
HANG_EXIT_CODE = 75  # == coordinator.RESTART_EXIT_CODE, kept import-free


def _parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--cluster_node_ips", default="127.0.0.1")
    p.add_argument("--node_ip", default="127.0.0.1")
    p.add_argument("--started_port", type=int, default=6170)
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--max_restarts", type=int, default=0,
                   help="world restarts after a rank failure (elastic); "
                        "0 = fail fast (legacy behavior)")
    p.add_argument("--kill_grace_s", type=float, default=10.0,
                   help="SIGTERM -> SIGKILL escalation grace per teardown")
    p.add_argument("--heartbeat_timeout_s", type=float, default=30.0,
                   help="a rank whose heartbeat (written once it calls "
                        "distributed.initialize()) is older than this is "
                        "declared hung; 0 disables")
    p.add_argument("--heartbeat_interval_s", type=float, default=2.5)
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="the torch.distributed backend of the world "
                        "(default: nccl with CUDA, else gloo); gloo lets "
                        "several ranks share one GPU")
    p.add_argument("--run_dir", default=None,
                   help="scratch dir for heartbeats/launcher state "
                        "(default: a fresh temp dir)")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _free_port() -> int:
    from ..parallel.env import free_port

    return free_port()


class _LogPump(threading.Thread):
    """Reads one child's merged stdout/stderr and re-emits every line
    prefixed with its rank — concurrent children interleave at line,
    not byte, granularity."""

    def __init__(self, rank: int, pipe, sink):
        super().__init__(daemon=True, name=f"pt-launch-logpump-{rank}")
        self.prefix = f"[rank {rank}] ".encode()
        self.pipe = pipe
        self.sink = sink
        self.start()

    def run(self):
        try:
            for line in iter(self.pipe.readline, b""):
                self.sink.write(self.prefix + line)
                self.sink.flush()
        except (ValueError, OSError):
            pass  # pipe torn down during kill-all
        finally:
            try:
                self.pipe.close()
            except OSError:
                pass


class _Child:
    def __init__(self, rank: int, proc, pump, log_fd):
        self.rank = rank
        self.proc = proc
        self.pump = pump
        self.log_fd = log_fd


def _spawn_world(args, generation: int, base_port: int, hb_dir: str):
    node_ips = args.cluster_node_ips.split(",")
    node_id = node_ips.index(args.node_ip)
    nproc = args.nproc_per_node
    world = len(node_ips) * nproc
    # deterministic per-generation ports: every node derives the same
    # endpoint list without cross-node coordination (the old rank-0
    # coordination port may sit in TIME_WAIT after a kill-all)
    endpoints = [
        f"{ip}:{base_port + i}" for ip in node_ips for i in range(nproc)
    ]
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    os.makedirs(hb_dir, exist_ok=True)
    children = []
    for local_rank in range(nproc):
        rank = node_id * nproc + local_rank
        env = dict(os.environ)
        env.update(
            {
                "PADDLE_TRAINER_ID": str(rank),
                "PADDLE_TRAINERS_NUM": str(world),
                "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
                "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
                "FLAGS_selected_gpus": str(local_rank),
                "MASTER_ADDR": endpoints[0].rsplit(":", 1)[0],
                "MASTER_PORT": endpoints[0].rsplit(":", 1)[1],
                "PADDLE_RESTART_COUNT": str(generation),
                "PADDLE_HEARTBEAT_DIR": hb_dir,
                "PADDLE_HEARTBEAT_INTERVAL_S": str(args.heartbeat_interval_s),
            }
        )
        if args.backend:
            env["PADDLE_DIST_BACKEND"] = args.backend
        cmd = [sys.executable, "-u", args.training_script] \
            + args.training_script_args
        log_fd = pump = None
        if args.log_dir:
            # per-rank file, named by GLOBAL rank + generation so a
            # restarted world never clobbers the evidence of the one
            # that failed
            log_fd = open(
                os.path.join(args.log_dir,
                             f"workerlog.{rank}.gen{generation}"), "wb")
            proc = subprocess.Popen(cmd, env=env, stdout=log_fd,
                                    stderr=subprocess.STDOUT)
        else:
            proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
            pump = _LogPump(rank, proc.stdout, sys.stderr.buffer)
        children.append(_Child(rank, proc, pump, log_fd))
    return children


def _kill_world(children, grace_s: float):
    """SIGTERM everyone, then SIGKILL whoever ignored it. Always reaps
    — no zombies, no still-running siblings after the launcher
    returns."""
    alive = [c for c in children if c.proc.poll() is None]
    for c in alive:
        try:
            c.proc.send_signal(signal.SIGTERM)
        except OSError:
            pass
    deadline = time.time() + max(0.0, grace_s)
    for c in alive:
        remaining = deadline - time.time()
        try:
            c.proc.wait(timeout=max(0.1, remaining))
        except subprocess.TimeoutExpired:
            sys.stderr.write(
                f"[launch] rank {c.rank} ignored SIGTERM for "
                f"{grace_s:.0f}s; escalating to SIGKILL\n")
            try:
                c.proc.kill()
            except OSError:
                pass
            c.proc.wait()
    for c in children:
        if c.log_fd is not None:
            c.log_fd.close()


def _stale_ranks(hb_dir: str, timeout_s: float):
    """Ranks whose heartbeat file exists but stopped updating. Ranks
    that never wrote one (script doesn't use the coordinator) are never
    declared hung — only silence AFTER a first beat is evidence."""
    out = []
    if timeout_s <= 0 or not os.path.isdir(hb_dir):
        return out
    now = time.time()
    for entry in os.listdir(hb_dir):
        if not entry.startswith("hb.rank"):
            continue
        try:
            rank = int(entry[len("hb.rank"):])
            if now - os.path.getmtime(os.path.join(hb_dir, entry)) \
                    > timeout_s:
                out.append(rank)
        except (ValueError, OSError):
            continue
    return sorted(out)


def _run_generation(args, generation: int, base_port: int,
                    run_dir: str) -> int:
    """Spawn + monitor one world; returns 0 on clean success or the
    FIRST failure's exit code (HANG_EXIT_CODE for a stale-heartbeat
    hang)."""
    hb_dir = os.path.join(run_dir, f"hb.gen{generation}")
    children = _spawn_world(args, generation, base_port, hb_dir)
    first_bad: int | None = None
    try:
        while True:
            running = []
            for c in children:
                ret = c.proc.poll()
                if ret is None:
                    running.append(c)
                elif ret != 0 and first_bad is None:
                    first_bad = ret
                    sys.stderr.write(
                        f"[launch] rank {c.rank} exited with code {ret}; "
                        "terminating the world\n")
            if first_bad is not None:
                break
            if not running:
                return 0  # every rank exited 0
            hung = _stale_ranks(hb_dir, args.heartbeat_timeout_s)
            hung = [r for r in hung
                    if any(c.rank == r and c.proc.poll() is None
                           for c in children)]
            if hung:
                first_bad = HANG_EXIT_CODE
                sys.stderr.write(
                    f"[launch] rank(s) {hung} heartbeat stale "
                    f"(> {args.heartbeat_timeout_s:.0f}s) — declaring "
                    "hung; terminating the world\n")
                break
            time.sleep(0.2)
    finally:
        _kill_world(children, args.kill_grace_s)
    return int(first_bad)


def launch(args) -> int:
    run_dir = args.run_dir or tempfile.mkdtemp(prefix="pt_launch_")
    os.makedirs(run_dir, exist_ok=True)
    first_bad: int | None = None
    nproc = args.nproc_per_node
    world = len(args.cluster_node_ips.split(",")) * nproc
    for generation in range(args.max_restarts + 1):
        # restarts re-rendezvous on a fresh port (the dead world's may
        # sit in TIME_WAIT). With an explicit --started_port the ladder
        # is DETERMINISTIC — started_port + generation*world — so every
        # node's launcher derives the same endpoint list without
        # cross-node coordination (a node-local free port would leave
        # node B rendezvousing at its own idea of rank 0's endpoint).
        # --started_port=0 = "pick one for me": single-node only, where
        # the one launcher owns the whole endpoint list.
        if args.started_port:
            base_port = args.started_port + generation * world
        else:
            base_port = _free_port()
        if generation:
            sys.stderr.write(
                f"[launch] restarting world (restart {generation}/"
                f"{args.max_restarts}) with fresh rendezvous port "
                f"{base_port}\n")
        code = _run_generation(args, generation, base_port, run_dir)
        if code == 0:
            if generation:
                sys.stderr.write(
                    f"[launch] world completed after {generation} "
                    "restart(s)\n")
            return 0
        if first_bad is None:
            first_bad = code
    sys.stderr.write(
        f"[launch] restart budget exhausted; exiting with the first "
        f"failure's code {first_bad}\n")
    # propagate the FIRST nonzero child exit code (negative = killed by
    # signal N -> conventional 128+N so the shell sees it)
    return first_bad if first_bad > 0 else 128 - first_bad


if __name__ == "__main__":
    sys.exit(launch(_parse_args()))
