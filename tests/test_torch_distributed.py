"""The port's launcher and coordinator (``paddle_tpu_torch.distributed``),
the Supervisor's distributed seams and the distribution families of the
metrics registry, on the CPU: twins of test_multihost.py's launcher and
coordinator tests.

* the launcher (``python -m paddle_tpu_torch.distributed.launch``):
  the first nonzero exit propagates, SIGTERM escalates to SIGKILL,
  every line is ``[rank N]``-prefixed, a failed generation restarts the
  world on a fresh rendezvous, a stale heartbeat fails the world with 75,
  and each child gets ``PADDLE_DIST_BACKEND``, ``MASTER_ADDR`` /
  ``MASTER_PORT`` and ``FLAGS_selected_gpus``;
* the coordinator alone: heartbeats, a progress stall that silences
  them, the gauges, no-op barrier and host all-reduce, the mesh;
* in a gloo world of 2: the barrier over the store, its timeout
  (``BarrierTimeout`` when a rank never arrives), ``host_allreduce``'s
  mean (the same bits on both ranks) and the ``paddle_dist_*`` gauges;
* elastic resume: a data-parallel ``Supervisor`` run in a world of 2
  committing every 2 steps, killed on rank 1 at step 5 (``r1:kill@5``),
  is restarted by the launcher and its 6 losses equal an uninterrupted
  world-2 run's bit for bit;
* the registry: the ``paddle_partition_*``, ``paddle_collective_*`` and
  ``paddle_dist_*`` series names are the JAX package's (the port adds
  the comm layer's ``paddle_collective_comm_*``).
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch"]


def _plain_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    # one intra-op thread a rank: the ranks share the machine with
    # the other test workers, and the models are small
    env["OMP_NUM_THREADS"] = "1"
    return env


def _write(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


# -- the launcher --------------------------------------------------------------


def test_launcher_propagates_first_nonzero_exit(tmp_path):
    worker = _write(tmp_path, "w.py", """
        import os, sys, time
        if os.environ["PADDLE_TRAINER_ID"] == "1":
            sys.exit(7)
        time.sleep(120)
    """)
    t0 = time.time()
    proc = subprocess.run(
        LAUNCH + ["--nproc_per_node=2", "--started_port=0",
                  "--kill_grace_s=5", f"--run_dir={tmp_path / 'run'}",
                  worker],
        capture_output=True, text=True, timeout=60, env=_plain_env())
    assert proc.returncode == 7, (proc.returncode, proc.stderr[-1000:])
    assert time.time() - t0 < 45, "sibling was not torn down promptly"
    assert "rank 1 exited with code 7" in proc.stderr


def test_launcher_escalates_sigterm_to_sigkill(tmp_path):
    worker = _write(tmp_path, "w.py", """
        import os, signal, sys, time
        if os.environ["PADDLE_TRAINER_ID"] == "1":
            time.sleep(0.5)
            sys.exit(9)
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        print("armored", flush=True)
        time.sleep(300)
    """)
    t0 = time.time()
    proc = subprocess.run(
        LAUNCH + ["--nproc_per_node=2", "--started_port=0",
                  "--kill_grace_s=1.5", f"--run_dir={tmp_path / 'run'}",
                  worker],
        capture_output=True, text=True, timeout=60, env=_plain_env())
    assert proc.returncode == 9, (proc.returncode, proc.stderr[-1000:])
    assert "escalating to SIGKILL" in proc.stderr, proc.stderr[-1000:]
    assert time.time() - t0 < 40


def test_launcher_rank_prefixed_logs_and_child_env(tmp_path):
    worker = _write(tmp_path, "w.py", """
        import os
        e = os.environ
        print("hello from", e["PADDLE_TRAINER_ID"], e["PADDLE_DIST_BACKEND"],
              e["MASTER_ADDR"], e["MASTER_PORT"] ==
              e["PADDLE_TRAINER_ENDPOINTS"].split(",")[0].split(":")[1],
              e["FLAGS_selected_gpus"], flush=True)
    """)
    proc = subprocess.run(
        LAUNCH + ["--nproc_per_node=2", "--started_port=0",
                  "--backend=gloo", f"--run_dir={tmp_path / 'run'}",
                  worker],
        capture_output=True, text=True, timeout=60, env=_plain_env())
    assert proc.returncode == 0, proc.stderr[-1000:]
    assert "[rank 0] hello from 0 gloo 127.0.0.1 True 0" in proc.stderr
    assert "[rank 1] hello from 1 gloo 127.0.0.1 True 1" in proc.stderr


def test_launcher_elastic_restart_resumes_world(tmp_path):
    worker = _write(tmp_path, "w.py", """
        import json, os, sys, time
        gen = int(os.environ["PADDLE_RESTART_COUNT"])
        rank = os.environ["PADDLE_TRAINER_ID"]
        with open(os.environ["OUT_DIR"] + f"/g{gen}.r{rank}", "w") as f:
            json.dump({"endpoints":
                       os.environ["PADDLE_TRAINER_ENDPOINTS"]}, f)
        if gen == 0 and rank == "1":
            # fail only once rank 0 has written its record: the launcher
            # kills the world at this exit, and under load rank 0 may
            # not have started yet
            t0 = time.time()
            while (not os.path.exists(os.environ["OUT_DIR"] + "/g0.r0")
                   and time.time() - t0 < 20):
                time.sleep(0.05)
            sys.exit(43)
    """)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    env = _plain_env()
    env["OUT_DIR"] = str(out_dir)
    proc = subprocess.run(
        LAUNCH + ["--nproc_per_node=2", "--started_port=0",
                  "--max_restarts=2", "--kill_grace_s=2",
                  f"--run_dir={tmp_path / 'run'}", worker],
        capture_output=True, text=True, timeout=60, env=env)
    assert proc.returncode == 0, proc.stderr[-1500:]
    assert "restarting world (restart 1/2)" in proc.stderr
    assert "world completed after 1 restart(s)" in proc.stderr
    seen = sorted(p.name for p in out_dir.iterdir())
    assert "g0.r1" in seen and "g1.r0" in seen and "g1.r1" in seen
    g0 = json.loads((out_dir / "g0.r0").read_text())["endpoints"]
    g1 = json.loads((out_dir / "g1.r0").read_text())["endpoints"]
    assert g0 != g1


def test_launcher_detects_stale_heartbeat(tmp_path):
    worker = _write(tmp_path, "w.py", """
        import os, time
        hb = os.environ["PADDLE_HEARTBEAT_DIR"]
        os.makedirs(hb, exist_ok=True)
        rank = os.environ["PADDLE_TRAINER_ID"]
        with open(os.path.join(hb, "hb.rank" + rank), "w") as f:
            f.write(str(time.time()))
        time.sleep(300)
    """)
    t0 = time.time()
    proc = subprocess.run(
        LAUNCH + ["--nproc_per_node=2", "--started_port=0",
                  "--heartbeat_timeout_s=2", "--kill_grace_s=1",
                  f"--run_dir={tmp_path / 'run'}", worker],
        capture_output=True, text=True, timeout=60, env=_plain_env())
    assert proc.returncode == 75, (proc.returncode, proc.stderr[-1000:])
    assert "heartbeat stale" in proc.stderr
    assert time.time() - t0 < 45


# -- the coordinator alone -------------------------------------------------------


def test_coordinator_heartbeat_and_gauges(tmp_path):
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.distributed.coordinator import Coordinator

    c = Coordinator(0, 1, heartbeat_dir=str(tmp_path / "hb"),
                    heartbeat_interval_s=0.05)
    assert c.start_heartbeat()
    time.sleep(0.2)
    ages = c.heartbeat_ages()
    assert 0 in ages and ages[0] < 5.0
    assert c.live_ranks() == 1
    s = c.stats_numeric()
    assert s["world_size"] == 1 and s["heartbeats_total"] >= 1
    c.attach_progress(lambda: 1, stall_after_s=0.05)
    time.sleep(0.3)
    before = c.stats_numeric()["heartbeats_total"]
    time.sleep(0.3)
    assert c.stats_numeric()["heartbeats_total"] == before
    c.stop_heartbeat()
    assert c.barrier("x") == 0.0
    out = c.host_allreduce({"a": np.ones(3)}, tag="t")
    np.testing.assert_array_equal(out["a"], np.ones(3))
    text = observability.to_prometheus_text()
    assert "paddle_dist_world_size" in text
    assert "paddle_dist_barriers_total" in text
    assert isinstance(c.restartable_exit("x"), SystemExit)
    assert c.restartable_exit("x").code == 75


def test_coordinator_build_mesh_and_global_array():
    import torch

    from paddle_tpu_torch import partition
    from paddle_tpu_torch.distributed.coordinator import (Coordinator,
                                                          spans_processes)

    c = Coordinator(0, 1)
    mesh = c.build_mesh("dp=1")
    assert mesh.shape == {"dp": 1} and not spans_processes(mesh)
    with pytest.raises(ValueError, match="needs"):
        c.build_mesh("dp=1024")
    import paddle_tpu_torch as fl

    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        x = fl.layers.data("x", [8])
        y = fl.layers.data("y", [1])
        loss = fl.layers.mean(fl.layers.square_error_cost(
            fl.layers.fc(x, 4), y))
        fl.optimizer.SGD(0.1).minimize(loss)
    resolved = partition.PartitionConfig(mesh_axes={"dp": 1}).resolve(
        main, mesh=mesh)
    assert resolved.mesh_axes() == {"dp": 1}
    t = c.make_global_array(("dp", None), np.ones((4, 8), "float32"),
                            device="cpu")
    assert isinstance(t, torch.Tensor) and t.shape == (4, 8)
    with pytest.raises(ValueError, match="splits dim 1"):
        c.make_global_array((None, "dp"), np.ones((4, 8)), device="cpu")


# -- a world of 2: barriers, their timeout, the host all-reduce --------------------


def _coord_worker(out_dir):
    from paddle_tpu_torch import observability
    from paddle_tpu_torch.distributed import coordinator

    c = coordinator.initialize()
    out = {"rank": c.rank, "world": c.world_size}
    out["waited"] = c.barrier("a", timeout_s=30)
    r = c.host_allreduce({"v": np.full(3, c.rank + 0.5, "float32"),
                          "n": np.array([7 + c.rank])}, tag="t")
    out["mean"] = r["v"].tolist()
    out["n"] = r["n"].tolist()
    if c.rank == 0:
        t0 = time.time()
        try:
            c.barrier("b", timeout_s=1.0)
            out["timeout"] = None
        except coordinator.BarrierTimeout as e:
            out["timeout"] = str(e)
        out["timeout_s"] = time.time() - t0
    c.barrier("end", timeout_s=30)
    out["stats"] = c.stats_numeric()
    out["scrape"] = sorted({ln.split("{")[0] for ln in
                            observability.to_prometheus_text().splitlines()
                            if ln.startswith("paddle_dist_")})
    with open(os.path.join(out_dir, f"coord{c.rank}.json"), "w") as f:
        json.dump(out, f)


def test_coordinator_barrier_timeout_and_host_allreduce(tmp_path):
    from paddle_tpu_torch.parallel.env import free_port

    proc = subprocess.run(
        LAUNCH + ["--nproc_per_node=2", f"--started_port={free_port()}",
                  "--backend=gloo", f"--run_dir={tmp_path / 'run'}",
                  os.path.abspath(__file__), "--coord", str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=_plain_env(),
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r0 = json.loads((tmp_path / "coord0.json").read_text())
    r1 = json.loads((tmp_path / "coord1.json").read_text())
    assert r0["world"] == r1["world"] == 2
    assert r0["mean"] == r1["mean"] == [1.0, 1.0, 1.0]
    assert r0["n"] == r1["n"] == [7]          # non-float: rank 0's value
    assert "did not complete within 1s" in r0["timeout"]
    assert 0.9 < r0["timeout_s"] < 10
    assert r0["stats"]["barrier_timeouts_total"] == 1
    assert r1["stats"]["barriers_total"] >= 3
    for want in ("paddle_dist_world_size", "paddle_dist_rank",
                 "paddle_dist_barriers_total",
                 "paddle_dist_barrier_timeouts_total",
                 "paddle_dist_live_ranks"):
        assert want in r0["scrape"], want


# -- elastic resume of a data-parallel Supervisor --------------------------------


def _elastic_worker(out_dir, fault):
    import paddle_tpu_torch as fl
    from paddle_tpu_torch import resilience
    from paddle_tpu_torch.distributed import coordinator

    c = coordinator.initialize()
    # the fault is one-shot across the world's generations: a restarted
    # world runs clean
    fl.set_flags({"optimizer_fuse": "off",
                  "resilience_fault_spec": fault if c.restart_count == 0
                  else ""})
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 7
    with fl.program_guard(main, startup), fl.unique_name.guard():
        x = fl.layers.data("x", [16])
        y = fl.layers.data("y", [1], dtype="int64")
        h = fl.layers.dropout(fl.layers.fc(x, 32, act="relu"), 0.2)
        loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(
            fl.layers.fc(h, 4), y))
        fl.optimizer.Adam(5e-3).minimize(loss)
    from paddle_tpu_torch.parallel.sharding import shard_optimizer_states

    shard_optimizer_states(main, c.world_size)
    scope = fl.Scope()
    exe = fl.Executor(fl.CPUPlace())
    exe.run(startup, scope=scope)
    prog = fl.CompiledProgram(main).with_data_parallel(loss_name=loss.name)

    def feed(step):
        rng = np.random.RandomState(1000 + step)
        b = {"x": rng.randn(16, 16).astype("float32"),
             "y": rng.randint(0, 4, (16, 1)).astype("int64")}
        return {k: v[c.rank * 8:(c.rank + 1) * 8] for k, v in b.items()}

    log = os.path.join(out_dir, f"loss.g{c.restart_count}.r{c.rank}")

    def on_step(step, fetched):
        with open(log, "a") as f:
            f.write(json.dumps([step, float(np.asarray(fetched[0]))]) + "\n")

    ck = os.path.join(out_dir, "ck")
    sup = resilience.Supervisor(
        exe, prog, ck, feed_fn=feed, fetch_list=[loss], scope=scope,
        policy=resilience.CheckpointPolicy(ck, every_steps=2, keep_last=3),
        on_step=on_step)
    sup.run_loop(6)


def _elastic_losses(out_dir, rank):
    losses = {}
    for gen in range(3):
        p = os.path.join(out_dir, f"loss.g{gen}.r{rank}")
        if not os.path.exists(p):
            continue
        for line in open(p):
            step, val = json.loads(line)
            losses[step] = val
    return [losses[s] for s in sorted(losses)]


def test_elastic_restart_resumes_a_supervised_world_bit_for_bit(tmp_path):
    from paddle_tpu_torch.parallel.env import free_port

    runs = {}
    for name, fault, restarts in (("clean", "", 0),
                                  ("killed", "r1:kill@5", 1)):
        d = tmp_path / name
        d.mkdir()
        proc = subprocess.run(
            LAUNCH + ["--nproc_per_node=2", f"--started_port={free_port()}",
                      "--backend=gloo", f"--max_restarts={restarts}",
                      "--kill_grace_s=5", f"--run_dir={d / 'run'}",
                      os.path.abspath(__file__), "--elastic", str(d), fault],
            capture_output=True, text=True, timeout=240, env=_plain_env(),
            cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs[name] = (d, proc.stderr)
    d, err = runs["killed"]
    assert "rank 1 exited with code 43" in err
    assert "world completed after 1 restart(s)" in err
    assert os.path.exists(d / "loss.g1.r1")
    for rank in (0, 1):
        clean = _elastic_losses(str(runs["clean"][0]), rank)
        killed = _elastic_losses(str(d), rank)
        assert len(clean) == len(killed) == 6
        assert clean == killed, (rank, clean, killed)


# -- the registry families ----------------------------------------------------------


def test_distribution_series_names_are_the_jax_packages():
    import paddle_tpu as jf
    import paddle_tpu_torch as fl
    from paddle_tpu import observability as jobs
    from paddle_tpu import partition as jpart
    from paddle_tpu.distributed.coordinator import Coordinator as JCoord
    from paddle_tpu.parallel import collectives as jcoll
    from paddle_tpu.parallel.mesh import make_mesh as jmesh
    from paddle_tpu_torch import observability as tobs
    from paddle_tpu_torch import partition as tpart
    from paddle_tpu_torch.distributed.coordinator import Coordinator
    from paddle_tpu_torch.parallel import collectives as tcoll

    keep = []
    for pkg, part, coll, coord, mesh in (
            (jf, jpart, jcoll, JCoord, jmesh({"dp": 1})),
            (fl, tpart, tcoll, Coordinator, {"dp": 1})):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", [8])
            y = pkg.layers.data("y", [1])
            loss = pkg.layers.mean(pkg.layers.square_error_cost(
                pkg.layers.fc(x, 4), y))
            pkg.optimizer.Adam(0.1).minimize(loss)
        keep.append(part.PartitionConfig(mesh_axes={"dp": 1}).resolve(
            main, mesh=mesh))
        keep.append(coll.ensure_planned(main, bucket_mb=1.0))
        keep.append(coord(0, 1))

    def names(obs):
        return {ln.split("{")[0] for ln in obs.to_prometheus_text()
                .splitlines() if ln.startswith(("paddle_partition_",
                                                "paddle_collective_",
                                                "paddle_dist_"))}

    jn, tn = names(jobs), names(tobs)
    assert jn and jn <= tn, sorted(jn - tn)
    assert all(n.startswith("paddle_collective_comm_") for n in tn - jn), \
        sorted(tn - jn)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if len(sys.argv) == 3 and sys.argv[1] == "--coord":
        _coord_worker(sys.argv[2])
    elif len(sys.argv) in (3, 4) and sys.argv[1] == "--elastic":
        _elastic_worker(sys.argv[2], sys.argv[3] if len(sys.argv) == 4
                        else "")
