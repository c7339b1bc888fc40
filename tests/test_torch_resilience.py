"""The port's supervised training (``paddle_tpu_torch.resilience``) on
the CPU: twins of the single-process tests of tests/test_resilience.py
(the reader-position round trip is in ``tests/test_torch_reader.py``;
the atomic-rename test with its ``HDFSClient`` line).

The model is the twin of tools/chaos_train.py's: a small MLP with
dropout under Adam, whose dropout masks come from each op's generator
seeded by the Executor's run counter, so a resumed or rolled-back
trajectory equals an uninterrupted one bit for bit only if the run
counter round-trips through the commit marker. Feeds derive from the
step index. Trajectories are held bit for bit (port against port);
what the two packages share by construction is held to the JAX package:
the fault-spec grammar, and which checkpoint steps a run commits.

The kill-and-resume test runs this file as a script in fresh processes
(``python tests/test_torch_resilience.py --steps ... --loss-out F``).
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import io, resilience
from paddle_tpu_torch.fs import LocalFS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_model(seed=41):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [12])
        y = fluid.layers.data("y", [1], dtype="int64")
        h = fluid.layers.fc(x, 32, act="relu")
        h = fluid.layers.dropout(h, dropout_prob=0.1)  # draws every step
        logits = fluid.layers.fc(h, 4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Adam(5e-3).minimize(loss)
    return main, startup, loss


def feed_fn(step, batch=8):
    """The feed of any step index (re-runnable after rollback/resume)."""
    rng = np.random.RandomState(10_000 + step)
    x = rng.randn(batch, 12).astype("float32")
    y = (np.abs(x).sum(1, keepdims=True) > 9.5).astype("int64") \
        + (x[:, :1] > 0).astype("int64")
    return {"x": x, "y": y}


def _executor():
    return fluid.Executor(fluid.CPUPlace())


def run_supervised(steps, ckpt_dir, ckpt_every=8, keep_last=3, fault="",
                   watchdog_s=0.0, final_checkpoint=True, seed=41):
    """One supervised run; returns (losses by step, stats)."""
    main, startup, loss = build_model(seed)
    scope = fluid.Scope()
    losses = {}
    with fluid.scope_guard(scope):
        exe = _executor()
        exe.run(startup)
        sup = resilience.Supervisor(
            exe, main, checkpoint_dir=str(ckpt_dir), feed_fn=feed_fn,
            fetch_list=[loss],
            policy=resilience.CheckpointPolicy(
                str(ckpt_dir), every_steps=ckpt_every, keep_last=keep_last),
            watchdog_timeout_s=watchdog_s,
            fault_injector=resilience.FaultInjector(fault),
            on_step=lambda s, f: losses.__setitem__(
                s, float(np.asarray(f[0]))))
        stats = sup.run_loop(steps, final_checkpoint=final_checkpoint)
    return losses, stats


_run = run_supervised


# -- atomic commit / corrupt-checkpoint handling ----------------------------


def test_latest_checkpoint_skips_uncommitted_and_truncated(tmp_path):
    ck = str(tmp_path / "ck")
    _run(8, ck, ckpt_every=2, keep_last=10)
    committed = io.committed_checkpoint_steps(ck)
    assert committed == [2, 4, 6, 8], committed

    # a crash mid-save: numeric dir with data but NO commit marker
    fake = os.path.join(ck, "12")
    os.makedirs(fake)
    with open(os.path.join(fake, "__shards__.rank0.npz"), "w") as f:
        f.write("partial write")
    assert io.latest_checkpoint(ck) == 8

    # truncation AFTER commit: manifest sizes no longer match
    victim = os.path.join(ck, "8")
    marker = io.read_commit_marker(victim)
    rel = sorted(marker["manifest"])[-1]
    path = os.path.join(victim, rel)
    with open(path, "r+b") as f:
        f.truncate(max(0, os.path.getsize(path) - 1))
    assert not io.is_committed_checkpoint(victim)
    assert io.latest_checkpoint(ck) == 6

    # a deleted manifest file is also detected
    victim = os.path.join(ck, "6")
    marker = io.read_commit_marker(victim)
    os.remove(os.path.join(victim, sorted(marker["manifest"])[0]))
    assert io.latest_checkpoint(ck) == 4

    # load_checkpoint refuses the corrupt dir with a clear error
    with pytest.raises(ValueError, match="uncommitted or corrupt"):
        io.load_checkpoint(ck, main_program=fluid.Program(), step=6,
                           device="cpu")


def test_resume_skips_corrupt_dir_end_to_end(tmp_path):
    """Kill -> truncate the newest commit -> resume must pick the
    previous one and still complete."""
    ck = str(tmp_path / "ck")
    _run(9, ck, ckpt_every=3, keep_last=10, final_checkpoint=False)
    latest = io.latest_checkpoint(ck)
    assert latest in (6, 9)
    victim = os.path.join(ck, str(latest))
    marker = io.read_commit_marker(victim)
    rel = sorted(marker["manifest"])[-1]
    with open(os.path.join(victim, rel), "r+b") as f:
        f.truncate(0)
    losses, stats = _run(12, ck, ckpt_every=3)
    assert stats["resumed_from"] == latest - 3
    assert stats["steps_completed"] == 12 - (latest - 3)


def test_atomic_rename_local(tmp_path):
    fs = LocalFS()
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    os.makedirs(src)
    with open(os.path.join(src, "f"), "w") as f:
        f.write("new")
    # dst exists non-empty: plain os.replace would raise ENOTEMPTY
    os.makedirs(dst)
    with open(os.path.join(dst, "stale"), "w") as f:
        f.write("old")
    fs.atomic_rename(src, dst)
    assert sorted(os.listdir(dst)) == ["f"]
    assert not os.path.exists(src)
    with pytest.raises(Exception):
        fs.atomic_rename(str(tmp_path / "missing"), dst)
    assert fs.ls_dir(str(tmp_path)) == (["dst"], [])
    from paddle_tpu_torch.fs import HDFSClient

    with pytest.raises(NotImplementedError, match="LocalFS staging"):
        HDFSClient(hadoop_home="/nonexistent").atomic_rename("a", "b")


# -- fault spec -------------------------------------------------------------


def test_fault_spec_parse_and_one_shot():
    from paddle_tpu.resilience import FaultSpec as JaxFaultSpec

    text = "raise@3, nan@5, hang@7:0.01, kill@9, r2:killsave@4"
    spec = resilience.FaultSpec.parse(text)
    assert spec.actions == JaxFaultSpec.parse(text).actions
    assert [(a[0], a[1]) for a in spec.actions] == [
        ("raise", 3), ("nan", 5), ("hang", 7), ("kill", 9), ("killsave", 4)]
    inj = resilience.FaultInjector(
        resilience.FaultSpec([("raise", 3, None)]))
    with pytest.raises(resilience.InjectedFault):
        inj.before_step(3)
    inj.before_step(3)  # one-shot: second pass is clean
    assert inj.fired() == [("raise", 3)]
    # an explicit :0 arg means a ~0s hang, not the hang-forever default
    inj0 = resilience.FaultInjector("hang@1:0")
    t0 = time.time()
    inj0.before_step(1)
    assert time.time() - t0 < 5.0
    assert inj0.fired() == [("hang", 1)]
    with pytest.raises(ValueError, match="fault"):
        resilience.FaultSpec.parse("explode@3")
    with pytest.raises(ValueError, match="bad fault spec"):
        resilience.FaultSpec.parse("raise3")


# -- supervisor lifecycle ---------------------------------------------------


def test_retry_then_success_and_stats(tmp_path):
    losses, stats = _run(10, tmp_path / "ck", ckpt_every=4,
                         fault="raise@5")
    assert stats["retries"] == 1
    assert stats["rollbacks"] == 0
    assert stats["steps_completed"] == 10
    assert stats["faults_injected"] == 1
    assert sorted(losses) == list(range(10))
    ref, _ = _run(10, tmp_path / "ref", ckpt_every=4)
    assert losses == ref


def test_retry_budget_exhausts(tmp_path):
    with pytest.raises(resilience.InjectedFault):
        _run(10, tmp_path / "ck", ckpt_every=4,
             fault="raise@5,raise@5,raise@5,raise@5,raise@5,raise@5")


def _supervisor(ck, scope_exe_main, **kw):
    exe, main, loss = scope_exe_main
    policy = kw.pop("policy", None) or resilience.CheckpointPolicy(
        ck, every_steps=4, keep_last=3)
    return resilience.Supervisor(exe, main, checkpoint_dir=ck,
                                 feed_fn=feed_fn, fetch_list=[loss],
                                 policy=policy, **kw)


def test_nan_rollback_fires_hook_and_recovers(tmp_path):
    ck = str(tmp_path / "ck")
    nan_seen = []
    main, startup, loss = build_model()
    scope = fluid.Scope()
    losses = {}
    with fluid.scope_guard(scope):
        exe = _executor()
        exe.run(startup)
        sup = _supervisor(
            ck, (exe, main, loss),
            fault_injector=resilience.FaultInjector("nan@6"),
            on_nan=lambda step, val: nan_seen.append((step, val)),
            on_step=lambda s, f: losses.__setitem__(
                s, float(np.asarray(f[0]))))
        stats = sup.run_loop(10)
    assert nan_seen and nan_seen[0][0] == 6 and np.isnan(nan_seen[0][1])
    assert stats["nan_events"] == 1
    assert stats["rollbacks"] == 1
    assert stats["steps_completed"] == 10 + (6 - 4)  # replayed 4, 5
    assert all(np.isfinite(v) for v in losses.values())
    assert stats["flight_dumps"] and os.path.isfile(stats["flight_dumps"][0])
    # the rolled-back trajectory equals a clean run bit for bit (state
    # AND run counter restored from the step-4 commit)
    ref, _ = _run(10, tmp_path / "ref", ckpt_every=4)
    assert losses == ref


def test_nan_without_checkpoint_raises(tmp_path):
    with pytest.raises(resilience.NonFiniteLossError, match="no committed"):
        _run(10, tmp_path / "ck", ckpt_every=0, fault="nan@1",
             final_checkpoint=False)


# The watchdog tests' timeouts sit well above an eager CPU step of the
# model (tens of ms; the process's first backward imports sympy, about
# 1 s) and their hangs well above the timeouts, so that only the
# injected hang trips the watchdog on a loaded machine.
def test_hang_trips_watchdog_then_recovers(tmp_path):
    losses, stats = _run(8, tmp_path / "ck", ckpt_every=4,
                         fault="hang@5:30", watchdog_s=2.0)
    assert stats["watchdog_fires"] == 1
    assert stats["retries"] == 1  # the watchdog timeout fed the retry path
    assert stats["steps_completed"] == 8
    assert sorted(losses) == list(range(8))
    ref, _ = _run(8, tmp_path / "ref", ckpt_every=4)
    assert losses == ref


def test_zombie_step_detected_and_rolled_back(tmp_path):
    """A watchdog-abandoned step that later completes (mutating scope
    and run counter behind the retry's back) is detected and rolled
    back; the recovered trajectory still equals a clean run."""
    ck = str(tmp_path / "ck")
    main, startup, loss = build_model()
    scope = fluid.Scope()
    losses = {}
    with fluid.scope_guard(scope):
        exe = _executor()
        exe.run(startup)
        real_run = exe.run
        hang = {"armed": True}

        def slow_run(*a, **kw):
            if hang["armed"] and sup._stats["steps_completed"] >= 5:
                hang["armed"] = False
                time.sleep(3.0)  # a hang INSIDE the step, then completes
            return real_run(*a, **kw)

        sup = _supervisor(
            ck, (exe, main, loss), watchdog_timeout_s=1.5,
            # slow the loop so it is still running when the zombie wakes
            on_step=lambda s, f: (
                losses.__setitem__(s, float(np.asarray(f[0]))),
                time.sleep(0.35)))
        exe.run = slow_run
        stats = sup.run_loop(16)
    assert stats["watchdog_fires"] == 1
    assert stats["zombie_steps"] == 1
    assert stats["rollbacks"] >= 1
    assert stats["steps_completed"] >= 16
    ref, _ = _run(16, tmp_path / "ref", ckpt_every=4)
    assert losses == ref, "zombie corruption leaked into the trajectory"


def test_cancelled_hang_is_not_a_zombie(tmp_path):
    """An abandoned attempt that wakes from its injected hang after the
    cancellation parks before exe.run: no spurious rollback."""
    ck = str(tmp_path / "ck")
    main, startup, loss = build_model()
    scope = fluid.Scope()
    losses = {}
    with fluid.scope_guard(scope):
        exe = _executor()
        exe.run(startup)
        sup = _supervisor(
            ck, (exe, main, loss), watchdog_timeout_s=1.5,
            fault_injector=resilience.FaultInjector("hang@2:4.0"),
            # keep the loop alive past the hang's wake-up at ~4.0s
            on_step=lambda s, f: (
                losses.__setitem__(s, float(np.asarray(f[0]))),
                time.sleep(0.6)))
        stats = sup.run_loop(10)
    assert stats["watchdog_fires"] == 1
    assert stats["zombie_steps"] == 0
    assert stats["rollbacks"] == 0
    assert stats["steps_completed"] == 10
    ref, _ = _run(10, tmp_path / "ref", ckpt_every=4)
    assert losses == ref


def test_async_save_handle_waits_for_commit(tmp_path):
    ck = str(tmp_path / "ck")
    main, startup, loss = build_model()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = _executor()
        exe.run(startup)
        want = {n: scope.get_numpy(n) for n in scope.local_var_names()}
        h = io.save_checkpoint(ck, main_program=main, scope=scope, step=3,
                               async_save=True, extra={"run_counter": 7})
        # the values were copied on this thread: later writes to the
        # scope do not reach the checkpoint
        for n in scope.local_var_names():
            scope.find_var(n).zero_()
        h.wait_until_finished()  # must cover the COMMIT, not just data
    path = os.path.join(ck, "3")
    marker = io.read_commit_marker(path)
    assert marker is not None and marker["extra"]["run_counter"] == 7
    assert io.is_committed_checkpoint(path)
    got = io.load_checkpoint_arrays(path)
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_policy_save_same_step_is_idempotent(tmp_path):
    """Re-committing a step that already has a committed dir (a
    post-rollback replay re-reaching a cadence point) skips the publish."""
    ck = str(tmp_path / "ck")
    main, startup, loss = build_model()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = _executor()
        exe.run(startup)
        pol = resilience.CheckpointPolicy(ck, every_steps=4, keep_last=3)
        first = pol.save(5, main_program=main, scope=scope)
        mtime = os.path.getmtime(os.path.join(first, io._COMMIT_MARKER))
        again = pol.save(5, main_program=main, scope=scope)
    assert again == first
    assert os.path.getmtime(os.path.join(first, io._COMMIT_MARKER)) == mtime


def test_fresh_run_never_adopts_foreign_commits(tmp_path):
    """A fresh run (resume=False) in a dir holding a previous run's
    commits neither rolls back into them nor skips publishing over them."""
    ck = str(tmp_path / "ck")
    _run(8, ck, ckpt_every=4)  # run A (seed 41): commits 4 and 8
    marker_a = io.read_commit_marker(os.path.join(ck, "4"))

    def fresh_run(fault=""):
        main, startup, loss = build_model(seed=99)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = _executor()
            exe.run(startup)
            sup = _supervisor(ck, (exe, main, loss),
                              fault_injector=resilience.FaultInjector(fault))
            return sup.run_loop(8, resume=False, final_checkpoint=False)

    with pytest.raises(resilience.NonFiniteLossError, match="no committed"):
        fresh_run(fault="nan@2")
    fresh_run()
    marker_b = io.read_commit_marker(os.path.join(ck, "4"))
    assert marker_b["extra"]["random_seed"] == 99
    assert marker_b["extra"] != marker_a["extra"]


def test_gc_never_drops_own_latest_commit(tmp_path):
    ck = str(tmp_path / "ck")
    _run(12, ck, ckpt_every=4, keep_last=10)  # foreign commits: 4, 8, 12
    main, startup, loss = build_model(seed=99)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = _executor()
        exe.run(startup)
        pol = resilience.CheckpointPolicy(ck, every_steps=4, keep_last=3)
        own = pol.save(2, main_program=main, scope=scope)
    assert io.is_committed_checkpoint(own)
    assert 2 in io.committed_checkpoint_steps(ck)


def test_retention_gc_keeps_exactly_keep_last(tmp_path):
    ck = str(tmp_path / "ck")
    _run(20, ck, ckpt_every=2, keep_last=3, final_checkpoint=False)
    assert io.committed_checkpoint_steps(ck) == [16, 18, 20]
    numeric = [d for d in os.listdir(ck) if d.isdigit()]
    assert sorted(int(d) for d in numeric) == [16, 18, 20]
    debris = os.path.join(ck, ".staging.99.1")
    aside = os.path.join(ck, "7.old.1")  # atomic_rename aside, stranded
    os.makedirs(debris)
    os.makedirs(aside)
    pol = resilience.CheckpointPolicy(ck, every_steps=2, keep_last=3)
    pol.gc()
    assert os.path.exists(debris), "fresh foreign staging must survive gc"
    old = time.time() - 3600
    os.utime(debris, (old, old))
    os.utime(aside, (old, old))
    pol.gc()
    assert not os.path.exists(debris)
    assert not os.path.exists(aside)


def test_sigterm_flushes_final_checkpoint(tmp_path):
    ck = str(tmp_path / "ck")
    main, startup, loss = build_model()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = _executor()
        exe.run(startup)
        sup = _supervisor(ck, (exe, main, loss),
                          policy=resilience.CheckpointPolicy(
                              ck, every_steps=0, keep_last=2))
        timer = threading.Timer(
            1.0, lambda: os.kill(os.getpid(), signal.SIGTERM))
        timer.start()
        try:
            stats = sup.run_loop(10_000_000)
        finally:
            timer.cancel()
    assert stats["preempted"]
    assert 0 < stats["steps_completed"] < 10_000_000
    assert io.latest_checkpoint(ck) == stats["steps_completed"]
    losses, stats2 = _run(stats["steps_completed"] + 3, ck, ckpt_every=0)
    assert stats2["resumed_from"] == stats["steps_completed"]
    assert stats2["steps_completed"] == 3


def test_committed_steps_match_jax_cadence(tmp_path):
    """The same cadence, retention and budget commit the same steps in
    both packages (the policy is one algorithm)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import chaos_train

    for every, keep, steps in ((3, 2, 10), (4, 10, 9)):
        jck, tck = tmp_path / f"j{every}", tmp_path / f"t{every}"
        chaos_train.run_supervised(steps, str(jck), ckpt_every=every,
                                   keep_last=keep)
        _run(steps, tck, ckpt_every=every, keep_last=keep)
        from paddle_tpu import io as jio

        assert io.committed_checkpoint_steps(str(tck)) == \
            jio.committed_checkpoint_steps(str(jck))


# -- the headline: kill -> auto-resume, bitwise across processes ------------


def spawn_run(tmp, name, steps, ckpt_dir, ckpt_every, fault=""):
    """Run this file as a CPU child process; returns (CompletedProcess,
    losses JSON or None)."""
    loss_out = os.path.join(str(tmp), f"{name}.json")
    cmd = [sys.executable, os.path.abspath(__file__), "--steps", str(steps),
           "--ckpt-dir", str(ckpt_dir), "--ckpt-every", str(ckpt_every),
           "--loss-out", loss_out]
    if fault:
        cmd += ["--fault", fault]
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=env, cwd=REPO)
    data = None
    if os.path.exists(loss_out):
        with open(loss_out) as f:
            data = json.load(f)
    return proc, data


def test_kill_then_auto_resume_bitwise_identical(tmp_path):
    """A supervised run hard-killed (os._exit) at step 8 resumes in a
    fresh process from the last committed checkpoint and reproduces the
    uninterrupted run's losses bit for bit: dropout draws every step, so
    this proves the run counter round-trips through the marker."""
    steps, every, kill_at = 12, 3, 8
    ck = tmp_path / "ck"
    ref_proc, ref = spawn_run(tmp_path, "ref", steps, tmp_path / "ref_ck",
                              every)
    assert ref_proc.returncode == 0, ref_proc.stderr[-2000:]
    kill_proc, _ = spawn_run(tmp_path, "killed", steps, ck, every,
                             fault=f"kill@{kill_at}")
    assert kill_proc.returncode == resilience.KILL_EXIT_CODE, (
        kill_proc.returncode, kill_proc.stderr[-2000:])
    assert io.latest_checkpoint(str(ck)) == 6
    res_proc, res = spawn_run(tmp_path, "resumed", steps, ck, every)
    assert res_proc.returncode == 0, res_proc.stderr[-2000:]
    assert res["stats"]["resumed_from"] == 6
    mismatch = {s: (v, ref["losses"][s]) for s, v in res["losses"].items()
                if ref["losses"][s] != v}
    assert not mismatch, f"resumed trajectory diverged: {mismatch}"
    assert sorted(int(s) for s in res["losses"]) == list(range(6, steps))
    assert io.latest_checkpoint(str(ck)) == steps  # final flush committed


def _child(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--ckpt-every", type=int, default=8)
    ap.add_argument("--fault", default="")
    ap.add_argument("--loss-out", required=True)
    args = ap.parse_args(argv)
    losses, stats = run_supervised(args.steps, args.ckpt_dir,
                                   ckpt_every=args.ckpt_every,
                                   fault=args.fault)
    with open(args.loss_out, "w") as f:
        json.dump({"losses": {str(s): v for s, v in losses.items()},
                   "stats": stats}, f)
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1:]))
