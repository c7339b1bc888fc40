"""The port's committed checkpoints (``paddle_tpu_torch.io``, A13b)
against the JAX package, on the CPU.

(a) Twins of the checkpoint tests of tests/test_multihost.py:41-175: the
    two-phase commit of two ranks (threads, ``_save_checkpoint_multihost``
    with an explicit rank and world, as ``_FORCE_DIST`` gives them to
    ``save_checkpoint``), a rank that never finishes, stale done-files, a
    missing shard file, and the strict mesh check; and of
    tests/test_misc.py:218 (a sync and an async save, ``latest_checkpoint``,
    an exact restore).
(b) Across the packages: the port always writes the ``__shards__``
    layout, which the JAX package's ``load_checkpoint`` reads; the port
    reads a JAX multi-host save (and its offset-keyed shards of a
    sharded array), and refuses JAX's orbax layout with a ``ValueError``
    that names it. A tiny Lamb + ``polynomial_decay`` program saved
    mid-run by the port continues in JAX and in the port, and from a
    JAX multi-host save in the port: every trajectory agrees with JAX's
    uninterrupted run at ``TRAIN_RTOL`` / ``TRAIN_ATOL`` (the two
    packages sum in other orders), the learning rate included.
"""

import json
import os
import threading

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import io as jio
from paddle_tpu.core.framework import unique_name as jax_unique_name

import paddle_tpu_torch as fluid
from paddle_tpu_torch import io
from paddle_tpu_torch.io import load_scope_arrays
from paddle_tpu_torch.resilience import FaultInjector, FaultSpec
from paddle_tpu_torch.resilience import faults as faults_mod

TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5


def _state():
    return {"w": np.arange(12.0, dtype=np.float32).reshape(3, 4),
            "b": np.ones(3, np.float32),
            "step_i": np.asarray([7], np.int32)}


def _save_ranks(path, state, extra, nonce, world=2):
    errs = []

    def rank_save(rank):
        try:
            io._save_checkpoint_multihost(path, dict(state), dict(extra),
                                          rank, world, timeout_s=20,
                                          nonce=nonce)
        except Exception as e:  # noqa: BLE001
            errs.append((rank, e))

    threads = [threading.Thread(target=rank_save, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert not errs, errs


# -- (a) the two-phase commit ------------------------------------------------


def test_two_phase_commit_all_ranks(tmp_path):
    """Both ranks save concurrently; the marker lands only after every
    shard-done file; the assembled restore round-trips bit for bit, in
    both packages."""
    path = str(tmp_path / "ck" / "7")
    state = _state()
    _save_ranks(path, state, {"step": 7, "run_counter": 3}, "attempt1")
    assert io.is_committed_checkpoint(path)
    marker = io.read_commit_marker(path)
    assert marker["extra"]["world"] == 2
    assert marker["extra"]["step"] == 7
    for got in (io.load_checkpoint_arrays(path),
                jio.load_checkpoint_arrays(path)):
        assert sorted(got) == sorted(state)
        for k, v in state.items():
            np.testing.assert_array_equal(got[k], v)
    rels = set(marker["manifest"])
    assert {"__shards__.rank0.npz", "__shards__.rank1.npz",
            "_PT_SHARD_DONE.0", "_PT_SHARD_DONE.1"} <= rels


def test_two_phase_commit_missing_rank_never_commits(tmp_path):
    path = str(tmp_path / "ck" / "3")
    with pytest.raises(io.CheckpointCommitTimeout) as ei:
        io._save_checkpoint_multihost(path, _state(), {"step": 3}, 0, 2,
                                      timeout_s=0.3, nonce="attempt1")
    assert "rank(s) [1]" in str(ei.value)
    assert not io.is_committed_checkpoint(path)
    assert io.read_commit_marker(path) is None
    # rank 1's done-file landing later completes the attempt
    io.write_shard_done(path, 1, "attempt1")
    io.finalize_two_phase_commit(path, 2, extra={"step": 3},
                                 nonce="attempt1", timeout_s=1.0)
    assert io.is_committed_checkpoint(path)


def test_stale_done_files_do_not_satisfy_new_attempt(tmp_path):
    path = str(tmp_path / "ck" / "5")
    os.makedirs(path)
    io.write_shard_done(path, 0, "old")
    io.write_shard_done(path, 1, "old")
    assert io.done_shard_ranks(path, 2, "new") == []
    with pytest.raises(io.CheckpointCommitTimeout):
        io.finalize_two_phase_commit(path, 2, nonce="new", timeout_s=0.2)


def test_multihost_restore_detects_missing_shard_file(tmp_path):
    path = str(tmp_path / "ck" / "9")
    _save_ranks(path, _state(), {"step": 9}, "a1")
    os.remove(os.path.join(path, "__shards__.rank1.npz"))
    with pytest.raises(ValueError, match="missing"):
        io.load_checkpoint_arrays(path)


def test_force_dist_routes_save_checkpoint(tmp_path, monkeypatch):
    """``_FORCE_DIST`` gives ``save_checkpoint`` its (rank, world): as
    rank 0 of 2 it writes its half and waits for rank 1's done-file."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fluid.layers.fc(fluid.layers.data("x", [4]), 3)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    monkeypatch.setattr(io, "_FORCE_DIST", (0, 2))
    monkeypatch.setattr(
        "paddle_tpu_torch.io.flag",
        lambda name: 0.3 if name == "dist_commit_timeout_s" else None)
    with pytest.raises(io.CheckpointCommitTimeout, match=r"rank\(s\) \[1\]"):
        io.save_checkpoint(str(tmp_path / "ck"), main, scope, step=2)
    meta = json.load(open(tmp_path / "ck" / "2" / "__shards__.meta.json"))
    assert meta["world"] == 2
    assert sorted(meta["vars"]) == ["fc_0.b_0", "fc_0.w_0"]
    assert {v["owner"] for v in meta["vars"].values()} == {0, 1}


def _committed_single(tmp_path, extra):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4])
        fluid.layers.fc(x, 3)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        io.save_checkpoint(str(tmp_path / "ck"), main_program=main,
                           scope=scope, step=4, extra=extra)
    return main, str(tmp_path / "ck")


def test_load_checkpoint_refuses_foreign_mesh(tmp_path):
    main, ck = _committed_single(tmp_path, {"step": 4, "mesh": {"dp": 4}})
    with pytest.raises(ValueError) as ei:
        io.load_checkpoint(ck, main_program=main, scope=fluid.Scope(),
                           step=4, mesh={"dp": 2}, device="cpu")
    msg = str(ei.value)
    assert "'dp': 4" in msg and "'dp': 2" in msg, msg
    # the same shape passes; no mesh stays elastic
    io.load_checkpoint(ck, main_program=main, scope=fluid.Scope(), step=4,
                       mesh={"dp": 4}, device="cpu")
    io.load_checkpoint(ck, main_program=main, scope=fluid.Scope(), step=4,
                       device="cpu")


def test_fault_spec_rank_scoping():
    spec = FaultSpec.parse("r2:kill@7,nan@3,r0:raise@5")
    assert spec.actions == [("kill", 7, None, 2), ("nan", 3, None, None),
                            ("raise", 5, None, 0)]
    fi = FaultInjector("r2:kill@7,nan@3,r0:raise@5", rank=1)
    assert [a[:2] for a in fi.spec.actions] == [("nan", 3)]
    fi2 = FaultInjector("r2:kill@7,nan@3,r0:raise@5", rank=2)
    assert sorted(a[0] for a in fi2.spec.actions) == ["kill", "nan"]
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec.parse("explode@3")
    with pytest.raises(ValueError, match="bad fault spec entry"):
        FaultSpec.parse("kill@x")


def test_killsave_arms_save_kill_hook():
    fi = FaultInjector("killsave@2", rank=0)
    fi.before_step(1)
    assert not faults_mod._SAVE_KILL_ARMED["on"]
    fi.before_step(2)
    assert faults_mod._SAVE_KILL_ARMED["on"]
    faults_mod._SAVE_KILL_ARMED["on"] = False


def test_checkpoint_roundtrip_sync_async_latest(tmp_path):
    """Twin of test_orbax_sharded_checkpoint_roundtrip: an exact
    persistable round trip, step dirs, the resume helper, async save."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4])
        y = fluid.layers.data("y", [1])
        loss = fluid.layers.mean(fluid.layers.square(
            fluid.layers.elementwise_sub(fluid.layers.fc(x, 1), y)))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        for _ in range(3):
            exe.run(main, feed={"x": np.ones((4, 4), "float32"),
                                "y": np.zeros((4, 1), "float32")},
                    fetch_list=[loss])
        saved = {n: scope.get_numpy(n) for n in scope.local_var_names()}
        assert io.save_checkpoint(str(tmp_path / "ck"), main, scope,
                                  step=3) is None
        h = io.save_checkpoint(str(tmp_path / "ck"), main, scope, step=7,
                               async_save=True)
        h.wait_until_finished()
    assert io.latest_checkpoint(str(tmp_path / "ck")) == 7
    assert io.committed_checkpoint_steps(str(tmp_path / "ck")) == [3, 7]
    scope2 = fluid.Scope()
    names = io.load_checkpoint(str(tmp_path / "ck"), main, scope2, step=3,
                               device="cpu")
    assert len(names) == len(saved)
    for n in names:
        np.testing.assert_array_equal(scope2.get_numpy(n), saved[n],
                                      err_msg=n)
        assert str(scope2.find_var(n).dtype).endswith(
            main.global_block().var(n).dtype)


# -- (b) across the packages --------------------------------------------------


def _names(pkg):
    return jax_unique_name if pkg is jfluid else fluid.unique_name


def _lamb_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 6
    with pkg.program_guard(main, startup), _names(pkg).guard():
        x = pkg.layers.data("x", [8])
        y = pkg.layers.data("y", [1], dtype="int64")
        logits = pkg.layers.fc(pkg.layers.fc(x, 16, act="relu"), 4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        lr = pkg.layers.polynomial_decay(0.05, 6, end_learning_rate=0.001,
                                         power=1.0)
        pkg.optimizer.LambOptimizer(lr).minimize(loss)
    return main, startup, loss, lr


def _feed(step):
    rng = np.random.RandomState(100 + step)
    return {"x": rng.randn(16, 8).astype("float32"),
            "y": rng.randint(0, 4, (16, 1)).astype("int64")}


def _persistables(main):
    return sorted(v.name for v in main.list_vars()
                  if v.persistable and not v.is_data)


def _jax_steps(main, loss, lr, scope, steps):
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        return [tuple(float(np.asarray(v).reshape(-1)[0]) for v in
                      exe.run(main, feed=_feed(s), fetch_list=[loss, lr]))
                for s in steps]


def _port_steps(main, loss, lr, scope, steps):
    exe = fluid.Executor(fluid.CPUPlace())
    return [tuple(float(np.asarray(v).reshape(-1)[0]) for v in
                  exe.run(main, feed=_feed(s), fetch_list=[loss, lr],
                          scope=scope)) for s in steps]


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's startup values and its uninterrupted 8 steps."""
    main, startup, loss, lr = _lamb_program(jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    init = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
    out = _jax_steps(main, loss, lr, scope, range(8))
    return init, out


def _close(got, want):
    """Losses at the training tolerance; the learning rate at rtol 1e-6
    with an absolute floor of 1e-8: where the decay reaches its end,
    XLA:CPU contracts ``1 - step / decay_steps`` into an fma and keeps
    -3e-8 where the port rounds to 0, times the lr span 0.049."""
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=1e-6, atol=1e-8)


def test_port_checkpoint_resumes_in_jax_and_port(tmp_path, jax_reference):
    init, want = jax_reference
    tmain, _, tloss, tlr = _lamb_program(fluid)
    scope = fluid.Scope()
    load_scope_arrays(scope, init, tmain, "cpu")
    first = _port_steps(tmain, tloss, tlr, scope, range(4))
    _close(first, want[:4])
    ck = str(tmp_path / "ck")
    io.save_checkpoint(ck, tmain, scope, step=4, extra={"step": 4})
    assert os.path.isfile(os.path.join(ck, "4", "__shards__.meta.json"))
    assert jio.latest_checkpoint(ck) == 4

    # JAX loads the port's checkpoint and continues
    jmain, jstart, jloss, jlr = _lamb_program(jfluid)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstart)
    names = jio.load_checkpoint(ck, jmain, jscope, step=4)
    assert names == _persistables(jmain)
    np.testing.assert_array_equal(
        np.asarray(jscope.find_var("@LR_DECAY_COUNTER@")), [4.0])
    _close(_jax_steps(jmain, jloss, jlr, jscope, range(4, 8)), want[4:])

    # and so does the port, in a fresh scope whose startup ran under
    # another seed
    tmain2, tstart2, tloss2, tlr2 = _lamb_program(fluid)
    tstart2.random_seed = 99
    scope2 = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(tstart2, scope=scope2)
    io.load_checkpoint(ck, tmain2, scope2, step=4)
    _close(_port_steps(tmain2, tloss2, tlr2, scope2, range(4, 8)), want[4:])


def test_jax_multihost_checkpoint_resumes_in_port(tmp_path, jax_reference):
    init, want = jax_reference
    jmain, _, jloss, jlr = _lamb_program(jfluid)
    jscope = jfluid.Scope()
    for n, v in init.items():
        jscope.set_var(n, v)
    _jax_steps(jmain, jloss, jlr, jscope, range(4))
    state = {n: jscope.find_var(n) for n in _persistables(jmain)}
    path = str(tmp_path / "ck" / "4")
    errs = []

    def rank_save(rank):
        try:
            jio._save_checkpoint_multihost(path, dict(state), {"step": 4},
                                           rank, 2, timeout_s=20,
                                           nonce="jax1")
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=rank_save, args=(r,)) for r in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not errs, errs
    assert io.latest_checkpoint(str(tmp_path / "ck")) == 4
    tmain, _, tloss, tlr = _lamb_program(fluid)
    scope = fluid.Scope()
    names = io.load_checkpoint(str(tmp_path / "ck"), tmain, scope, step=4,
                               device="cpu")
    assert names == _persistables(tmain)
    _close(_port_steps(tmain, tloss, tlr, scope, range(4, 8)), want[4:])


def test_port_reads_jax_sharded_entries(tmp_path):
    """A JAX multi-host save of a sharded array writes each rank's rows
    under ``name@start-stop;...`` keys; the port assembles them and
    refuses a gap."""
    path = tmp_path / "ck"
    path.mkdir()
    w = np.arange(24, dtype=np.float32).reshape(6, 4)
    np.savez(path / "__shards__.rank0.npz", **{"w@0-3;0-4": w[:3],
                                               "b": np.ones(2, "float32")})
    np.savez(path / "__shards__.rank1.npz", **{"w@3-6;0-4": w[3:]})
    meta = {"format": 1, "world": 2, "nonce": "n", "vars": {
        "w": {"shape": [6, 4], "dtype": "float32", "sharded": True},
        "b": {"sharded": False, "owner": 0}}}
    (path / "__shards__.meta.json").write_text(json.dumps(meta))
    got = io.load_checkpoint_arrays(str(path))
    np.testing.assert_array_equal(got["w"], w)
    np.testing.assert_array_equal(got["b"], np.ones(2, "float32"))
    for want, have in ((jio.load_checkpoint_arrays(str(path)), got),):
        for k in want:
            np.testing.assert_array_equal(have[k], want[k])
    os.remove(path / "__shards__.rank1.npz")
    with pytest.raises(ValueError, match="missing shard coverage"):
        io.load_checkpoint_arrays(str(path))


def test_orbax_checkpoint_is_refused_by_name(tmp_path):
    jmain, jstart, _, _ = _lamb_program(jfluid)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstart)
    jio.save_checkpoint(str(tmp_path / "ck"), jmain, jscope, step=2)
    path = str(tmp_path / "ck" / "2")
    assert io.is_committed_checkpoint(path)
    assert io.latest_checkpoint(str(tmp_path / "ck")) == 2
    tmain, _, _, _ = _lamb_program(fluid)
    for call in (lambda: io.load_checkpoint_arrays(path),
                 lambda: io.load_checkpoint(str(tmp_path / "ck"), tmain,
                                            fluid.Scope(), step=2,
                                            device="cpu")):
        with pytest.raises(ValueError, match="orbax's OCDBT layout") as ei:
            call()
        assert "_save_checkpoint_multihost" in str(ei.value)
