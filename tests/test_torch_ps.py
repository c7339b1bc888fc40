"""The parameter server on the port, on the CPU: twins of the JAX
package's ``tests/test_ps.py``, ``test_geo_sgd.py``,
``test_downpour_hogwild.py`` and
``test_models_ctr.py::test_deepfm_ps_training_parity`` (the same
models, data and gates, on ``paddle_tpu_torch``), each PS run also held
to the JAX package's PS run on the same data; the wire both ways (a
port client against a JAX ``ParameterServer`` and a JAX client against
a port server, and the same bytes for the same message); and
``python -m paddle_tpu_torch.distributed.launch_ps`` with 2 pservers
and 2 trainer processes, whose parameters after 3 sync SGD steps equal
a one-process run over both trainers' batches within rtol 1e-5.

The pservers run on threads in the test's process (``launch_pservers``)
except in the launcher test; every server is shut down before its test
ends.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from conftest import alloc_free_ports as _ports

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.ps import protocol as JP
from paddle_tpu.ps.client import PSClient as JaxClient
from paddle_tpu.ps.server import ParameterServer as JaxServer
from paddle_tpu.ps.transpile import PSTrainer as JaxPSTrainer
from paddle_tpu.ps.transpile import launch_pservers as jax_launch_pservers
from paddle_tpu.transpiler import DistributeTranspiler as JaxDT
from paddle_tpu.transpiler import DistributeTranspilerConfig as JaxDTC
from paddle_tpu_torch.ps import protocol as P
from paddle_tpu_torch.ps.client import PSClient
from paddle_tpu_torch.ps.downpour import DownpourSGD
from paddle_tpu_torch.ps.server import ParameterServer
from paddle_tpu_torch.ps.transpile import PSTrainer, launch_pservers
from paddle_tpu_torch.transpiler import (DistributeTranspiler,
                                         DistributeTranspilerConfig,
                                         GeoSgdTranspiler)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(atol=1e-4, rtol=1e-4)   # test_ps.py's gate (reference 1e-5 deltas)


def _pkg_parts(pkg):
    if pkg is jfluid:
        return JaxDT, JaxDTC, jax_launch_pservers, JaxPSTrainer
    return (DistributeTranspiler, DistributeTranspilerConfig,
            launch_pservers, PSTrainer)


def _linear(pkg, seed=5):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [8])
        y = pkg.layers.data("y", [1])
        pred = pkg.layers.fc(x, 1, bias_attr=False,
                             param_attr=pkg.ParamAttr(name="lin.w"))
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def _linear_batches(n=10):
    rng = np.random.RandomState(2)
    W = np.array([[1.0], [-2.0], [0.5], [3.0], [0.0], [1.5], [-1.0], [2.0]])
    out = []
    for _ in range(n):
        xb = rng.randn(16, 8).astype("float32")
        out.append({"x": xb, "y": (xb @ W).astype("float32")})
    return out


def _set_init(pkg, scope, init):
    """Carry JAX's initial parameters into a port scope (each package
    draws its own)."""
    if pkg is fluid and init:
        for n, v in init.items():
            scope.set_var(n, torch.from_numpy(v.copy()))


def _local_losses(pkg, build, batches, init=None, feed_keys=None):
    main, startup, loss = build(pkg)
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    _set_init(pkg, scope, init)
    return [float(np.asarray(exe.run(
        main, feed={k: b[k] for k in (feed_keys or b)}, fetch_list=[loss],
        scope=scope)[0]).reshape(())) for b in batches], scope


def _ps_losses(pkg, build, batches, n_servers=2, init=None, feed_keys=None,
               check=None):
    DT, DTC, launch, Trainer = _pkg_parts(pkg)
    main, startup, loss = build(pkg)
    eps = _ports(n_servers)
    cfg = DTC()
    cfg.mode = "pserver"
    t = DT(cfg)
    t.transpile(0, program=main, pservers=",".join(eps), trainers=1,
                sync_mode=True, startup_program=startup)
    if check is not None:
        check(t._ps_artifacts)
    scope = pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(startup, scope=scope)
    _set_init(pkg, scope, init)
    launch(t._ps_artifacts, scope)
    trainer = Trainer(t._ps_artifacts, exe, scope)
    try:
        return [float(np.asarray(trainer.run_step(
            {k: b[k] for k in (feed_keys or b)}, [loss])[0]).reshape(()))
            for b in batches]
    finally:
        trainer.client.shutdown_servers()


def _init_of(build):
    main, startup, _ = build(jfluid)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    return {p.name: np.asarray(scope.find_var(p.name))
            for p in main.all_parameters()}


# -- test_ps.py's twins ----------------------------------------------------------


def test_pserver_training_matches_local():
    batches = _linear_batches()
    init = _init_of(_linear)
    local, _ = _local_losses(fluid, _linear, batches, init)
    ps = _ps_losses(fluid, _linear, batches, init=init)
    np.testing.assert_allclose(local, ps, **CPU)
    np.testing.assert_allclose(ps, _ps_losses(jfluid, _linear, batches),
                               **CPU)


def test_pserver_checkpoint_notify(tmp_path):
    main, startup, loss = _linear(fluid, seed=9)
    eps = _ports(1)
    cfg = DistributeTranspilerConfig()
    cfg.mode = "pserver"
    t = DistributeTranspiler(cfg)
    t.transpile(0, program=main, pservers=eps[0], trainers=1, sync_mode=True,
                startup_program=startup)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    launch_pservers(t._ps_artifacts, scope)
    trainer = PSTrainer(t._ps_artifacts, exe, scope)
    trainer.run_step(_linear_batches(1)[0], [loss])
    trainer.client.checkpoint_notify(str(tmp_path))
    trainer.client.shutdown_servers()
    files = os.listdir(tmp_path)
    assert any(f.startswith("pserver_") for f in files), files
    saved = np.load(os.path.join(tmp_path, files[0]))
    np.testing.assert_array_equal(saved["lin.w@0"],
                                  scope.find_var("lin.w").numpy())


def test_sparse_prefetch_and_push():
    eps = _ports(1)
    table = np.arange(20, dtype="float32").reshape(10, 2)
    ps = ParameterServer(eps[0], {"emb@0": table.copy()},
                         {"emb@0": {"type": "sgd", "lr": 1.0}}, trainers=1)
    ps.start_background()
    client = PSClient(eps)
    shard_map = {"emb": [(eps[0], 0, 10)]}
    rows = np.array([1, 3, 7])
    np.testing.assert_allclose(client.prefetch_rows(shard_map, "emb", rows),
                               table[rows])
    client.push_sparse(shard_map, "emb", rows, np.ones((3, 2), "float32"))
    np.testing.assert_allclose(client.prefetch_rows(shard_map, "emb", rows),
                               table[rows] - 1.0)
    assert client.stats["bytes_pulled"] == 2 * 3 * 2 * 4
    client.shutdown_servers()


def _sparse_model(pkg, seed=11):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        ids = pkg.layers.data("ids", [3], dtype="int64")
        y = pkg.layers.data("y", [1])
        emb = pkg.layers.embedding(ids, [50, 4], is_sparse=True,
                                   param_attr=pkg.ParamAttr(name="sp_emb.w"))
        pred = pkg.layers.fc(pkg.layers.reduce_mean(emb, dim=1), 1,
                             bias_attr=False,
                             param_attr=pkg.ParamAttr(name="sp_fc.w"))
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_sparse_embedding_ps_training_matches_local():
    rng = np.random.RandomState(4)
    batches = [{"ids": rng.randint(0, 50, (8, 3)).astype("int64"),
                "y": rng.randn(8, 1).astype("float32")} for _ in range(6)]
    init = _init_of(_sparse_model)

    def check(art):
        assert art.sparse_params.get("sp_emb.w") == "ids", art.sparse_params

    local, _ = _local_losses(fluid, _sparse_model, batches, init)
    ps = _ps_losses(fluid, _sparse_model, batches, init=init, check=check)
    np.testing.assert_allclose(local, ps, **CPU)
    np.testing.assert_allclose(ps, _ps_losses(jfluid, _sparse_model,
                                              batches, check=check), **CPU)


def test_ps_client_retries_through_server_blip():
    eps = _ports(1)
    table = np.arange(12, dtype="float32").reshape(6, 2)

    def make_server():
        ps = ParameterServer(eps[0], {"w@0": table.copy()},
                             {"w@0": {"type": "sgd", "lr": 1.0}}, trainers=1)
        ps.start_background()
        return ps

    make_server()
    client = PSClient(eps)
    shard_map = {"w": [(eps[0], 0, 6)]}
    np.testing.assert_allclose(client.get_param(shard_map, "w"), table)
    client.shutdown_servers()
    time.sleep(0.2)

    def restart():
        time.sleep(0.8)
        make_server()

    threading.Thread(target=restart, daemon=True).start()
    t0 = time.time()
    got = client.get_param(shard_map, "w")
    assert time.time() - t0 > 0.3, "request should have waited out the blip"
    np.testing.assert_allclose(got, table)
    client.shutdown_servers()


def test_ps_client_retry_exhaustion_raises():
    with pytest.raises(ConnectionError, match="failed after 3 attempts"):
        P.request(("127.0.0.1", 1), {"verb": P.GET_PARAM, "name": "x@0"},
                  retries=2, backoff=0.01, timeout=0.5)


def test_stale_retry_does_not_break_next_round():
    """A reply lost after a sync round completed resends the request
    into the next round: the server's (trainer_id, seq) table replays
    the cached response instead of registering the duplicate."""
    eps = _ports(1)
    w = np.zeros((4, 2), "float32")
    ParameterServer(eps[0], {"w@0": w.copy()},
                    {"w@0": {"type": "sgd", "lr": 1.0}}, trainers=2,
                    sync_mode=True).start_background()
    addr = (eps[0].rsplit(":", 1)[0], int(eps[0].rsplit(":", 1)[1]))
    c0, c1 = PSClient(eps, 0), PSClient(eps, 1)

    done = []
    msg0 = {"verb": P.BARRIER, "trainer_id": 0, "seq": next(c0._seq)}
    t = threading.Thread(target=lambda: done.append(P.request(addr,
                                                              dict(msg0))))
    t.start()
    c1.barrier()
    t.join(timeout=30)
    assert done and done[0]["ok"]
    assert P.request(addr, dict(msg0))["ok"]
    flag = []
    t1 = threading.Thread(target=lambda: (c1.barrier(), flag.append(1)))
    t1.start()
    t1.join(timeout=1.0)
    assert not flag, "stale retry released the next round's barrier early"
    c0.barrier()
    t1.join(timeout=30)
    assert flag

    shard_map = {"w": [(eps[0], 0, 4)]}
    g = np.ones((4, 2), "float32")
    gmsg = {"verb": P.SEND_GRAD, "name": "w@0", "grad": g, "trainer_id": 0,
            "seq": next(c0._seq)}
    assert P.request(addr, dict(gmsg))["ok"]
    c1.send_grad(shard_map, "w", g)
    np.testing.assert_allclose(c0.get_param(shard_map, "w"), w - 1.0)
    P.request(addr, dict(gmsg))
    c0.send_grad(shard_map, "w", g)
    np.testing.assert_allclose(c0.get_param(shard_map, "w"), w - 1.0,
                               err_msg="duplicate completed a round")
    c1.send_grad(shard_map, "w", g)
    np.testing.assert_allclose(c0.get_param(shard_map, "w"), w - 2.0)
    c0.shutdown_servers()


@pytest.mark.parametrize("kind", ["adam", "momentum", "adagrad"])
def test_server_update_rules_equal_jax(kind):
    """The port's ``_ShardState`` updates (dense, then lazy sparse) give
    JAX's server's values bit for bit over 3 rounds."""
    from paddle_tpu.ps.server import _ShardState as JaxShard
    from paddle_tpu_torch.ps.server import _ShardState

    rng = np.random.RandomState(1)
    value = rng.randn(6, 3).astype(np.float32)
    spec = {"type": kind, "lr": 0.05, "beta1": 0.9, "beta2": 0.99,
            "epsilon": 1e-6, "mu": 0.8}
    a, b = _ShardState("w", value, spec), JaxShard("w", value, spec)
    for _ in range(3):
        g = rng.randn(6, 3).astype(np.float32)
        a.apply(g)
        b.apply(g)
        rows = np.array([4, 1, 4])
        gs = rng.randn(3, 3).astype(np.float32)
        a.apply_sparse(rows, gs)
        b.apply_sparse(rows, gs)
    np.testing.assert_array_equal(a.value, b.value)
    for k in b.state:
        np.testing.assert_array_equal(a.state[k], b.state[k])


@pytest.mark.parametrize("opt", ["adam", "momentum"])
def test_fused_update_ops_go_to_the_servers(opt):
    """With ``optimizer_fuse`` on (the default on a card) the update ops
    are ``fused_adam`` / ``fused_momentum``: the trainer program keeps
    none of them and the servers take the unfused rule (JAX's op list
    lacks the fused types; a fused program kept its updates there)."""
    fluid.set_flags({"optimizer_fuse": "on"})
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", [8])
            loss = fluid.layers.mean(fluid.layers.fc(x, 1))
            make = {"adam": lambda: fluid.optimizer.Adam(0.1),
                    "momentum": lambda: fluid.optimizer.Momentum(0.1, 0.9)}
            make[opt]().minimize(loss)
    finally:
        fluid.set_flags({"optimizer_fuse": "auto"})
    assert f"fused_{opt}" in {op.type for op in main.global_block().ops}
    cfg = DistributeTranspilerConfig()
    cfg.mode = "pserver"
    t = DistributeTranspiler(cfg)
    t.transpile(0, program=main, pservers="127.0.0.1:1", trainers=1,
                startup_program=startup)
    art = t._ps_artifacts
    assert not {op.type for op in art.trainer_program.global_block().ops} \
        & {"fused_adam", "fused_momentum", "adam", "momentum"}
    assert {s["type"] for s in art.optimizer_specs.values()} == {opt}
    assert len(art.grad_to_param) == 2


# -- the wire both ways ----------------------------------------------------------


def test_wire_bytes_equal_jax():
    msg = {"verb": P.PUSH_SPARSE, "name": "emb@0", "trainer_id": 3,
           "seq": 77, "rows": np.array([5, 1], np.int64),
           "grad": np.arange(6, dtype=np.float32).reshape(2, 3)}
    assert P._encode(msg) == JP._encode(msg)
    assert P._HDR.size == 8


def test_port_client_against_a_jax_server():
    eps = _ports(1)
    table = np.arange(24, dtype="float32").reshape(8, 3)
    JaxServer(eps[0], {"emb@0": table.copy()},
              {"emb@0": {"type": "sgd", "lr": 0.5}},
              trainers=1).start_background()
    client = PSClient(eps)
    shard_map = {"emb": [(eps[0], 0, 8)]}
    rows = np.array([2, 6])
    client.push_sparse(shard_map, "emb", rows, np.ones((2, 3), "float32"))
    client.send_grad(shard_map, "emb", np.full((8, 3), 2.0, np.float32))
    want = table.copy()
    want[rows] -= 0.5
    want -= 1.0
    np.testing.assert_array_equal(client.get_param(shard_map, "emb"), want)
    np.testing.assert_array_equal(
        client.prefetch_rows(shard_map, "emb", rows), want[rows])
    client.shutdown_servers()


def test_jax_client_against_a_port_server():
    eps = _ports(1)
    table = np.arange(24, dtype="float32").reshape(8, 3)
    srv = ParameterServer(eps[0], {"emb@0": table.copy()},
                          {"emb@0": {"type": "sgd", "lr": 0.5}}, trainers=2,
                          sync_mode=True)
    srv.start_background()
    c0, c1 = JaxClient(eps, 0), JaxClient(eps, 1)
    shard_map = {"emb": [(eps[0], 0, 8)]}
    c0.send_grad(shard_map, "emb", np.full((8, 3), 2.0, np.float32))
    c1.send_grad(shard_map, "emb", np.full((8, 3), 4.0, np.float32))
    t = threading.Thread(target=c0.barrier)
    t.start()
    c1.barrier()
    t.join(timeout=30)
    np.testing.assert_array_equal(c0.get_param(shard_map, "emb"),
                                  table - 0.5 * 3.0)
    np.testing.assert_array_equal(
        c1.prefetch_rows(shard_map, "emb", np.array([7])), table[[7]] - 1.5)
    c0.shutdown_servers()


# -- test_geo_sgd.py's twin ---------------------------------------------------------


def _geo_model(pkg, seed=21):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [4])
        y = pkg.layers.data("y", [1])
        pred = pkg.layers.fc(x, 1, bias_attr=False,
                             param_attr=pkg.ParamAttr(name="geo_w"))
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(0.2).minimize(loss)
    return main, startup, loss


def test_geo_sgd_converges_and_syncs():
    W = np.array([[1.0], [-2.0], [0.5], [3.0]], "float32")
    rng = np.random.RandomState(3)
    batches = []
    for _ in range(30):
        xb = rng.randn(16, 4).astype("float32")
        batches.append({"x": xb, "y": (xb @ W).astype("float32")})
    eps = _ports(1)
    main, startup, loss = _geo_model(fluid)
    t = GeoSgdTranspiler()
    t.transpile(0, program=main, pservers=eps[0], trainers=2,
                startup_program=startup, current_endpoint=eps[0])
    assert t._ps_artifacts.trainer_program is main
    assert all(s == {"type": "sgd", "lr": 1.0}
               for s in t._ps_artifacts.optimizer_specs.values())
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    launch_pservers(t._ps_artifacts, scope)
    comm = t.get_communicator(scope, need_push_nums=5)
    losses = []
    for b in batches:
        (l,) = exe.run(main, feed=b, fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(l)))
        for gname in t._ps_artifacts.grad_to_param:
            comm.send(gname, None)
    comm.stop()
    w_local = scope.get_numpy("geo_w")
    w_server = comm.client.get_param(t._ps_artifacts.shard_map, "geo_w")
    comm.client.shutdown_servers()
    assert losses[-1] < losses[0] * 0.1, losses[:3] + losses[-3:]
    np.testing.assert_allclose(w_local, np.asarray(w_server), atol=1e-4)
    np.testing.assert_allclose(w_local, W, atol=0.2)


def test_async_communicator_sends_and_receives():
    """The async communicator's threads: gradients queued by ``send``
    reach the server (merged a batch at a time) and the recv loop sets
    the server's values into the scope."""
    main, startup, loss = _linear(fluid, seed=3)
    eps = _ports(1)
    cfg = DistributeTranspilerConfig()
    cfg.mode = "pserver"
    cfg.sync_mode = False
    t = DistributeTranspiler(cfg)
    t.transpile(0, program=main, pservers=eps[0], trainers=1,
                sync_mode=False, startup_program=startup)
    art = t._ps_artifacts
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    w0 = scope.get_numpy("lin.w")
    launch_pservers(art, scope)
    from paddle_tpu_torch.ps.communicator import Communicator

    comm = Communicator(art, scope, mode="async")
    comm.start()

    def wait_for(want):
        deadline = time.time() + 30
        while time.time() < deadline and not np.allclose(
                scope.get_numpy("lin.w"), want, atol=1e-6):
            time.sleep(0.05)
        np.testing.assert_allclose(scope.get_numpy("lin.w"), want,
                                   atol=1e-6)

    try:
        (gname,) = art.grad_to_param
        # SGD at lr 0.1; one gradient in the queue at a time (queued
        # ones are averaged a batch at a time)
        comm.send(gname, np.ones_like(w0))
        wait_for(w0 - 0.1)
        comm.send(gname, 2 * np.ones_like(w0))
        wait_for(w0 - 0.3)
    finally:
        comm.stop()
        comm.client.shutdown_servers()


# -- test_downpour_hogwild.py's twins -------------------------------------------------


def _downpour_model(pkg, seed=5):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        ids = pkg.layers.data("ids", [4], dtype="int64")
        y = pkg.layers.data("y", [1])
        emb = pkg.layers.embedding(ids, size=[32, 8], is_sparse=True)
        pred = pkg.layers.fc(pkg.layers.reduce_mean(emb, dim=1), 1,
                             bias_attr=False)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
    return main, startup, loss


def test_downpour_sgd_builds_tables():
    main, startup, loss = _downpour_model(fluid)
    with fluid.program_guard(main, startup):
        DownpourSGD(learning_rate=0.05,
                    sparse_accessor="sparse_adagrad").minimize(loss)
    tables = main._downpour_tables
    sparse = [t for t in tables.values() if t.type == "sparse"]
    dense = [t for t in tables.values() if t.type == "dense"]
    assert len(sparse) == 1 and sparse[0].fea_dim == 8
    assert sparse[0].accessor == "sparse_adagrad"
    assert len(dense) == 1 and len(dense[0].param_names) == 1
    assert sparse[0].param_names[0].startswith("embedding")


def test_downpour_ps_training_uses_table_accessor():
    main, startup, loss = _downpour_model(fluid)
    with fluid.program_guard(main, startup):
        opt = DownpourSGD(learning_rate=0.1, sparse_accessor="sparse_adagrad")
        opt.minimize(loss)
    eps = _ports(1)
    cfg = DistributeTranspilerConfig()
    cfg.mode = "pserver"
    t = DistributeTranspiler(cfg)
    t.transpile(0, program=main, pservers=",".join(eps), trainers=1,
                sync_mode=True, startup_program=startup)
    art = opt.apply_to_artifacts(t._ps_artifacts)
    emb_param = next(tc for tc in opt.server.tables.values()
                     if tc.type == "sparse").param_names[0]
    assert art.optimizer_specs[emb_param]["type"] == "adagrad"
    rng = np.random.RandomState(2)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    servers = launch_pservers(art, scope)
    trainer = PSTrainer(art, exe, scope)
    losses = []
    for _ in range(15):
        ids = rng.randint(0, 32, (16, 4)).astype("int64")
        yv = (ids.sum(1, keepdims=True) / 64.0).astype("float32")
        (l,) = trainer.run_step({"ids": ids, "y": yv}, [loss])
        losses.append(float(l))
    adagrad_shards = [s for srv in servers for name, s in srv._shards.items()
                      if emb_param in name and "acc" in s.state]
    trainer.client.shutdown_servers()
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
    assert adagrad_shards, "sparse table never used its adagrad accessor"


def test_hogwild_multithread_training():
    """thread=4 Hogwild over the same 400 rows as JAX's test: every batch
    runs and the shared weights approach the generating W."""
    import tempfile

    from paddle_tpu_torch.dataset import InMemoryDataset

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8])
        y = fluid.layers.data("y", [1])
        pred = fluid.layers.fc(x, 1, bias_attr=False,
                               param_attr=fluid.ParamAttr(name="hog.w"))
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(0.05).minimize(loss)
    rng = np.random.RandomState(3)
    W = rng.randn(8, 1).astype("float32")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "data.txt")
        with open(path, "w") as f:
            for _ in range(400):
                xv = rng.randn(8)
                f.write("8 " + " ".join(f"{v:.6f}" for v in xv)
                        + f" 1 {float(xv @ W[:, 0]):.6f}\n")
        ds = InMemoryDataset()
        ds.set_batch_size(16)
        ds.set_use_var([x, y])
        ds.set_filelist([path])
        ds.load_into_memory()
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        for _ in range(15):
            exe.train_from_dataset(program=main, dataset=ds, scope=scope,
                                   thread=4, fetch_list=[loss],
                                   print_period=1000)
        w = scope.get_numpy("hog.w")
    assert np.abs(w - W).max() < 0.2, np.abs(w - W).max()


# -- test_models_ctr.py::test_deepfm_ps_training_parity's twin ------------------------

FEED_KEYS = ("sparse_ids", "dense_x", "label")


def _deepfm(pkg):
    from paddle_tpu.models import build_deepfm as jbuild
    from paddle_tpu_torch.models.ctr import build_deepfm

    build = jbuild if pkg is jfluid else build_deepfm
    with pkg.unique_name.guard():
        main, startup, _f, fetches = build(
            num_fields=4, vocab_size=100, embed_dim=4,
            optimizer=pkg.optimizer.SGD(0.1), is_sparse=True)
    main.random_seed = startup.random_seed = 17
    return main, startup, fetches["loss"]


def test_deepfm_ps_training_parity():
    from paddle_tpu.models import synthetic_ctr_batch

    rng = np.random.RandomState(2)
    batches = [synthetic_ctr_batch(rng, 32, num_fields=4, vocab_size=100)
               for _ in range(6)]
    init = _init_of(_deepfm)
    local, _ = _local_losses(fluid, _deepfm, batches, init, FEED_KEYS)
    ps = _ps_losses(fluid, _deepfm, batches, n_servers=1, init=init,
                    feed_keys=FEED_KEYS)
    np.testing.assert_allclose(ps, local, rtol=2e-4, atol=2e-5)
    jps = _ps_losses(jfluid, _deepfm, batches, n_servers=1,
                     feed_keys=FEED_KEYS)
    np.testing.assert_allclose(ps, jps, rtol=2e-4, atol=2e-5)


# -- launch_ps: 2 pserver and 2 trainer processes -------------------------------------

MODEL = textwrap.dedent('''
    import numpy as np
    import paddle_tpu_torch as fluid

    def build():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 13
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            ids = fluid.layers.data("ids", [3], dtype="int64")
            x = fluid.layers.data("x", [4])
            y = fluid.layers.data("y", [1])
            emb = fluid.layers.embedding(
                ids, [40, 4], is_sparse=True,
                param_attr=fluid.ParamAttr(name="lp_emb.w"))
            h = fluid.layers.concat([fluid.layers.reduce_mean(emb, dim=1), x],
                                    axis=1)
            pred = fluid.layers.fc(h, 1, param_attr=fluid.ParamAttr(
                name="lp_fc.w"), bias_attr=fluid.ParamAttr(name="lp_fc.b"))
            loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        return main, startup, loss

    def batch(step, tid):
        rng = np.random.RandomState(100 + step)
        b = {{"ids": rng.randint(0, 40, (8, 3)).astype("int64"),
              "x": rng.randn(8, 4).astype("float32"),
              "y": rng.randn(8, 1).astype("float32")}}
        return {{k: v[tid * 4:(tid + 1) * 4] for k, v in b.items()}}
''')

WORKER = textwrap.dedent('''
    import json, os, sys
    sys.path.insert(0, {repo!r})
    from paddle_tpu_torch.parallel import fleet as F
''') + MODEL + textwrap.dedent('''
    OUT, STEPS = sys.argv[1], int(sys.argv[2])
    role = F.PaddleCloudRoleMaker(is_collective=False)
    F.fleet.init(role)
    main, startup, loss = build()
    strategy = F.DistributedStrategy()
    strategy.mode = "pserver"
    with fluid.program_guard(main, startup):
        F.fleet.distributed_optimizer(fluid.optimizer.SGD(0.2),
                                      strategy).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    if F.fleet.is_server():
        print("PSERVER_READY", flush=True)
        F.fleet.run_server(scope=scope)
        sys.exit(0)
    tid = F.fleet.worker_index()
    trainer = F.fleet.init_worker(executor=exe, scope=scope)
    losses = [float(np.asarray(trainer.run_step(batch(s, tid), [loss])[0]))
              for s in range(STEPS)]
    trainer._refresh_sparse_rows({{"ids": np.arange(40)}})
    params = {{n: scope.get_numpy(n).tolist()
               for n in ("lp_emb.w", "lp_fc.w", "lp_fc.b")}}
    F.fleet.stop_worker()
    with open(os.path.join(OUT, f"trainer{{tid}}.json"), "w") as f:
        json.dump({{"losses": losses, "params": params}}, f)
''')


def _one_process(steps):
    """The same model, SGD on the full batch of both trainers' halves."""
    ns = {}
    exec(MODEL.format(), ns)
    main, startup, loss = ns["build"]()
    with fluid.program_guard(main, startup):
        fluid.optimizer.SGD(0.2).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    for s in range(steps):
        halves = [ns["batch"](s, t) for t in (0, 1)]
        feed = {k: np.concatenate([h[k] for h in halves]) for k in halves[0]}
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return {n: scope.get_numpy(n) for n in ("lp_emb.w", "lp_fc.w", "lp_fc.b")}


def test_launch_ps_two_pservers_two_trainers(tmp_path):
    script = tmp_path / "ps_job.py"
    script.write_text(WORKER.format(repo=REPO))
    port = int(_ports(1)[0].rsplit(":", 1)[1])
    logs = tmp_path / "logs"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "TRAINING_ROLE"))}
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch_ps",
         "--server_num", "2", "--worker_num", "2", "--started_port",
         str(port), "--log_dir", str(logs), str(script), str(tmp_path),
         "3"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    texts = {p.name: p.read_text() for p in logs.iterdir()}
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:],
                                  texts)
    for i in (0, 1):
        # a pserver's log may hold other lines first: skip to the marker
        lines = texts[f"pserver.{i}.log"].splitlines()
        assert any(line.strip() == "PSERVER_READY" for line in lines), lines
    outs = [json.loads((tmp_path / f"trainer{t}.json").read_text())
            for t in (0, 1)]
    want = _one_process(3)
    for n, w in want.items():
        for o in outs:
            np.testing.assert_allclose(np.asarray(o["params"][n]), w,
                                       rtol=1e-5, atol=1e-6, err_msg=n)
