"""The port's distribution (``CompiledProgram``, ``parallel``,
``transpiler``, DGC) in a gloo world of 4 on the CPU, against the JAX
package on the conftest's 8 virtual CPU devices.

The JAX side runs in the pytest process at global batch B; the port
runs in one spawned world of 4 (``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node 4 --backend gloo
tests/test_torch_parallel.py --worker DIR``), each rank on its local
batch of B / 4, every scenario in turn; the tests read the ranks'
results. Both packages start from JAX's startup values (``init``
arrays written before the launch), so the trajectories are comparable
step for step.

Scenarios and tolerances:

* ``dp``: MLP under SGD, 5 steps, data parallel (twins of
  test_parallel.py::test_data_parallel_* and test_multihost.py::
  test_two_process_parity_vs_single_process_dp2): losses and parameters
  against JAX's ``with_data_parallel`` at ``DP_RTOL`` / ``DP_ATOL``;
  the four ranks' parameters equal bit for bit;
* ``zero1``: Adam with the moments sharded by ``shard_optimizer_states``
  (twin of test_zero_localsgd.py::test_zero_sharded_adam_training_parity):
  against JAX's unsharded Adam at 1e-4 / 1e-5, equal to the unsharded
  port run bit for bit, and each rank holds a quarter of every moment;
* ``ep_*``: ``with_expert_parallel`` at (dp, ep) = (1, 4) and (2, 2),
  ``psum`` and ``alltoall`` (twins of test_moe.py::
  test_expert_parallel_matches_dense): losses and every parameter
  against JAX's dense MoE at ``EP_RTOL`` / ``EP_ATOL``, and every Adam
  first moment (the gradients, scale included) within ``EP_GRAD_RTOL``
  relative L2 error;
* ``fleet`` / ``fleet_zero``: the collective ``minimize`` and its
  ``sharding`` strategy (twins of test_fleet.py);
* ``dgc``: DGCMomentumOptimizer under data parallelism (twin of
  test_dgc.py): the dense steps before the rampup against JAX at
  ``DP_RTOL``, about 75 % zeros after it, falling losses, replicas equal;
* ``gar`` / ``lsgd_*``: GradAllReduce and LocalSGD through a plain
  Executor in the world (twin of test_zero_localsgd.py::
  test_localsgd_multiprocess);
* ``ck_zero`` / ``ck_ep``: ZeRO-1 and expert-parallel checkpoints
  restored by one process (another world) continue the trajectory at
  2e-5 (twin of test_elastic_resume.py);
* ``drop``: with dropout the ranks' masks differ and the replicas stay
  equal.

What stays refused (tensor parallelism inside a pipeline, PS mode), a
mesh larger than the world, one strategy a compile and a transpiled
program run without a world are checked in the pytest process.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
DP_RTOL, DP_ATOL = 1e-4, 1e-5
EP_RTOL, EP_ATOL = 1e-4, 1e-5
EP_GRAD_RTOL = 1e-4  # relative L2 error of an Adam first moment
CK_RTOL, CK_ATOL = 2e-5, 2e-6


# -- models, built with either package ---------------------------------------


def _names(pkg):
    return pkg.unique_name


def mlp(pkg, opt="sgd", dropout=0.0, seed=7):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), _names(pkg).guard():
        x = pkg.layers.data("x", [16])
        y = pkg.layers.data("y", [1], dtype="int64")
        h = pkg.layers.fc(x, 32, act="relu")
        if dropout:
            h = pkg.layers.dropout(h, dropout_prob=dropout)
        logits = pkg.layers.fc(h, 4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        o = (pkg.optimizer.SGD(0.1) if opt == "sgd"
             else pkg.optimizer.Adam(5e-3))
        o.minimize(loss)
    return main, startup, loss


def moe(pkg, seed=21):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), _names(pkg).guard():
        x = pkg.layers.data("x", [6, 8])
        y = pkg.layers.data("y", [6, 8])
        out, aux = pkg.layers.switch_moe(x, 4, 16, capacity_factor=8.0)
        mse = pkg.layers.mean(pkg.layers.square_error_cost(out, y))
        loss = pkg.layers.mean(pkg.layers.elementwise_add(
            mse, pkg.layers.scale(aux, scale=0.01)))
        pkg.optimizer.Adam(5e-3).minimize(loss)
    return main, startup, loss


def dgc(pkg, seed=3):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), _names(pkg).guard():
        x = pkg.layers.data("x", [16])
        y = pkg.layers.data("y", [1])
        pred = pkg.layers.fc(x, 1, bias_attr=False)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.DGCMomentumOptimizer(
            0.05, momentum=0.9, rampup_begin_step=3, rampup_step=1,
            sparsity=[0.75]).minimize(loss)
    enc = next(n for n in main.global_block().vars if ".dgc_enc" in n)
    return main, startup, loss, enc


def lsgd(pkg, seed=5):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), _names(pkg).guard():
        x = pkg.layers.data("x", [8])
        y = pkg.layers.data("y", [1])
        pred = pkg.layers.fc(x, 1, bias_attr=False)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(0.05).minimize(loss)
    return main, startup, loss


def mlp_batches(steps, n=32, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(n, 16).astype("float32"),
             "y": rng.randint(0, 4, (n, 1)).astype("int64")}
            for _ in range(steps)]


def moe_batches(steps, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        x = rng.randn(8, 6, 8).astype("float32")
        out.append({"x": x, "y": np.tanh(x[..., ::-1].copy())})
    return out


def dgc_batches(steps, seed=4):
    rng = np.random.RandomState(seed)
    W = rng.randn(16, 1).astype("float32")
    out = []
    for _ in range(steps):
        xb = rng.randn(32, 16).astype("float32")
        out.append({"x": xb, "y": xb @ W})
    return out


EP_CASES = [(1, 4, "psum"), (2, 2, "psum"), (1, 4, "alltoall"),
            (2, 2, "alltoall")]


def ep_rows(rank, dp, ep, dispatch, n=8):
    """The global rows rank ``rank`` feeds under (dp, ep, dispatch)."""
    if dispatch == "alltoall":
        k = n // (dp * ep)
        return slice(rank * k, (rank + 1) * k)
    k = n // dp
    d = rank // ep
    return slice(d * k, (d + 1) * k)


def _local(feed, rank, n):
    return {k: v[rank * (v.shape[0] // n):(rank + 1) * (v.shape[0] // n)]
            for k, v in feed.items()}


# -- the worker (one process of the world) -----------------------------------


def _worker(out_dir):
    import torch

    import paddle_tpu_torch as fl
    from paddle_tpu_torch.io import load_scope_arrays
    from paddle_tpu_torch.parallel import fleet as fleet_mod
    from paddle_tpu_torch.parallel.env import init_parallel_env
    from paddle_tpu_torch.parallel.sharding import shard_optimizer_states
    from paddle_tpu_torch.transpiler import GradAllReduce, LocalSGD

    env = init_parallel_env()
    rank, n = env.rank, env.world_size
    fl.set_flags({"optimizer_fuse": "off"})
    init = dict(np.load(os.path.join(out_dir, "init.npz"),
                        allow_pickle=True))
    init = {k: v.item() for k, v in init.items()}
    out = {}

    def fresh(build, key, *a, **kw):
        built = build(fl, *a, **kw)
        main, startup = built[0], built[1]
        scope = fl.Scope()
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup, scope=scope)
        load_scope_arrays(scope, init[key], main, "cpu")
        return built, scope, exe

    def params(scope, main):
        return {p.name: scope.get_numpy(p.name).tolist()
                for p in main.all_parameters()}

    # dp: SGD, 5 steps
    (main, _, loss), scope, exe = fresh(mlp, "mlp_sgd")
    prog = fl.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    ls = [float(exe.run(prog, feed=_local(b, rank, n), fetch_list=[loss],
                        scope=scope)[0]) for b in mlp_batches(5)]
    out["dp"] = {"losses": ls, "params": params(scope, main)}
    from paddle_tpu_torch.dataset_runner import _run_hogwild

    try:
        _run_hogwild(exe, prog, None, scope, [loss], None, 100, 2)
        out["hogwild"] = "ran"
    except NotImplementedError as e:
        out["hogwild"] = str(e)

    # Adam unsharded and ZeRO-1
    for name, zero in (("adam", False), ("zero1", True)):
        (main, _, loss), scope, exe = fresh(mlp, "mlp_adam", opt="adam")
        if zero:
            nsh, skipped = shard_optimizer_states(main, n)
            out["zero1_sharded"] = [nsh, skipped]
        prog = fl.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        ls = [float(exe.run(prog, feed=_local(b, rank, n),
                            fetch_list=[loss], scope=scope)[0])
              for b in mlp_batches(6, seed=11)]
        moments = {v.name: list(scope.find_var(v.name).shape)
                   for v in main.global_block().vars.values()
                   if getattr(v, "is_accumulator", False)
                   and max(v.shape) > 1}
        out[name] = {"losses": ls, "params": params(scope, main),
                     "moments": moments}
        if zero:
            # a checkpoint of the sharded state, then 3 more steps
            ck = os.path.join(out_dir, "ck_zero")
            fl.io.save_checkpoint(ck, main_program=main, scope=scope)
            want = [float(exe.run(prog, feed=_local(b, rank, n),
                                  fetch_list=[loss], scope=scope)[0])
                    for b in mlp_batches(3, seed=12)]
            out["ck_zero"] = {"want": want}

    # expert parallelism
    for dp, ep, dispatch in EP_CASES:
        (main, _, loss), scope, exe = fresh(moe, "moe")
        prog = fl.CompiledProgram(main).with_expert_parallel(
            ep=ep, dp=dp, dispatch=dispatch)
        rows = ep_rows(rank, dp, ep, dispatch)
        ls = [float(exe.run(prog, feed={k: v[rows] for k, v in f.items()},
                            fetch_list=[loss], scope=scope)[0])
              for f in moe_batches(3)]
        key = f"ep_{dp}_{ep}_{dispatch}"
        out[key] = {"losses": ls, "params": {
            p.name: scope.get_numpy(p.name).tolist()
            for p in main.all_parameters()},
            "m1": first_moments(main,
                                lambda nm: scope.get_numpy(nm).tolist())}
        if (dp, ep, dispatch) == (1, 4, "psum"):
            ck = os.path.join(out_dir, "ck_ep")
            fl.io.save_checkpoint(ck, main_program=main, scope=scope)
            want = [float(exe.run(prog, feed=f, fetch_list=[loss],
                                  scope=scope)[0])
                    for f in moe_batches(3, seed=2)]
            out["ck_ep"] = {"want": want}

    # fleet, plain and with the sharding strategy
    for name, sharding in (("fleet", False), ("fleet_zero", True)):
        fleet = fleet_mod.fleet
        fleet.init(fleet_mod.PaddleCloudRoleMaker())
        strategy = fleet_mod.DistributedStrategy()
        strategy.sharding = sharding
        main, startup = fl.Program(), fl.Program()
        main.random_seed = startup.random_seed = 7
        with fl.program_guard(main, startup), fl.unique_name.guard():
            x = fl.layers.data("x", [16])
            y = fl.layers.data("y", [1], dtype="int64")
            h = fl.layers.fc(x, 32, act="relu")
            loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(
                fl.layers.fc(h, 4), y))
            fleet.distributed_optimizer(
                fl.optimizer.Adam(5e-3) if sharding else
                fl.optimizer.SGD(0.1), strategy).minimize(loss)
        scope = fl.Scope()
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup, scope=scope)
        load_scope_arrays(scope, init["mlp_adam" if sharding else "mlp_sgd"],
                          main, "cpu")
        ls = [float(exe.run(fleet.main_program, feed=_local(b, rank, n),
                            fetch_list=[loss], scope=scope)[0])
              for b in (mlp_batches(6, seed=11) if sharding
                        else mlp_batches(5))]
        out[name] = {
            "losses": ls, "params": params(scope, main),
            "index": fleet.worker_index(), "num": fleet.worker_num(),
            "first": fleet.is_first_worker(),
            "sharded": sorted(nm for nm, v in main.global_block().vars.items()
                              if "moment" in nm and v.sharding is not None)}
        fleet.barrier_worker()

    # DGC under data parallelism
    (main, _, loss, enc), scope, exe = fresh(dgc, "dgc")
    prog = fl.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    ls, spars = [], []
    for b in dgc_batches(20):
        l, e = exe.run(prog, feed=_local(b, rank, n), fetch_list=[loss, enc],
                       scope=scope)
        ls.append(float(l))
        spars.append(float(np.mean(np.asarray(e) == 0.0)))
    out["dgc"] = {"losses": ls, "spars": spars,
                  "params": params(scope, main)}

    # GradAllReduce through a plain Executor
    (main, startup, loss), scope, exe = fresh(mlp, "mlp_sgd")
    GradAllReduce().transpile(startup, main, rank=rank,
                              endpoints=list(env.trainer_endpoints),
                              current_endpoint=env.current_endpoint)
    ls = [float(exe.run(main, feed=_local(b, rank, n), fetch_list=[loss],
                        scope=scope)[0]) for b in mlp_batches(5)]
    out["gar"] = {"losses": ls, "params": params(scope, main)}

    # LocalSGD on different data a rank
    for k_steps, steps in ((2, 6), (4, 6)):
        (main, startup, loss), scope, exe = fresh(lsgd, "lsgd")
        LocalSGD(local_steps=k_steps).transpile(
            startup, main, rank=rank, endpoints=list(env.trainer_endpoints),
            current_endpoint=env.current_endpoint)
        exe.run(startup, scope=scope)
        load_scope_arrays(scope, {**init["lsgd"], **{
            v.name: np.zeros(v.shape, "float32")
            for v in main.global_block().vars.values()
            if v.persistable and v.name not in init["lsgd"]
            and not v.is_data}}, main, "cpu")
        rng = np.random.RandomState(100 + rank)
        W = np.random.RandomState(9).randn(8, 1).astype("float32")
        ls = []
        for _ in range(steps):
            xb = rng.randn(16, 8).astype("float32")
            ls.append(float(exe.run(main, feed={"x": xb, "y": xb @ W},
                                    fetch_list=[loss], scope=scope)[0]))
        out[f"lsgd_{k_steps}"] = {"losses": ls,
                                  "w": scope.get_numpy("fc_0.w_0").tolist()}

    # dropout: the ranks' masks differ, the replicas stay equal
    (main, _, loss), scope, exe = fresh(mlp, "mlp_sgd", dropout=0.5)
    # the dropout's output (a float fetch: the rank's own value); an
    # integer Mask fetch would be refused as rank-dependent
    mask = next(op.outputs["Out"][0] for op in main.global_block().ops
                if op.type == "dropout")
    prog = fl.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    b = mlp_batches(1)[0]
    same = {"x": b["x"][:8], "y": b["y"][:8]}
    m = None
    for _ in range(2):
        _, m = exe.run(prog, feed=same, fetch_list=[loss, mask], scope=scope)
    out["drop"] = {"mask": (np.asarray(m) == 0).astype(int).tolist(),
                   "params": params(scope, main)}

    del torch
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


# -- the JAX side and the launch ----------------------------------------------


def _jax_init(jf, build, *a, **kw):
    built = build(jf, *a, **kw)
    main, startup = built[0], built[1]
    scope = jf.Scope()
    with jf.scope_guard(scope):
        exe = jf.Executor(jf.CPUPlace())
        exe.run(startup)
    arrays = {v.name: np.asarray(scope.get_numpy(v.name))
              for v in main.list_vars()
              if v.persistable and not v.is_data
              and scope.find_var(v.name) is not None}
    return arrays


def first_moments(main, get):
    """{parameter name: ``get(name)`` of its Adam first moment}."""
    return {v.accumulator_owner: get(v.name)
            for v in main.global_block().vars.values()
            if getattr(v, "is_accumulator", False) and "moment1" in v.name}


def _jax_train(jf, build, feeds, prog_fn=None, *a, **kw):
    """JAX's losses, parameters and Adam first moments (empty under
    another optimizer) after training on ``feeds``."""
    built = build(jf, *a, **kw)
    main, startup, loss = built[0], built[1], built[2]
    scope = jf.Scope()
    with jf.scope_guard(scope):
        exe = jf.Executor(jf.CPUPlace())
        exe.run(startup)
        prog = prog_fn(main, loss) if prog_fn else main
        outs = [exe.run(prog, feed=f, fetch_list=[loss]) for f in feeds]
        prm = {p.name: np.asarray(scope.get_numpy(p.name))
               for p in main.all_parameters()}
        m1 = first_moments(main, lambda n: np.asarray(scope.get_numpy(n)))
    return [float(np.asarray(o[0]).reshape(())) for o in outs], prm, m1


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import paddle_tpu as jf

    d = tmp_path_factory.mktemp("world")
    init = {"mlp_sgd": _jax_init(jf, mlp), "mlp_adam": _jax_init(jf, mlp,
                                                                   "adam"),
            "moe": _jax_init(jf, moe), "dgc": _jax_init(jf, dgc),
            "lsgd": _jax_init(jf, lsgd)}
    np.savez(str(d / "init.npz"), **{k: np.array(v, dtype=object)
                                     for k, v in init.items()})
    from paddle_tpu_torch.parallel.env import free_port

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    # one intra-op thread a rank: the ranks share the machine with
    # the other test workers, and the models are small
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={WORLD}", f"--started_port={free_port()}",
         "--backend=gloo", f"--run_dir={d / 'run'}",
         os.path.abspath(__file__), "--worker", str(d)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ranks = [json.loads((d / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return {"dir": d, "ranks": ranks, "init": init}


def _replicas_equal(ranks, key):
    p0 = ranks[0][key]["params"]
    for r in ranks[1:]:
        for n in p0:
            assert np.array_equal(np.asarray(p0[n]), np.asarray(
                r[key]["params"][n])), (key, n)


def _close_params(got, want, rtol, atol, key):
    for n in want:
        np.testing.assert_allclose(np.asarray(got[n]), want[n], rtol=rtol,
                                   atol=atol, err_msg=f"{key}: {n}")


def test_data_parallel_matches_jax_with_data_parallel(world):
    import paddle_tpu as jf

    ls, prm, _ = _jax_train(
        jf, mlp, mlp_batches(5),
        lambda m, loss: jf.CompiledProgram(m).with_data_parallel(
            loss_name=loss.name))
    ranks = world["ranks"]
    for r in ranks:
        np.testing.assert_allclose(r["dp"]["losses"], ls, rtol=DP_RTOL,
                                   atol=DP_ATOL)
    _close_params(ranks[0]["dp"]["params"], prm, DP_RTOL, DP_ATOL, "dp")
    _replicas_equal(ranks, "dp")


def test_hogwild_threads_are_refused_in_a_world(world):
    for r in world["ranks"]:
        assert "Hogwild threads cannot share" in r["hogwild"]


def test_zero1_matches_jax_adam_and_unsharded_bit_for_bit(world):
    import paddle_tpu as jf

    ls, prm, _ = _jax_train(jf, mlp, mlp_batches(6, seed=11), None,
                            "adam")
    ranks = world["ranks"]
    nsh, skipped = ranks[0]["zero1_sharded"]
    # every non-scalar accumulator (two moments of four parameters)
    assert skipped == [] and nsh == len(ranks[0]["zero1"]["moments"]) \
        == 8, (nsh, skipped)
    for r in ranks:
        np.testing.assert_allclose(r["zero1"]["losses"], ls, rtol=1e-4,
                                   atol=1e-5)
        assert r["zero1"]["losses"] == r["adam"]["losses"]
        for n in prm:
            assert np.array_equal(np.asarray(r["zero1"]["params"][n]),
                                  np.asarray(r["adam"]["params"][n])), n
    _close_params(ranks[0]["zero1"]["params"], prm, 1e-4, 1e-5, "zero1")
    # a quarter of every moment a rank, whole moments without ZeRO
    for name, shape in ranks[0]["zero1"]["moments"].items():
        whole = ranks[0]["adam"]["moments"][name]
        assert shape[0] * WORLD == whole[0] or \
            np.prod(shape) * WORLD == np.prod(whole), (name, shape, whole)


@pytest.mark.parametrize("dp,ep,dispatch", EP_CASES)
def test_expert_parallel_matches_the_dense_moe(world, dp, ep, dispatch):
    import paddle_tpu as jf

    ls, prm, m1 = _jax_train(jf, moe, moe_batches(3))
    key = f"ep_{dp}_{ep}_{dispatch}"
    ranks = world["ranks"]
    E = 4
    for r in ranks:
        np.testing.assert_allclose(r[key]["losses"], ls, rtol=EP_RTOL,
                                   atol=EP_ATOL)

    def whole(part, name, want):
        pieces = [np.asarray(r[key][part][name]) for r in ranks]
        if pieces[0].shape == want.shape:
            return pieces[0]
        # rank = dp index * ep + ep index holds experts
        # [ep index * E/ep, (ep index + 1) * E/ep)
        assert pieces[0].shape[0] * ep == E, name
        return np.concatenate(pieces[:ep])

    for name, want in prm.items():
        np.testing.assert_allclose(whole("params", name, want), want,
                                   rtol=EP_RTOL, atol=EP_ATOL,
                                   err_msg=f"{key}: {name}")
    # Adam moves a parameter by about lr a step whatever its gradient's
    # scale; its first moment holds the gradients themselves (a
    # gradient without its 1/n, or zeroed, reads 0.5-1 here)
    assert set(m1) == set(prm)
    for name, want in m1.items():
        got = whole("m1", name, want)
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= EP_GRAD_RTOL, (key, name, err)


def test_fleet_collective_minimize_and_sharding_strategy(world):
    import paddle_tpu as jf

    ranks = world["ranks"]
    ls, prm, _ = _jax_train(jf, mlp, mlp_batches(5))
    for r, rk in enumerate(ranks):
        f = rk["fleet"]
        assert (f["index"], f["num"], f["first"]) == (r, WORLD, r == 0)
        np.testing.assert_allclose(f["losses"], ls, rtol=DP_RTOL,
                                   atol=DP_ATOL)
        fz = rk["fleet_zero"]
        assert fz["sharded"], "sharding=True annotated no moment"
        assert fz["losses"] == rk["adam"]["losses"]
    _close_params(ranks[0]["fleet"]["params"], prm, DP_RTOL, DP_ATOL,
                  "fleet")


def test_dgc_dense_before_rampup_then_sparsifies(world):
    import paddle_tpu as jf

    main, startup, loss, enc = dgc(jf)
    scope = jf.Scope()
    with jf.scope_guard(scope):
        exe = jf.Executor(jf.CPUPlace())
        exe.run(startup)
        jl = [float(np.asarray(exe.run(main, feed=b, fetch_list=[loss])[0]))
              for b in dgc_batches(3)]
    ranks = world["ranks"]
    for rk in ranks:
        d = rk["dgc"]
        np.testing.assert_allclose(d["losses"][:3], jl, rtol=DP_RTOL,
                                   atol=DP_ATOL)
        assert d["spars"][0] < 0.1, d["spars"][:5]
        assert np.mean(d["spars"][5:]) > 0.6, d["spars"]
        assert all(np.isfinite(d["losses"]))
        assert d["losses"][-1] < d["losses"][0] * 0.5, d["losses"]
    _replicas_equal(ranks, "dgc")


def test_dgc_op_dense_before_rampup_matches_jax():
    import torch

    import paddle_tpu as jf
    from paddle_tpu.core.registry import get_op_def as jget
    from paddle_tpu_torch.core.registry import LoweringContext, get_op_def

    class _Op:
        def __init__(self, attrs):
            self.attrs = attrs
            self.type = "dgc"

    rng = np.random.RandomState(1)
    g = rng.randn(3, 3).astype("float32")
    u = rng.randn(3, 3).astype("float32")
    v = rng.randn(3, 3).astype("float32")
    del jf
    for step in (2.0, 7.0):
        attrs = {"m": 0.9, "sparsity": [0.5], "rampup_begin_step": 5.0,
                 "rampup_step": 4.0}
        ins = {"U": [u], "V": [v], "Grad": [g],
               "CurrentStep": [np.array([step], "float32")]}
        import jax.numpy as jnp

        from paddle_tpu.core.registry import LoweringContext as JCtx

        want = jget("dgc").lower(JCtx(), _Op(attrs), {
            k: [jnp.asarray(a) for a in vs] for k, vs in ins.items()})
        got = get_op_def("dgc").lower(LoweringContext("cpu"), _Op(attrs), {
            k: [torch.from_numpy(a) for a in vs] for k, vs in ins.items()})
        for slot in ("UOut", "VOut", "EncodeGrad"):
            np.testing.assert_allclose(got[slot][0].numpy(),
                                       np.asarray(want[slot][0]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {slot}")


@pytest.mark.parametrize("step", [1.0, 6.0])
@pytest.mark.parametrize("op_type", ["dgc_momentum", "dgc_clip_by_norm"])
def test_dgc_momentum_and_clip_lowerings_match_jax(op_type, step):
    """Before the rampup (step 1 < 5) and after it (step 6)."""
    import jax.numpy as jnp
    import torch

    from paddle_tpu.core.registry import LoweringContext as JCtx
    from paddle_tpu.core.registry import get_op_def as jget
    from paddle_tpu_torch.core.registry import LoweringContext, get_op_def

    class _Op:
        type = op_type

        def __init__(self, attrs):
            self.attrs = attrs

    rng = np.random.RandomState(2)
    f = lambda *shape: rng.randn(*shape).astype("float32")
    cur = np.array([step], "float32")
    if op_type == "dgc_momentum":
        ins = {"Param": [f(4, 3)], "Grad": [f(4, 3)], "Velocity": [f(4, 3)],
               "LearningRate": [np.array([0.1], "float32")],
               "current_step": [cur], "nranks": [np.array([2.0], "float32")]}
        attrs = {"mu": 0.9, "use_nesterov": False, "rampup_begin_step": 5.0}
    else:
        ins = {"X": [5 * f(4, 3)], "current_step": [cur]}
        attrs = {"rampup_begin_step": 5.0, "max_norm": 1.0}
    want = jget(op_type).lower(JCtx(), _Op(attrs), {
        k: [jnp.asarray(a) for a in v] for k, v in ins.items()})
    got = get_op_def(op_type).lower(LoweringContext("cpu"), _Op(attrs), {
        k: [torch.from_numpy(a) for a in v] for k, v in ins.items()})
    assert set(got) == set(want)
    for slot in want:
        np.testing.assert_allclose(got[slot][0].numpy(),
                                   np.asarray(want[slot][0]), rtol=1e-6,
                                   atol=1e-7, err_msg=slot)


def test_grad_allreduce_transpile_equals_data_parallel(world):
    import paddle_tpu as jf

    ls, prm, _ = _jax_train(jf, mlp, mlp_batches(5))
    ranks = world["ranks"]
    # a plain run fetches each rank's own loss: their mean is the global
    # batch's
    np.testing.assert_allclose(
        np.mean([rk["gar"]["losses"] for rk in ranks], axis=0), ls,
        rtol=DP_RTOL, atol=DP_ATOL)
    _close_params(ranks[0]["gar"]["params"], prm, DP_RTOL, DP_ATOL, "gar")
    _replicas_equal(ranks, "gar")


@pytest.mark.parametrize("local_steps,expect_equal", [(2, True),
                                                      (4, False)])
def test_localsgd_syncs_every_k_steps(world, local_steps, expect_equal):
    ranks = world["ranks"]
    ws = [np.asarray(r[f"lsgd_{local_steps}"]["w"]) for r in ranks]
    l0 = ranks[0][f"lsgd_{local_steps}"]["losses"]
    assert l0[-1] < l0[0], l0
    if expect_equal:
        for w in ws[1:]:
            np.testing.assert_allclose(w, ws[0], rtol=1e-6, atol=1e-7)
    else:
        assert max(np.abs(w - ws[0]).max() for w in ws[1:]) > 1e-6


def _resume(world, build, key, feeds, *a, **kw):
    import paddle_tpu_torch as fl

    fl.set_flags({"optimizer_fuse": "off"})
    try:
        main, startup, loss = build(fl, *a, **kw)[:3]
        scope = fl.Scope()
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup, scope=scope)
        fl.io.load_checkpoint(str(world["dir"] / key), main_program=main,
                              scope=scope, device="cpu")
        got = [float(exe.run(main, feed=f, fetch_list=[loss],
                             scope=scope)[0]) for f in feeds]
    finally:
        fl.set_flags({"optimizer_fuse": "auto"})
    return got


def test_zero1_checkpoint_restores_in_another_world(world):
    want = world["ranks"][0]["ck_zero"]["want"]
    got = _resume(world, mlp, "ck_zero", mlp_batches(3, seed=12), "adam")
    np.testing.assert_allclose(got, want, rtol=CK_RTOL, atol=CK_ATOL)
    # the JAX package reads the port's sharded checkpoint whole
    import paddle_tpu as jf

    arrays = jf.io.load_checkpoint_arrays(str(world["dir"] / "ck_zero"))
    moments = [n for n in arrays if "moment" in n]
    assert moments and all(arrays[n].shape[0] in (16, 32, 4)
                           for n in moments)


def test_expert_parallel_checkpoint_restores_dense(world):
    want = world["ranks"][0]["ck_ep"]["want"]
    got = _resume(world, moe, "ck_ep", moe_batches(3, seed=2))
    np.testing.assert_allclose(got, want, rtol=CK_RTOL, atol=1e-6)


def test_dropout_masks_differ_between_ranks_and_replicas_stay_equal(world):
    ranks = world["ranks"]
    masks = [np.asarray(r["drop"]["mask"]) for r in ranks]
    assert any(not np.array_equal(masks[0], m) for m in masks[1:])
    _replicas_equal(ranks, "drop")


# -- in-process checks --------------------------------------------------------


def test_refusals_name_their_roadmap_items():
    import paddle_tpu_torch as fl
    from paddle_tpu_torch import partition
    from paddle_tpu_torch.parallel import fleet as fleet_mod

    main, _, loss = mlp(fl)
    # what stays refused of tensor / sequence / pipeline parallelism:
    # tensor parallelism inside pipelined stages (JAX's words), a
    # pipeline without cuts, a mesh larger than the world
    with pytest.raises(NotImplementedError, match="pipeline_train_step_3d"):
        fl.CompiledProgram(main).with_pipeline(mp=2)
    with pytest.raises(ValueError, match="no pipeline cuts"):
        fl.CompiledProgram(main).with_pipeline()
    with pytest.raises(ValueError, match="needs 2 processes"):
        fl.CompiledProgram(main).with_partitioning(
            partition.PartitionConfig(mesh_axes={"dp": 1, "tp": 2}))
    with pytest.raises(ValueError, match="needs 2 processes"):
        fl.CompiledProgram(main).with_sequence_parallel(2)
    with pytest.raises(NotImplementedError, match="A11"):
        fl.CompiledProgram(main).validate()
    # the parameter-server mode is ported (ps/): a pserver strategy gets
    # the PS optimizer, no refusal
    strategy = fleet_mod.DistributedStrategy()
    strategy.mode = "pserver"
    assert isinstance(
        fleet_mod.fleet.distributed_optimizer(fl.optimizer.SGD(0.1),
                                              strategy),
        fleet_mod.PSDistributedOptimizer)
    assert fl.optimizer.PipelineOptimizer(fl.optimizer.SGD(0.1))._schedule \
        == "gpipe"


def test_one_strategy_per_compile():
    import paddle_tpu as jf
    import paddle_tpu_torch as fl

    for pkg in (jf, fl):
        main, _, loss = moe(pkg)
        c = pkg.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
        with pytest.raises(ValueError, match="mutually exclusive"):
            c.with_expert_parallel(ep=1)


def test_transpiled_program_without_a_world_raises():
    import paddle_tpu as jf
    import paddle_tpu_torch as fl
    from paddle_tpu.transpiler.collective import GradAllReduce as JGar
    from paddle_tpu_torch.transpiler import GradAllReduce

    for pkg, gar, place in ((jf, JGar, jf.CPUPlace()),
                            (fl, GradAllReduce, fl.CPUPlace())):
        main, startup, loss = mlp(pkg)
        gar().transpile(startup, main, rank=0,
                        endpoints=["127.0.0.1:1", "127.0.0.1:2"],
                        current_endpoint="127.0.0.1:1")
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            exe = pkg.Executor(place)
            exe.run(startup)
            with pytest.raises(RuntimeError, match="transpiled for 2"):
                exe.run(main, feed=mlp_batches(1)[0], fetch_list=[loss])


def test_with_data_parallel_at_one_process_is_the_plain_step():
    """No world: the data-parallel step is the plain one, bit for bit
    (the feed is the whole batch), and the transpiled programs'
    collective ops are identities."""
    import paddle_tpu_torch as fl

    fl.set_flags({"optimizer_fuse": "off"})
    try:
        res = []
        for compiled in (False, True):
            main, startup, loss = mlp(fl, "adam")
            scope = fl.Scope()
            exe = fl.Executor(fl.CPUPlace())
            exe.run(startup, scope=scope)
            prog = (fl.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name) if compiled else main)
            res.append([float(exe.run(prog, feed=b, fetch_list=[loss],
                                      scope=scope)[0])
                        for b in mlp_batches(3)])
            if compiled:
                assert prog._mesh.shape == {"dp": 1}
    finally:
        fl.set_flags({"optimizer_fuse": "auto"})
    assert res[0] == res[1]


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.path.insert(0, REPO)
        _worker(sys.argv[2])
