"""Pipeline parallelism in the port (``PipelineOptimizer`` +
``with_pipeline``, ``parallel/pipeline.py``) and gradient merge inside
a data- or expert-parallel step, against the JAX package, on the CPU.

The JAX side runs in the pytest process on the conftest's 8 virtual
devices; the port runs in one gloo world of 4 spawned once (``python
-m paddle_tpu_torch.distributed.launch --nproc_per_node 4 --backend
gloo tests/test_torch_pipeline.py --worker DIR``), a rank a stage.
Both packages start from JAX's startup values. Scenarios and
tolerances (JAX's own):

* ``pp4_*``: ``_pipe_mlp`` (three fc cuts) trained 4 SGD steps at 4
  stages, GPipe and 1F1B, against JAX's PipelineOptimizer runs and the
  unpipelined program at rtol 1e-4 / atol 1e-5 (twins of test_
  pipeline.py::test_program_pipeline_optimizer_training_parity and
  _1f1b_); with Adam under ``GradientClipByGlobalNorm`` against the
  unpipelined port (the clip's squared sums summed over the stages);
* ``lib``: ``pipeline_train_step_1f1b`` at S 4, M 12 against
  ``pipeline_train_step`` (GPipe) and JAX's, and a stash of at most
  2(S - 1) + 1 microbatches where GPipe holds M; ``one_f_one_b_ticks``;
* ``3d``: ``pipeline_train_step_3d`` at mp 2 x pp 2 against JAX's
  dp 2 x mp 2 x pp 2 and a dense run (loss 1e-5, gradients 2e-5);
* ``dp_*``: ``with_pipeline(dp=2)`` under GPipe and 1F1B against JAX's
  dp 4 x pp 2 runs and the unpipelined program (1e-4 / 1e-5);
* ``ratio_*``: the masked-mean (ratio of sums) loss with microbatches
  of unequal mask counts, GPipe and 1F1B, against the unpipelined run
  (1e-5 / 1e-6 losses, 1e-4 / 1e-6 parameters);
* ``bad_stages``: a 3-stage program on a pp mesh of 4 raises naming
  its stages; the refusals at ``minimize`` (batch norm's running
  statistics) and of ``mp`` run in the pytest process;
* ``merge_dp`` / ``merge_ep``: ``GradientMergeOptimizer`` (k 2) inside
  a data-parallel world of 4 (an MLP under Adam, each rank its rows)
  and at ep 4 (``switch_moe``, psum dispatch) against JAX's merged run
  on the whole batch (1e-4 / 1e-5; MoE 2e-5 / 1e-6, test_moe.py::
  test_expert_parallel_composes_with_gradient_merge), one all-reduce
  of the merged gradients a data-parallel step.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
WIDTH = 32


# -- programs, built with either package --------------------------------------


def pipe_mlp(pkg, n_cuts=3, schedule=None, opt="sgd"):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [WIDTH])
        label = pkg.layers.data("label", [1], dtype="int64")
        h1 = pkg.layers.fc(x, WIDTH, act="relu")
        h2 = pkg.layers.fc(h1, WIDTH, act="relu")
        h3 = pkg.layers.fc(h2, WIDTH, act="relu")
        logits = pkg.layers.fc(h3, 10)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, label))
        o = (pkg.optimizer.SGD(0.1) if opt == "sgd" else
             pkg.optimizer.Adam(0.01, grad_clip=pkg.clip.
                                GradientClipByGlobalNorm(0.5)))
        if schedule:
            pkg.optimizer.PipelineOptimizer(
                o, cut_list=[h1, h2, h3][:n_cuts], num_microbatches=4,
                schedule=schedule).minimize(loss)
        else:
            o.minimize(loss)
    return main, startup, loss


def mlp_feeds(steps=4, batch=16):
    rng = np.random.RandomState(5)
    return [{"x": rng.randn(batch, WIDTH).astype("float32"),
             "label": rng.randint(0, 10, (batch, 1)).astype("int64")}
            for _ in range(steps)]


def ratio_prog(pkg, schedule=None):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [8])
        w = pkg.layers.data("w", [1])
        h = pkg.layers.fc(x, 8, act="relu")
        y = pkg.layers.fc(h, 1)
        num = pkg.layers.reduce_sum(
            pkg.layers.elementwise_mul(pkg.layers.square(y), w))
        den = pkg.layers.reduce_sum(w)
        loss = pkg.layers.elementwise_div(num, den)
        if schedule:
            pkg.optimizer.PipelineOptimizer(
                pkg.optimizer.SGD(0.1), cut_list=[h], num_microbatches=4,
                schedule=schedule).minimize(loss)
        else:
            pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def ratio_feed():
    rng = np.random.RandomState(7)
    xv = rng.randn(16, 8).astype("f")
    wv = (rng.rand(16, 1) < 0.6).astype("f")
    wv[0] = 1.0
    wv[4] = wv[8] = wv[12] = 1.0
    return {"x": xv, "w": wv}


def merge_mlp(pkg, k=2):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 13
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [16])
        y = pkg.layers.data("y", [1], dtype="int64")
        h = pkg.layers.fc(x, 32, act="relu")
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            pkg.layers.fc(h, 4), y))
        pkg.optimizer.GradientMergeOptimizer(
            pkg.optimizer.Adam(1e-2), k_steps=k).minimize(loss)
    return main, startup, loss


def merge_feeds(steps=3):
    rng = np.random.RandomState(3)
    return [{"x": rng.randn(16, 16).astype("float32"),
             "y": rng.randint(0, 4, (16, 1)).astype("int64")}
            for _ in range(steps)]


def merge_moe(pkg, k=2):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 21
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [6, 8])
        y = pkg.layers.data("y", [6, 8])
        out, aux = pkg.layers.switch_moe(x, 4, 16, capacity_factor=8.0)
        loss = pkg.layers.mean(pkg.layers.elementwise_add(
            pkg.layers.mean(pkg.layers.square_error_cost(out, y)),
            pkg.layers.scale(aux, scale=0.01)))
        pkg.optimizer.GradientMergeOptimizer(
            pkg.optimizer.Adam(5e-3), k_steps=k).minimize(loss)
    return main, startup, loss


def moe_feed():
    rng = np.random.RandomState(4)
    x = rng.randn(8, 6, 8).astype("float32")
    return {"x": x, "y": np.tanh(x[..., ::-1].copy())}


def _lib_params(S, D, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(S, D, D) * 0.3).astype("float32"),
            "b": (rng.randn(S, D) * 0.1).astype("float32")}


def _3d_data():
    rng = np.random.RandomState(0)
    S, d, h, M, mb = 2, 8, 16, 4, 4
    params = {"w1": (rng.randn(S, d, h) * 0.3).astype("float32"),
              "b1": (rng.randn(S, h) * 0.1).astype("float32"),
              "w2": (rng.randn(S, h, d) * 0.3).astype("float32"),
              "b2": (rng.randn(S, d) * 0.1).astype("float32")}
    x = rng.randn(M, mb, d).astype("float32")
    tgt = rng.randn(M, mb, d).astype("float32")
    return params, x, tgt


# -- the worker ---------------------------------------------------------------


def _worker(out_dir):
    import torch

    import paddle_tpu_torch as fl
    from paddle_tpu_torch.core.pipeline_program import sync_stage_state
    from paddle_tpu_torch.io import load_scope_arrays
    from paddle_tpu_torch.parallel import comm
    from paddle_tpu_torch.parallel import pipeline as P
    from paddle_tpu_torch.parallel.env import init_parallel_env
    from paddle_tpu_torch.parallel.mesh import make_mesh

    env = init_parallel_env()
    rank = env.rank
    fl.set_flags({"optimizer_fuse": "off"})
    init = dict(np.load(os.path.join(out_dir, "init.npz"), allow_pickle=True))
    init = {k: v.item() for k, v in init.items()}
    out = {}

    def train(built, key, feeds, compile_fn=None, local=None):
        main, startup, loss = built
        scope = fl.Scope()
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup, scope=scope)
        if key is not None:
            load_scope_arrays(scope, init[key], main, "cpu")
        prog = compile_fn(main) if compile_fn else main
        ls = [float(np.asarray(exe.run(
            prog, feed=local(f) if local else f, fetch_list=[loss],
            scope=scope)[0]).reshape(())) for f in feeds]
        strategy = getattr(prog, "_strategy", None)
        if strategy == "with_pipeline":
            sync_stage_state(main, scope, prog)
        if strategy == "with_expert_parallel":
            # the rank holds its experts: the whole values from a save
            d = os.path.join(out_dir, f"ck_{key}")
            fl.io.save_checkpoint(d, main, scope)
            whole = fl.io.load_checkpoint_arrays(d)
            prm = {p.name: whole[p.name].tolist()
                   for p in main.all_parameters()}
        else:
            prm = {p.name: scope.get_numpy(p.name).tolist()
                   for p in main.all_parameters()}
        return {"losses": ls, "params": prm}

    pp = lambda dp=1: (lambda m: fl.CompiledProgram(m).with_pipeline(dp=dp))
    for sch in ("gpipe", "1f1b"):
        out[f"pp4_{sch}"] = train(pipe_mlp(fl, 3, sch), "mlp", mlp_feeds(),
                                  pp())
        out[f"pp4_adam_{sch}"] = train(pipe_mlp(fl, 3, sch, opt="adam"),
                                       "mlp_adam", mlp_feeds(), pp())
        # dp 2 x pp 2: the stage's ranks feed their dp shard
        di = rank // 2
        out[f"dp_{sch}"] = train(
            pipe_mlp(fl, 1, sch), "mlp", mlp_feeds(3), pp(2),
            lambda f: {k: v[8 * di:8 * di + 8] for k, v in f.items()})
        # the ratio loss at pp 2, both dp shards feeding the same rows
        out[f"ratio_{sch}"] = train(ratio_prog(fl, sch), "ratio",
                                    [ratio_feed()] * 3, pp(2))

    # a 3-stage program on a pp mesh of 4
    main, startup, loss = pipe_mlp(fl, 2, "gpipe")
    scope = fl.Scope()
    exe = fl.Executor(fl.CPUPlace())
    exe.run(startup, scope=scope)
    cp = fl.CompiledProgram(main)
    cp._program = main
    cp._strategy = "with_pipeline"
    cp._mesh = make_mesh({"pp": 4})
    try:
        exe.run(cp, feed=mlp_feeds(1)[0], fetch_list=[loss], scope=scope)
        out["bad_stages"] = "ran"
    except ValueError as e:
        out["bad_stages"] = str(e)

    # the library schedules at S 4
    mesh = make_mesh({"pp": 4})
    S, M, mb, Dm = 4, 12, 2, 16
    lp = {k: torch.from_numpy(v) for k, v in _lib_params(S, Dm).items()}
    rng = np.random.RandomState(0)
    rng.randn(S, Dm, Dm), rng.randn(S, Dm)
    x = torch.from_numpy(rng.randn(M, mb, Dm).astype("float32"))
    tgt = torch.from_numpy(rng.randn(M, mb, Dm).astype("float32"))

    def stage(p, xx):
        return torch.tanh(xx @ p["w"] + p["b"])

    lg, gg = P.pipeline_train_step(
        stage, lambda o, t: ((o - t) ** 2).mean(), mesh)(lp, x, tgt)
    step1 = P.pipeline_train_step_1f1b(
        stage, lambda y, t: ((y - t) ** 2).mean(), mesh)
    l1, g1 = step1(lp, x, tgt)
    fwd = P.pipeline_apply(stage, lp, x, mesh)
    out["lib"] = {"gpipe": [float(lg), {k: v.tolist() for k, v in gg.items()}],
                  "1f1b": [float(l1), {k: v.tolist() for k, v in g1.items()}],
                  "peak_stash": step1.peak_stash, "apply": fwd.tolist(),
                  "ticks": P.one_f_one_b_ticks(M, S)}

    # 3D: mp 2 x pp 2, the stage function's own Megatron collectives
    mesh3 = make_mesh({"mp": 2, "pp": 2})
    mpg = mesh3.group("mp")
    params, xs, tg = _3d_data()

    def stage3(p, xl):
        xl = comm.copy_to(xl, mpg)
        hdn = torch.tanh(xl @ p["w1"] + p["b1"])
        return comm.reduce_from(hdn @ p["w2"], mpg) + p["b2"]

    specs = {"w1": ("pp", None, "mp"), "b1": ("pp", "mp"),
             "w2": ("pp", "mp", None), "b2": ("pp", None)}
    l3, g3 = P.pipeline_train_step_3d(stage3, mesh3, specs)(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(xs), torch.from_numpy(tg))
    out["3d"] = [float(l3), {k: v.tolist() for k, v in g3.items()}]

    # gradient merge inside a data-parallel world (each rank 4 of 16
    # rows) and at ep 4 (every rank the whole batch)
    c0 = comm.STATS.snapshot()["comm_calls_total"]
    out["merge_dp"] = train(
        merge_mlp(fl), "merge_mlp", merge_feeds(),
        lambda m: fl.CompiledProgram(m).with_data_parallel(),
        lambda f: {k: v[4 * rank:4 * rank + 4] for k, v in f.items()})
    out["merge_dp"]["calls"] = comm.STATS.snapshot()["comm_calls_total"] - c0
    out["merge_ep"] = train(
        merge_moe(fl), "merge_moe", [moe_feed()] * 2,
        lambda m: fl.CompiledProgram(m).with_expert_parallel(ep=4))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _init(pkg, built):
    main, startup = built[0], built[1]
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        pkg.Executor(pkg.CPUPlace()).run(startup)
    return {v.name: np.asarray(scope.get_numpy(v.name))
            for v in main.list_vars()
            if v.persistable and not v.is_data
            and scope.find_var(v.name) is not None}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import paddle_tpu as jf
    from paddle_tpu_torch.parallel.env import free_port

    d = tmp_path_factory.mktemp("pp")
    init = {"mlp": _init(jf, pipe_mlp(jf)),
            "mlp_adam": _init(jf, pipe_mlp(jf, opt="adam")),
            "ratio": _init(jf, ratio_prog(jf)),
            "merge_mlp": _init(jf, merge_mlp(jf)),
            "merge_moe": _init(jf, merge_moe(jf))}
    np.savez(str(d / "init.npz"), **{k: np.array(v, dtype=object)
                                     for k, v in init.items()})
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={WORLD}", f"--started_port={free_port()}",
         "--backend=gloo", f"--run_dir={d / 'run'}",
         os.path.abspath(__file__), "--worker", str(d)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {"ranks": [json.loads((d / f"rank{r}.json").read_text())
                      for r in range(WORLD)], "init": init}


def _jax_train(jf, built, feeds, prog_fn=None):
    main, startup, loss = built
    scope = jf.Scope()
    with jf.scope_guard(scope):
        exe = jf.Executor(jf.CPUPlace())
        exe.run(startup)
        prog = prog_fn(main) if prog_fn else main
        ls = [float(np.asarray(exe.run(prog, feed=f, fetch_list=[loss])[0])
                    .reshape(())) for f in feeds]
        prm = {p.name: np.asarray(scope.get_numpy(p.name))
               for p in main.all_parameters()}
    return ls, prm


def _port_plain(built, init, feeds):
    import paddle_tpu_torch as fl
    from paddle_tpu_torch.io import load_scope_arrays

    main, startup, loss = built
    old = fl.get_flags(["optimizer_fuse"])
    fl.set_flags({"optimizer_fuse": "off"})
    try:
        scope = fl.Scope()
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup, scope=scope)
        load_scope_arrays(scope, init, main, "cpu")
        ls = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
        prm = {p.name: scope.get_numpy(p.name)
               for p in main.all_parameters()}
    finally:
        fl.set_flags(old)
    return ls, prm


def _close(run, ls, prm, rtol, atol, key, prm_rtol=None):
    np.testing.assert_allclose(run["losses"], ls, rtol=rtol, atol=atol,
                               err_msg=key)
    assert prm and set(run["params"]) == set(prm)
    for n in prm:
        np.testing.assert_allclose(np.asarray(run["params"][n]), prm[n],
                                   rtol=prm_rtol or rtol, atol=atol,
                                   err_msg=f"{key}: {n}")


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_four_stage_pipeline_trains_like_jax(world, schedule):
    import paddle_tpu as jf

    base_l, base_p = _jax_train(jf, pipe_mlp(jf), mlp_feeds())
    pp_l, pp_p = _jax_train(
        jf, pipe_mlp(jf, 3, schedule), mlp_feeds(),
        lambda m: jf.CompiledProgram(m).with_pipeline())
    for r in world["ranks"]:
        run = r[f"pp4_{schedule}"]
        _close(run, base_l, base_p, 1e-4, 1e-5, schedule)
        _close(run, pp_l, pp_p, 1e-4, 1e-5, schedule)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_clips_by_the_whole_models_norm(world, schedule):
    ls, prm = _port_plain(pipe_mlp(__import__("paddle_tpu_torch"),
                                   opt="adam"),
                          world["init"]["mlp_adam"], mlp_feeds())
    for r in world["ranks"]:
        _close(r[f"pp4_adam_{schedule}"], ls, prm, 1e-4, 1e-5, schedule)


def test_1f1b_library_step_matches_gpipe_with_an_o_s_stash(world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from paddle_tpu.parallel.pipeline import (one_f_one_b_ticks,
                                              pipeline_train_step)

    S, M, mb, D = 4, 12, 2, 16
    rng = np.random.RandomState(0)
    params = {"w": jnp.asarray(rng.randn(S, D, D) * 0.3, jnp.float32),
              "b": jnp.asarray(rng.randn(S, D) * 0.1, jnp.float32)}
    x = jnp.asarray(rng.randn(M, mb, D), jnp.float32)
    tgt = jnp.asarray(rng.randn(M, mb, D), jnp.float32)
    mesh = Mesh(np.array(jax.devices()[:S]), ("pp",))
    lj, gj = pipeline_train_step(
        lambda p, xx: jnp.tanh(xx @ p["w"] + p["b"]),
        lambda o, t: jnp.mean((o - t) ** 2), mesh)(params, x, tgt)
    want_fwd = x
    for s in range(S):
        want_fwd = jnp.tanh(want_fwd @ params["w"][s] + params["b"][s])
    for r in world["ranks"]:
        lib = r["lib"]
        np.testing.assert_allclose(np.asarray(lib["apply"]),
                                   np.asarray(want_fwd), rtol=1e-5,
                                   atol=1e-5)
        for key in ("gpipe", "1f1b"):
            np.testing.assert_allclose(lib[key][0], float(lj), rtol=1e-5)
            for k in gj:
                np.testing.assert_allclose(np.asarray(lib[key][1][k]),
                                           np.asarray(gj[k]), rtol=1e-4,
                                           atol=1e-5, err_msg=f"{key} {k}")
        assert lib["ticks"] == one_f_one_b_ticks(M, S) == M + 2 * (S - 1)
        # 1F1B's stash is a function of S, not of M
        assert lib["peak_stash"] <= 2 * (S - 1) + 1 < M


def test_3d_step_at_mp2_pp2_matches_jax_3d_and_dense(world):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as Pspec

    from paddle_tpu.parallel.pipeline import pipeline_train_step_3d

    params, x, tgt = _3d_data()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                ("dp", "mp", "pp"))
    specs = {"w1": Pspec("pp", None, "mp"), "b1": Pspec("pp", "mp"),
             "w2": Pspec("pp", "mp", None), "b2": Pspec("pp", None)}

    def stage_fn(p, xl):
        hdn = jnp.tanh(xl @ p["w1"] + p["b1"])
        return lax.psum(hdn @ p["w2"], "mp") + p["b2"]

    lj, gj = jax.jit(pipeline_train_step_3d(stage_fn, mesh, specs))(
        params, jnp.asarray(x), jnp.asarray(tgt))

    def ref_loss(p):
        outs = []
        for m in range(x.shape[0]):
            y = x[m]
            for s in range(2):
                y = (jnp.tanh(y @ p["w1"][s] + p["b1"][s]) @ p["w2"][s]
                     + p["b2"][s])
            outs.append(y)
        return jnp.mean((jnp.stack(outs) - tgt) ** 2)

    rl, rg = jax.value_and_grad(ref_loss)(params)
    for r in world["ranks"]:
        loss, grads = r["3d"]
        assert abs(loss - float(lj)) < 1e-5 and abs(loss - float(rl)) < 1e-5
        for k in params:
            for want in (gj, rg):
                np.testing.assert_allclose(np.asarray(grads[k]),
                                           np.asarray(want[k]), rtol=2e-5,
                                           atol=2e-5, err_msg=k)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_with_dp_trains_like_jax(world, schedule):
    import paddle_tpu as jf

    base_l, base_p = _jax_train(jf, pipe_mlp(jf), mlp_feeds(3))
    dp_l, dp_p = _jax_train(
        jf, pipe_mlp(jf, 1, schedule), mlp_feeds(3),
        lambda m: jf.CompiledProgram(m).with_pipeline(dp=4))
    for r in world["ranks"]:
        _close(r[f"dp_{schedule}"], base_l, base_p, 1e-4, 1e-5, schedule)
        _close(r[f"dp_{schedule}"], dp_l, dp_p, 1e-4, 1e-5, schedule)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_masked_mean_ratio_loss_pipelines_exactly(world, schedule):
    import paddle_tpu as jf

    base_l, base_p = _jax_train(jf, ratio_prog(jf), [ratio_feed()] * 3)
    for r in world["ranks"]:
        _close(r[f"ratio_{schedule}"], base_l, base_p, 1e-5, 1e-6, schedule,
               prm_rtol=1e-4)


def test_pipeline_refusals():
    import paddle_tpu_torch as fl

    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        x = fl.layers.data("x", [8])
        h = fl.layers.batch_norm(fl.layers.fc(x, 8))
        loss = fl.layers.mean(fl.layers.fc(
            fl.layers.fc(h, 8, act="relu"), 1))
        with pytest.raises(NotImplementedError,
                           match="batch_norm|persistable"):
            fl.optimizer.PipelineOptimizer(
                fl.optimizer.SGD(0.1), cut_list=[h],
                num_microbatches=2).minimize(loss)
    main, _, loss = pipe_mlp(fl, 1, "gpipe")
    with pytest.raises(NotImplementedError, match="pipeline_train_step_3d"):
        fl.CompiledProgram(main).with_pipeline(dp=2, mp=2)
    with pytest.raises(ValueError, match="schedule"):
        fl.optimizer.PipelineOptimizer(fl.optimizer.SGD(0.1),
                                       schedule="zigzag")


def test_a_bad_stage_count_is_refused_in_the_world(world):
    for r in world["ranks"]:
        assert "stages" in r["bad_stages"] and "is 4 devices" in \
            r["bad_stages"]


def test_gradient_merge_inside_data_and_expert_parallel_matches_jax(world):
    import paddle_tpu as jf

    ls, prm = _jax_train(jf, merge_mlp(jf), merge_feeds())
    els, eprm = _jax_train(jf, merge_moe(jf), [moe_feed()] * 2)
    for r in world["ranks"]:
        _close(r["merge_dp"], ls, prm, 1e-4, 1e-5, "merge_dp")
        _close(r["merge_ep"], els, eprm, 2e-5, 1e-6, "merge_ep")
        # a step: one all-reduce of the merged gradients, one of the
        # loss fetch's mean
        assert r["merge_dp"]["calls"] == 2 * len(merge_feeds())


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.path.insert(0, REPO)
        _worker(sys.argv[2])
