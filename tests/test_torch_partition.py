"""The port's logical-axis-rules partitioner (``partition/``) against the
JAX package, on the CPU.

* ``parse_mesh`` / ``parse_rules`` / ``resolve_spec`` give the JAX
  package's results and error messages;
* ``PartitionConfig.resolve`` is pure and runs whole, tensor-parallel
  specs included: on the same programs, meshes and configs its report
  (every var's kind, logical axes, spec, bytes, skip reasons and notes,
  and the summary) equals the JAX package's (the JAX side resolves over
  meshes of the conftest's 8 virtual devices, the port over the same
  {axis: size});
* executing a resolved partition runs ``dp`` and ZeRO: in a gloo world
  of 2 (``tests/test_torch_partition.py --worker DIR`` under the
  launcher, once) the dp, ZeRO-1 and ZeRO-3 trajectories equal JAX's
  single-device one at 1e-5 (twins of test_partition.py::
  test_dp_*_trajectory_matches_single_device), each rank holds half of
  every shardable moment (and under ZeRO-3 half of each parameter),
  and the ``paddle_partition_*`` gauges are in the scrape;
* a partition with a tensor-parallel axis larger than the world is
  refused (tensor parallelism itself: tests/test_torch_tensor_parallel.py).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TRAJ_RTOL, TRAJ_ATOL = 1e-5, 1e-5


def _tagged_model(pkg, seed=7, tagged=True):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    la = (lambda *a: a) if tagged else (lambda *a: None)
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [16])
        y = pkg.layers.data("y", [1], dtype="int64")
        h = pkg.layers.fc(
            x, 32, act="relu",
            param_attr=pkg.ParamAttr(name="p_w1",
                                     logical_axes=la("embed", "mlp")),
            bias_attr=pkg.ParamAttr(name="p_b1", logical_axes=la("mlp")))
        logits = pkg.layers.fc(
            h, 4, param_attr=pkg.ParamAttr(name="p_w2",
                                           logical_axes=la("mlp", "embed")))
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        pkg.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def _batch(step, n=32):
    rng = np.random.RandomState(10_000 + step)
    return {"x": rng.randn(n, 16).astype("float32"),
            "y": rng.randint(0, 4, (n, 1)).astype("int64")}


# -- the worker ---------------------------------------------------------------


def _worker(out_dir):
    import paddle_tpu_torch as fl
    from paddle_tpu_torch import observability, partition
    from paddle_tpu_torch.io import load_scope_arrays
    from paddle_tpu_torch.parallel.env import init_parallel_env

    env = init_parallel_env()
    rank, n = env.rank, env.world_size
    fl.set_flags({"optimizer_fuse": "off"})
    init = {k: v for k, v in np.load(os.path.join(out_dir, "init.npz")).items()}
    out = {}
    for name, zero in (("dp", 0), ("zero1", 1), ("zero3", 3)):
        main, startup, loss = _tagged_model(fl)
        scope = fl.Scope()
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup, scope=scope)
        load_scope_arrays(scope, init, main, "cpu")
        prog = fl.CompiledProgram(main).with_partitioning(
            partition.PartitionConfig(mesh_axes={"dp": n}, zero=zero))
        k = 32 // n
        ls = [float(exe.run(prog, feed={a: v[rank * k:(rank + 1) * k]
                                        for a, v in _batch(s).items()},
                            fetch_list=[loss], scope=scope)[0])
              for s in range(5)]
        held = {v.name: list(scope.find_var(v.name).shape)
                for v in main.global_block().vars.values()
                if v.persistable and not v.is_data
                and scope.find_var(v.name) is not None}
        out[name] = {"losses": ls, "held": held,
                     "summary": prog.partition.summary}
    text = observability.to_prometheus_text()
    out["scrape"] = sorted({ln.split("{")[0] for ln in text.splitlines()
                            if ln.startswith("paddle_partition_")})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import paddle_tpu as jf

    d = tmp_path_factory.mktemp("part")
    main, startup, loss = _tagged_model(jf)
    scope = jf.Scope()
    with jf.scope_guard(scope):
        exe = jf.Executor(jf.CPUPlace())
        exe.run(startup)
        init = {v.name: np.asarray(scope.get_numpy(v.name))
                for v in main.list_vars()
                if v.persistable and not v.is_data}
        single = [float(np.asarray(exe.run(main, feed=_batch(s),
                                           fetch_list=[loss])[0]))
                  for s in range(5)]
    np.savez(str(d / "init.npz"), **init)
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
    return {"single": single, "init": init,
            "ranks": [json.loads((d / f"rank{r}.json").read_text())
                      for r in range(WORLD)]}


@pytest.mark.parametrize("name", ["dp", "zero1", "zero3"])
def test_partitioned_trajectory_matches_jax_single_device(world, name):
    for r in world["ranks"]:
        np.testing.assert_allclose(r[name]["losses"], world["single"],
                                   rtol=TRAJ_RTOL, atol=TRAJ_ATOL)


@pytest.mark.parametrize("name", ["zero1", "zero3"])
def test_zero_holds_half_of_each_shardable_state(world, name):
    import paddle_tpu as jf
    from paddle_tpu import partition as jpartition

    held = world["ranks"][0][name]["held"]
    whole = world["ranks"][0]["dp"]["held"]
    main, _, _ = _tagged_model(jf)
    resolved = jpartition.PartitionConfig(
        mesh_axes={"dp": WORLD}, zero=int(name[-1])).resolve(main)
    for var, spec in resolved.state_shardings.items():
        if "dp" in [a for a in spec if a is not None]:
            d = list(spec).index("dp")
            assert held[var][d] * WORLD == whole[var][d], (var, spec)
    sharded = [v for v, s in resolved.state_shardings.items()
               if "dp" in s]
    assert sharded
    if name == "zero3":
        assert held["p_w1"][0] * WORLD == whole["p_w1"][0]
    # the summary the gauges export is JAX's
    assert world["ranks"][0][name]["summary"] == resolved.summary


def test_partition_gauges_in_the_unified_scrape(world):
    names = set(world["ranks"][0]["scrape"])
    for want in ("paddle_partition_state_sharded_bytes",
                 "paddle_partition_state_replicated_bytes",
                 "paddle_partition_vars_sharded",
                 "paddle_partition_mesh_dp", "paddle_partition_zero"):
        assert want in names, want


# -- the rules and the resolve, in process ------------------------------------


@pytest.mark.parametrize("spec", ["dp=4,tp=2", "dp=4;tp=2", {"dp": 8}, "",
                                  None, " dp = 2 "])
def test_parse_mesh_forms_match_jax(spec):
    from paddle_tpu.partition import parse_mesh as jp
    from paddle_tpu_torch.partition import parse_mesh as tp

    assert tp(spec) == jp(spec)


@pytest.mark.parametrize("spec", ["dp4", "=2", "dp=x", "dp=2,tp"])
def test_parse_mesh_errors_match_jax(spec):
    from paddle_tpu.partition import parse_mesh as jp
    from paddle_tpu_torch.partition import parse_mesh as tp

    with pytest.raises(ValueError) as te:
        tp(spec)
    with pytest.raises(ValueError) as je:
        jp(spec)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("spec", ["batch=dp,embed=,heads=tp", None,
                                  (("mlp", "tp"), ("embed", None)),
                                  "mlp", "=tp"])
def test_parse_rules_match_jax(spec):
    from paddle_tpu.partition import parse_rules as jp
    from paddle_tpu_torch.partition import parse_rules as tp

    try:
        want = jp(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            tp(spec)
        assert str(te.value) == str(e)
        return
    assert tp(spec) == want


@pytest.mark.parametrize("la,rules,sizes,shape", [
    (("batch", None), None, {"dp": 4}, (8, 16)),
    (("embed", "mlp"), None, {"tp": 2}, (16, 32)),
    (("embed", "mlp"), None, {"dp": 2}, (16, 32)),
    (("mlp", "mlp"), (("mlp", "tp"),), {"tp": 2}, (4, 4)),
    (("mlp",), (("mlp", "tp"),), {"tp": 3}, (8,)),
    (("heads", "mlp"), (("heads", None), ("mlp", "tp")), {"tp": 2}, (4, 8)),
    ((None, "mlp"), (("mlp", "tp"),), {"tp": 2}, (4, 8)),
    (("expert", None), None, {"ep": 4}, (8, 3)),
])
def test_resolve_spec_matches_jax(la, rules, sizes, shape):
    from paddle_tpu.partition import DEFAULT_RULES as JR
    from paddle_tpu.partition import resolve_spec as jr
    from paddle_tpu_torch.partition import DEFAULT_RULES as TR
    from paddle_tpu_torch.partition import resolve_spec as tr

    assert tuple(TR) == tuple(JR)
    assert tr(la, rules or TR, sizes, shape) == jr(la, rules or JR, sizes,
                                                   shape)


def _jax_mesh(axes):
    from paddle_tpu.parallel.mesh import make_mesh

    return make_mesh(dict(axes))


def _norm(report):
    out = dict(report)
    out.pop("program_uid")
    out["vars"] = sorted(out["vars"], key=lambda r: r["name"])
    return out


@pytest.mark.parametrize("axes,zero,tagged,var_rules", [
    ({"dp": 8}, 1, True, None),
    ({"dp": 2, "tp": 4}, 1, True, None),
    ({"tp": 8}, 0, True, None),
    ({"dp": 4}, 3, True, None),
    ({"dp": 2, "tp": 2}, 3, True, None),
    ({"tp": 4}, 0, False, ((r"p_w1", ("embed", "mlp")),
                           (r"p_w2", ("mlp", "embed")))),
    ({"dp": 8, "tp": 1}, 1, False, None),
])
def test_resolve_report_equals_jax(axes, zero, tagged, var_rules):
    import paddle_tpu as jf
    import paddle_tpu_torch as fl
    from paddle_tpu import partition as jpartition
    from paddle_tpu_torch import partition

    jm, _, _ = _tagged_model(jf, tagged=tagged)
    tm, _, _ = _tagged_model(fl, tagged=tagged)
    jr = jpartition.PartitionConfig(mesh_axes=axes, zero=zero,
                                    var_rules=var_rules).resolve(
        jm, mesh=_jax_mesh(axes))
    tr = partition.PartitionConfig(mesh_axes=axes, zero=zero,
                                   var_rules=var_rules).resolve(
        tm, mesh=dict(axes))
    assert _norm(tr.report()) == _norm(jr.report())
    assert {k: tuple(v) for k, v in tr.state_shardings.items()} == \
        {k: tuple(v) for k, v in jr.state_shardings.items()}
    assert {k: tuple(v) for k, v in tr.in_shardings.items()} == \
        {k: tuple(v) for k, v in jr.in_shardings.items()}


@pytest.mark.parametrize("explicit", [("tp", None), ("dp", None),
                                      (("dp", "tp"), None), ("sp", None)])
def test_explicit_var_sharding_resolves_as_jax(explicit):
    import paddle_tpu as jf
    import paddle_tpu_torch as fl
    from paddle_tpu import partition as jpartition
    from paddle_tpu_torch import partition

    axes = {"dp": 2, "tp": 4}
    jm, _, _ = _tagged_model(jf)
    tm, _, _ = _tagged_model(fl)
    jm.global_block().var("p_w1").sharding = explicit
    tm.global_block().var("p_w1").sharding = explicit
    jr = jpartition.PartitionConfig(mesh_axes=axes, zero=1).resolve(
        jm, mesh=_jax_mesh(axes))
    tr = partition.PartitionConfig(mesh_axes=axes, zero=1).resolve(
        tm, mesh=dict(axes))
    assert _norm(tr.report()) == _norm(jr.report())


def test_gpt_resolves_as_jax_under_tp():
    import paddle_tpu as jf
    import paddle_tpu_torch as fl
    from paddle_tpu import partition as jpartition
    from paddle_tpu.models import gpt as jgpt
    from paddle_tpu_torch import partition
    from paddle_tpu_torch.models import gpt as tgpt

    reports = []
    for pkg, gpt, part, mesh in ((jf, jgpt, jpartition, None),
                                 (fl, tgpt, partition, None)):
        cfg = gpt.GPTConfig.tiny()
        with pkg.unique_name.guard():
            main, startup, feeds, fetches = gpt.build_gpt_lm(
                cfg, 16, optimizer=pkg.optimizer.Adam(1e-3))
        axes = {"dp": 2, "tp": 2}
        m = _jax_mesh(axes) if pkg is jf else dict(axes)
        reports.append(_norm(part.PartitionConfig(
            mesh_axes=axes, zero=1).resolve(main, mesh=m).report()))
    assert reports[0] == reports[1]
    assert reports[0]["summary"]["vars_sharded"] > 0


def test_partition_flags_drive_config_and_missing_mesh_is_clear():
    import paddle_tpu_torch as fl
    from paddle_tpu_torch import partition

    main, _, _ = _tagged_model(fl)
    with pytest.raises(ValueError, match="partition_mesh"):
        partition.PartitionConfig().resolve(main)
    old = fl.get_flags(["partition_mesh", "partition_rules",
                        "partition_zero"])
    try:
        fl.set_flags({"partition_mesh": "tp=2",
                      "partition_rules": "mlp=,heads=tp",
                      "partition_zero": 1})
        cfg = partition.PartitionConfig()
        assert cfg.mesh_axes == {"tp": 2}
        assert cfg.rules == (("mlp", None), ("heads", "tp"))
        assert cfg.zero == 1
    finally:
        fl.set_flags(old)


def test_a_tensor_parallel_partition_is_refused_naming_a10b():
    import paddle_tpu_torch as fl
    from paddle_tpu_torch import partition

    main, _, loss = _tagged_model(fl)
    # tensor parallelism runs now (tests/test_torch_tensor_parallel.py);
    # what is refused is a tp axis larger than the world
    with pytest.raises(ValueError, match="needs 2 processes"):
        fl.CompiledProgram(main).with_partitioning(
            partition.PartitionConfig(mesh_axes={"dp": 1, "tp": 2}))
    # a world of one runs a dp=1 partition as the plain step
    c = fl.CompiledProgram(main).with_partitioning(mesh_axes={"dp": 1},
                                                   zero=1)
    assert c.partition.mesh_axes() == {"dp": 1}
    with pytest.raises(ValueError, match="mutually exclusive"):
        c.with_data_parallel(loss_name=loss.name)
    with pytest.raises(ValueError, match="needs 2 processes"):
        fl.CompiledProgram(main).with_partitioning(mesh_axes={"dp": 2})


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.path.insert(0, REPO)
        _worker(sys.argv[2])
