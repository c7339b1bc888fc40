"""The port's gradient-collective planner (``parallel/collectives.py``),
its bucket op and the int8 exchange (``kernels/quant.py``
``quantized_mean``) against the JAX package, on the CPU.

* the planner rewrite is the JAX package's: on the same program both
  packages bucket the same gradients in the same order under the same
  caps, insert the bucket ops at the same places, repoint the same
  consumers, stay idempotent and honour the flags (twins of
  test_collectives.py's planner tests);
* in a gloo world of 2 (``python -m paddle_tpu_torch.distributed.launch
  --nproc_per_node 2 --backend gloo tests/test_torch_collectives.py
  --worker DIR``, launched once), the bucketed fp32 step equals the
  unbucketed one bit for bit, losses and weights, also under ZeRO-1 and
  a global-norm clip and through the optimizer seam (the port against
  itself); the unbucketed trajectory is held to JAX's
  ``with_partitioning`` dp run at 1e-4 / 1e-5; int8 with ZeRO-1 trains
  within 2 % of fp32 (twin of test_int8_zero1_trains_close_to_fp32);
  the int8 exchange and its psum form agree with each other and with
  JAX's ``quantized_mean`` on the same rows at 1e-6 / 1e-5, within the
  two-stage bound of the true mean; integer fetches that depend on the
  rank's batch or random draws are refused (the export-taint checks);
  ``run_pipelined`` equals ``run``; ``skip_reduce`` re-binds; the wire
  gauges and the comm layer's counters are in the unified scrape.
"""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
QROWS = 600


def _model(pkg, seed=7, clip=None, int_fetch=None):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    extra = None
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [16])
        y = pkg.layers.data("y", [1], dtype="int64")
        h = pkg.layers.fc(
            x, 32, act="relu",
            param_attr=pkg.ParamAttr(name="c_w1",
                                     logical_axes=("embed", "mlp")),
            bias_attr=pkg.ParamAttr(name="c_b1", logical_axes=("mlp",)))
        if int_fetch == "dropout":
            d = pkg.layers.dropout(h, dropout_prob=0.5)
            extra = pkg.layers.cast(pkg.layers.reduce_sum(d), "int64")
        logits = pkg.layers.fc(
            h, 4, param_attr=pkg.ParamAttr(name="c_w2",
                                           logical_axes=("mlp", "embed")))
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        if int_fetch == "batch":
            extra = pkg.layers.cast(
                pkg.layers.reduce_sum(pkg.layers.cast(y, "float32")),
                "int64")
        pkg.optimizer.Adam(0.01, grad_clip=clip).minimize(loss)
    return main, startup, loss, extra


def _batch(step, n=32):
    rng = np.random.RandomState(10_000 + step)
    return {"x": rng.randn(n, 16).astype("float32"),
            "y": rng.randint(0, 4, (n, 1)).astype("int64")}


def _local(feed, rank, n):
    k = next(iter(feed.values())).shape[0] // n
    return {a: v[rank * k:(rank + 1) * k] for a, v in feed.items()}


# -- the worker ---------------------------------------------------------------


def _worker(out_dir):
    import paddle_tpu_torch as fl
    from paddle_tpu_torch import observability, partition
    from paddle_tpu_torch.io import load_scope_arrays
    from paddle_tpu_torch.kernels.quant import quantized_mean
    from paddle_tpu_torch.parallel import collectives
    from paddle_tpu_torch.parallel.env import init_parallel_env
    from paddle_tpu_torch.parallel.mesh import world_group

    env = init_parallel_env()
    rank, n = env.rank, env.world_size
    fl.set_flags({"optimizer_fuse": "off"})
    init = {k: v for k, v in np.load(os.path.join(out_dir, "init.npz")).items()}
    out = {}

    def train(cfg_kw, steps=5, clip=None, flags=None):
        if flags:
            fl.set_flags(flags)
        try:
            main, startup, loss, _ = _model(fl, clip=clip)
        finally:
            if flags:
                fl.set_flags({k: ("0" if k == "collective_bucket_mb"
                                  else "none") for k in flags})
        scope = fl.Scope()
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup, scope=scope)
        load_scope_arrays(scope, {k: init[k] for k in init
                                  if main.global_block().has_var(k)},
                          main, "cpu")
        prog = fl.CompiledProgram(main).with_partitioning(
            partition.PartitionConfig(mesh_axes={"dp": n}, **cfg_kw))
        ls = [float(exe.run(prog, feed=_local(_batch(s), rank, n),
                            fetch_list=[loss], scope=scope)[0])
              for s in range(steps)]
        return ls, scope.get_numpy("c_w1").tolist(), main, prog, exe, scope

    for name, kw, clip, flags in (
            ("mono", {}, None, None),
            ("buck", {"collective_bucket_mb": 0.001}, None, None),
            ("mono_z1", {"zero": 1}, None, None),
            ("buck_z1", {"zero": 1, "collective_bucket_mb": 0.001}, None,
             None),
            ("mono_clip", {}, 0.5, None),
            ("buck_clip", {"collective_bucket_mb": 0.001}, 0.5, None),
            ("seam", {}, None, {"collective_bucket_mb": "0.001"})):
        c = fl.clip.GradientClipByGlobalNorm(clip) if clip else None
        ls, w, main, *_ = train(kw, clip=c, flags=flags)
        plan = getattr(main, "_collective_plan", None)
        out[name] = {"losses": ls, "w": w,
                     "buckets": len(plan.buckets) if plan else 0}
    for name, kw in (("fp32_z1_8", {"zero": 1}),
                     ("int8_z1_8", {"zero": 1,
                                    "collective_quantization": "int8"})):
        ls, w, main, prog, exe, scope = train(kw, steps=8)
        out[name] = {"losses": ls}
        if name.startswith("int8"):
            snap = main._collective_plan.snapshot()
            out["int8_snapshot"] = snap

    # run_pipelined equals run
    _, _, main, prog, exe, scope = train({"collective_bucket_mb": 0.001},
                                         steps=0)
    loss = main.global_block().var(
        next(op.outputs["Out"][0] for op in main.global_block().ops
             if op.type == "mean"))
    feeds = [_local(_batch(s), rank, n) for s in range(3)]
    piped = [float(o[0]) for o in exe.run_pipelined(prog, feeds, [loss],
                                                     scope=scope)]
    _, _, main2, prog2, exe2, scope2 = train(
        {"collective_bucket_mb": 0.001}, steps=0)
    ran = [float(exe2.run(prog2, feed=f, fetch_list=[loss],
                          scope=scope2)[0]) for f in feeds]
    out["pipelined"] = {"piped": piped, "ran": ran}

    # skip_reduce re-binds, and the replicas then drift apart
    plan = main2._collective_plan
    misses = exe2.cache_stats()["bound_misses"]
    plan.set_skip_reduce(True)
    exe2.run(prog2, feed=feeds[0], fetch_list=[loss], scope=scope2)
    out["skip"] = {"rebound": exe2.cache_stats()["bound_misses"] - misses,
                   "w": scope2.get_numpy("c_w1").tolist()}
    plan.set_skip_reduce(False)

    # the export-taint refusals
    for kind in ("batch", "dropout"):
        main, startup, loss, cnt = _model(fl, int_fetch=kind)
        scope = fl.Scope()
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup, scope=scope)
        prog = fl.CompiledProgram(main).with_partitioning(
            partition.PartitionConfig(mesh_axes={"dp": n},
                                      collective_bucket_mb=0.001))
        try:
            exe.run(prog, feed=_local(_batch(0), rank, n),
                    fetch_list=[loss, cnt], scope=scope)
            out[f"taint_{kind}"] = "ran"
        except NotImplementedError as e:
            out[f"taint_{kind}"] = str(e)

    # the int8 exchange on this rank's row
    import torch

    x = np.load(os.path.join(out_dir, "qx.npy"))[rank]
    g = world_group()
    for exch in (True, False):
        out[f"qmean_{exch}"] = quantized_mean(
            torch.from_numpy(x), g, 64, exchange=exch).numpy().tolist()

    text = observability.to_prometheus_text()
    out["scrape"] = [ln.split("{")[0] for ln in text.splitlines()
                     if ln.startswith("paddle_collective_")]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


# -- the launch and the JAX side ----------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import paddle_tpu as jf

    d = tmp_path_factory.mktemp("coll")
    main, startup, _, _ = _model(jf)
    scope = jf.Scope()
    with jf.scope_guard(scope):
        jf.Executor(jf.CPUPlace()).run(startup)
    np.savez(str(d / "init.npz"), **{
        v.name: np.asarray(scope.get_numpy(v.name))
        for v in main.list_vars() if v.persistable and not v.is_data})
    np.save(str(d / "qx.npy"),
            np.random.RandomState(1).randn(WORLD, QROWS).astype("float32"))
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
    return {"dir": d, "ranks": [json.loads((d / f"rank{r}.json").read_text())
                                for r in range(WORLD)]}


def test_bucketed_fp32_equals_unbucketed_bit_for_bit(world):
    for r in world["ranks"]:
        for mono, buck in (("mono", "buck"), ("mono_z1", "buck_z1"),
                           ("mono_clip", "buck_clip"), ("mono", "seam")):
            assert r[buck]["buckets"] >= 2, buck
            assert r[mono]["losses"] == r[buck]["losses"], (mono, buck)
            assert r[mono]["w"] == r[buck]["w"], (mono, buck)
        assert r["mono"]["buckets"] == 0


def test_unbucketed_trajectory_matches_jax_partitioned_dp(world):
    import paddle_tpu as jf
    from paddle_tpu import partition as jpartition

    main, startup, loss, _ = _model(jf)
    scope = jf.Scope()
    with jf.scope_guard(scope):
        exe = jf.Executor(jf.CPUPlace())
        exe.run(startup)
        prog = jf.CompiledProgram(main).with_partitioning(
            jpartition.PartitionConfig(mesh_axes={"dp": WORLD}))
        ls = [float(np.asarray(exe.run(prog, feed=_batch(s),
                                       fetch_list=[loss])[0]))
              for s in range(5)]
        w = np.asarray(scope.get_numpy("c_w1"))
    for r in world["ranks"]:
        np.testing.assert_allclose(r["mono"]["losses"], ls, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(r["mono"]["w"]), w,
                                   rtol=1e-4, atol=1e-5)


def test_int8_zero1_trains_close_to_fp32(world):
    r = world["ranks"][0]
    ref, q = r["fp32_z1_8"]["losses"], r["int8_z1_8"]["losses"]
    div = max(abs(a - b) / max(abs(b), 1e-9) for a, b in zip(q, ref))
    assert div < 0.02, f"int8 trajectory diverged: {div}"
    assert q[-1] < q[0]
    snap = r["int8_snapshot"]
    assert snap["quantized"] and snap["dp"] == WORLD
    assert snap["wire_bytes_saved_ratio"] > 1.0
    assert world["ranks"][1]["int8_z1_8"]["losses"] == q


def test_quantized_mean_matches_jax_and_its_psum_form(world):
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.kernels import quant as jquant

    x = np.load(str(world["dir"] / "qx.npy"))
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))

    def run(exchange):
        def body(v):
            return jquant.quantized_mean(v[0], "dp", WORLD, 64,
                                         exchange=exchange)[None]

        f = shard_map(body, mesh=mesh, in_specs=(P("dp"),),
                      out_specs=P("dp"), check_rep=False)
        return np.asarray(jax.jit(f)(jnp.asarray(x)))

    want = run(True)
    ref = x.mean(axis=0)
    bound = 2 * jquant.blockwise_error_bound(x, 64)
    for r, rk in enumerate(world["ranks"]):
        a = np.asarray(rk["qmean_True"])
        b = np.asarray(rk["qmean_False"])
        np.testing.assert_allclose(a, want[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        assert np.abs(a - ref).max() <= bound
    # replicated by construction: every rank the same bits
    assert world["ranks"][0]["qmean_True"] == world["ranks"][1]["qmean_True"]


def test_integer_fetches_depending_on_the_rank_are_refused(world):
    for r in world["ranks"]:
        for kind in ("batch", "dropout"):
            assert "integer var" in r[f"taint_{kind}"], r[f"taint_{kind}"]


def test_run_pipelined_equals_run_and_skip_reduce_rebinds(world):
    r0, r1 = world["ranks"]
    assert r0["pipelined"]["piped"] == r0["pipelined"]["ran"]
    assert r0["skip"]["rebound"] == 1
    # no reduction: each rank stepped on its own gradient
    assert r0["skip"]["w"] != r1["skip"]["w"]


def test_wire_and_comm_gauges_in_the_unified_scrape(world):
    names = set(world["ranks"][0]["scrape"])
    for want in ("paddle_collective_buckets",
                 "paddle_collective_wire_bytes_per_step",
                 "paddle_collective_wire_bytes_saved_ratio",
                 "paddle_collective_comm_calls_total",
                 "paddle_collective_comm_bytes_total",
                 "paddle_collective_comm_blocked_seconds_total"):
        assert want in names, want


# -- the planner rewrite, in process ------------------------------------------


def _planned(pkg, mb, **kw):
    from importlib import import_module

    coll = import_module(f"{pkg.__name__}.parallel.collectives")
    main, _, _, _ = _model(pkg)
    return main, coll.ensure_planned(main, bucket_mb=mb, **kw)


@pytest.mark.parametrize("mb", [0.0005, 0.001, 64])
def test_planner_buckets_equal_jax(mb):
    import paddle_tpu as jf
    import paddle_tpu_torch as fl

    (jm, jplan), (tm, tplan) = _planned(jf, mb), _planned(fl, mb)
    assert [b["grads"] for b in tplan.buckets] == \
        [b["grads"] for b in jplan.buckets]
    assert [b["reduced"] for b in tplan.buckets] == \
        [b["reduced"] for b in jplan.buckets]
    assert [b["bytes"] for b in tplan.buckets] == \
        [b["bytes"] for b in jplan.buckets]
    ops = lambda m: [(op.type, {k: list(v) for k, v in op.inputs.items()})
                     for op in m.global_block().ops]
    assert ops(tm) == ops(jm)
    assert tplan.snapshot()["grads_total"] == jplan.snapshot()["grads_total"]
    if mb == 64:
        assert len(tplan.buckets) == 1


def test_planner_idempotent_flag_gated_and_rejects_bad_config(caplog):
    import paddle_tpu_torch as fl
    from paddle_tpu_torch.parallel import collectives

    main, plan = _planned(fl, 0.001)
    n_ops = len(main.global_block().ops)
    assert collectives.ensure_planned(main, bucket_mb=0.001) is plan
    assert len(main.global_block().ops) == n_ops
    with caplog.at_level(logging.WARNING):
        assert collectives.ensure_planned(main, bucket_mb=5.0) is plan
    assert "already planned" in caplog.text
    m2, _, _, _ = _model(fl)
    assert collectives.ensure_planned(m2) is None  # flags off
    with pytest.raises(ValueError, match="supported modes"):
        collectives.ensure_planned(m2, quantization="fp4")
    with pytest.raises(ValueError, match="block must be positive"):
        collectives.ensure_planned(m2, quantization="int8", quant_block=0)
    old = fl.get_flags(["collective_bucket_mb"])
    try:
        fl.set_flags({"collective_bucket_mb": "0.001"})
        m3, _, _, _ = _model(fl)
        assert m3._collective_plan is not None
        assert len(m3._collective_plan.buckets) >= 2
    finally:
        fl.set_flags(old)


def test_gradient_merge_suppresses_flag_planning():
    import paddle_tpu_torch as fl

    old = fl.get_flags(["collective_bucket_mb"])
    try:
        fl.set_flags({"collective_bucket_mb": "0.001"})
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup), fl.unique_name.guard():
            x = fl.layers.data("x", [4])
            loss = fl.layers.mean(fl.layers.fc(x, 2))
            fl.optimizer.GradientMergeOptimizer(
                fl.optimizer.SGD(0.1), k_steps=2).minimize(loss)
        assert getattr(main, "_collective_plan", None) is None
    finally:
        fl.set_flags(old)


def test_planned_program_without_a_world_is_the_plain_step():
    import paddle_tpu_torch as fl
    from paddle_tpu_torch.parallel import collectives

    fl.set_flags({"optimizer_fuse": "off"})
    try:
        res = []
        for planned in (False, True):
            main, startup, loss, _ = _model(fl)
            if planned:
                collectives.ensure_planned(main, bucket_mb=0.001)
            scope = fl.Scope()
            exe = fl.Executor(fl.CPUPlace())
            exe.run(startup, scope=scope)
            res.append(([float(exe.run(main, feed=_batch(s),
                                       fetch_list=[loss], scope=scope)[0])
                         for s in range(3)], scope.get_numpy("c_w1")))
    finally:
        fl.set_flags({"optimizer_fuse": "auto"})
    assert res[0][0] == res[1][0]
    assert np.array_equal(res[0][1], res[1][1])


def test_parse_bucket_mb_forms_match_jax():
    from paddle_tpu.parallel import collectives as jc
    from paddle_tpu_torch.parallel import collectives as tc

    for spec in (None, 8, "32", "", "dp=32,dcn=8", {"dp": 4}):
        assert tc.parse_bucket_mb(spec) == jc.parse_bucket_mb(spec)
        for hosts in (False, True):
            assert tc.effective_bucket_mb(spec, crosses_hosts=hosts) == \
                jc.effective_bucket_mb(spec, crosses_hosts=hosts)
    for bad in ("abc", "dp=x", "=3", "dp"):
        with pytest.raises(ValueError) as te:
            tc.parse_bucket_mb(bad)
        with pytest.raises(ValueError) as je:
            jc.parse_bucket_mb(bad)
        assert str(te.value) == str(je.value)


def test_quant_roundtrip_error_bounded_per_block():
    import torch

    from paddle_tpu.kernels import quant as jquant
    from paddle_tpu_torch.kernels import quant

    rng = np.random.RandomState(0)
    x = (rng.randn(10_000).astype("float32")
         * rng.choice([1.0, 30.0], 10_000, p=[0.99, 0.01]))
    for block in (64, 256):
        blocks = np.pad(x, (0, -len(x) % block)).reshape(-1, block)
        q, s = quant.blockwise_quantize(torch.from_numpy(blocks))
        back = quant.blockwise_dequantize(q, s).numpy().reshape(-1)
        bound = quant.blockwise_error_bound(x, block)
        assert np.abs(back[:len(x)] - x).max() <= bound + 1e-7
        assert bound == jquant.blockwise_error_bound(x, block)
        assert quant.quantized_payload_bytes(len(x), block) == \
            jquant.quantized_payload_bytes(len(x), block)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.path.insert(0, REPO)
        _worker(sys.argv[2])
