"""The user surface that crosses processes, in a gloo world of 2 on the
CPU (``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2
--backend gloo tests/test_torch_world_surface.py --worker DIR``), held
against the JAX package and against one process of the port.

* ``nhwc_dp``: twin of ``test_auto_nhwc.py::
  test_auto_nhwc_composes_with_data_parallel``. The conv / batch-norm /
  pool / fc net through ``auto_nhwc``, 3 SGD steps under
  ``with_data_parallel``, a rank feeding half of the 8 rows. JAX's data
  parallelism is GSPMD, whose batch norm sees the whole batch; the
  port's is one process a rank, whose ``batch_norm`` sees the rank's
  rows, as the reference's per-device batch norm does. So the world's
  program takes ``sync_batch_norm`` (the reference's
  ``BuildStrategy.sync_batch_norm`` rewrite) before the pass, which
  flips it too. Both ranks' losses equal one process's flipped run at
  JAX's tolerance (rtol 2e-5 / atol 2e-6), and JAX's run at the image
  ops' cross-package tolerance (1e-4 / 1e-5).
* ``auc``: ``incubate.fleet.utils.FleetUtil``: each rank holds half of
  the auc op's buckets (the other half zero); ``get_global_auc`` and
  ``get_global_metrics`` sum them over the world and give the one
  process's values on the whole buckets (JAX's ``FleetUtil`` on them);
  ``rank0_print`` prints on rank 0 alone.
* ``collective``: ``layers.collective``'s ``_c_allreduce`` (sum, max),
  ``_c_broadcast``, ``_c_allgather`` and ``_c_reducescatter`` in a plain
  Executor over the world, against numpy over both ranks' inputs.

``install_check``'s data-parallel arm, which starts its own world through
the launcher, runs here too, on the CPU (``run_check`` runs it on the
cards).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
ROWS = 8


def nhwc_net(pkg):
    img = pkg.layers.data("image", [3, 16, 16])
    y = pkg.layers.data("label", [1], dtype="int64")
    h = pkg.layers.conv2d(img, 8, 3, padding=1,
                          param_attr=pkg.ParamAttr(name="c.w"))
    h = pkg.layers.batch_norm(
        h, act="relu", param_attr=pkg.ParamAttr(name="n.s"),
        bias_attr=pkg.ParamAttr(name="n.b"),
        moving_mean_name="n.m", moving_variance_name="n.v")
    h = pkg.layers.pool2d(h, 2, "avg", global_pooling=True)
    return pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
        pkg.layers.fc(h, 4, param_attr=pkg.ParamAttr(name="f.w")), y))


def build_nhwc(pkg, sync_bn=False):
    """JAX's data-parallel twin net, ``sync_batch_norm`` for a world,
    through the pass, then SGD(1e-2)."""
    if pkg.__name__ == "paddle_tpu":
        from paddle_tpu.transpiler import auto_nhwc
    else:
        from paddle_tpu_torch.transpiler import auto_nhwc
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 31
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        loss = nhwc_net(pkg)
        if sync_bn:
            for op in main.global_block().ops:
                if op.type == "batch_norm":
                    op.type = "sync_batch_norm"
        auto_nhwc(main)
        pkg.optimizer.SGD(1e-2).minimize(loss)
    return main, startup, loss


def nhwc_feed():
    rng = np.random.RandomState(21)
    return {"image": rng.randn(ROWS, 3, 16, 16).astype("f"),
            "label": rng.randint(0, 4, (ROWS, 1)).astype("int64")}


def auc_stats():
    """Bucket counts of an auc op's positives and negatives (128
    buckets) and the error sums ``get_global_metrics`` reads."""
    rng = np.random.RandomState(5)
    pos = rng.randint(0, 20, 128) * (np.arange(128) > 40)
    neg = rng.randint(0, 20, 128) * (np.arange(128) < 90)
    return {"sp": pos.astype("int64"), "sn": neg.astype("int64"),
            "abserr": np.array([12.5]), "sqrerr": np.array([7.25]),
            "prob": np.array([30.0]), "pos_n": np.array([40.0]),
            "total": np.array([100.0])}


def rank_stats(rank):
    """Rank ``rank``'s half: the buckets of its parity and half of each
    sum."""
    out = {}
    for k, v in auc_stats().items():
        if k in ("sp", "sn"):
            out[k] = np.where(np.arange(128) % WORLD == rank, v, 0)
        else:
            out[k] = v / WORLD
    return out


METRIC_NAMES = dict(stat_pos_name="sp", stat_neg_name="sn",
                    abserr_name="abserr", sqrerr_name="sqrerr",
                    prob_name="prob", pos_ins_num_name="pos_n",
                    total_ins_num_name="total")


def collective_inputs(rank):
    return (np.arange(12, dtype=np.float32).reshape(4, 3) * (rank + 1)
            + 0.5 * rank)


# -- the worker (one process of the world) -----------------------------------


def _worker(out_dir):
    import paddle_tpu_torch as fl
    from paddle_tpu_torch.incubate.fleet.utils import FleetUtil
    from paddle_tpu_torch.parallel.env import init_parallel_env

    env = init_parallel_env()
    rank, n = env.rank, env.world_size
    out = {}
    init = dict(np.load(os.path.join(out_dir, "init.npz")))

    # nhwc_dp
    main, _, loss = build_nhwc(fl, sync_bn=True)
    out["nhwc_flipped"] = sum(op.type == "sync_batch_norm"
                              and op.attrs.get("data_layout") == "NHWC"
                              for op in main.global_block().ops)
    scope = fl.Scope()
    from paddle_tpu_torch.io import load_scope_arrays

    load_scope_arrays(scope, init, main, "cpu")
    prog = fl.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    exe = fl.Executor(fl.CPUPlace())
    per = ROWS // n
    feed = {k: v[rank * per:(rank + 1) * per] for k, v in nhwc_feed().items()}
    out["nhwc_losses"] = [float(exe.run(prog, feed=feed, fetch_list=[loss],
                                        scope=scope)[0]) for _ in range(3)]

    # auc
    fu = FleetUtil()
    scope = fl.Scope()
    for k, v in rank_stats(rank).items():
        scope.set_var(k, v)
    out["auc"] = fu.get_global_auc(scope, "sp", "sn")
    out["metrics"] = fu.get_global_metrics(scope, **METRIC_NAMES)
    fu.rank0_print(f"hello-fleet from rank {rank}")
    fu.set_zero("sp", scope)
    out["zeroed"] = float(np.asarray(scope.find_var("sp")).sum())

    # collective
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        x = fl.layers.data("x", [4, 3], append_batch_size=False)
        L = fl.layers
        outs = [L._c_allreduce(x), L._c_allreduce(x, reduce_type="max"),
                L._c_broadcast(x, root=1), L._c_allgather(x, n),
                L._c_reducescatter(x, n)]
    vals = fl.Executor(fl.CPUPlace()).run(
        main, feed={"x": collective_inputs(rank)}, fetch_list=outs,
        scope=fl.Scope())
    out["collective"] = [np.asarray(v).tolist() for v in vals]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


# -- the pytest side -----------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import paddle_tpu as jf

    d = tmp_path_factory.mktemp("surface_world")
    main, startup, loss = build_nhwc(jf)
    scope = jf.Scope()
    with jf.scope_guard(scope):
        exe = jf.Executor(jf.CPUPlace())
        exe.run(startup)
        init = {v.name: np.asarray(scope.find_var(v.name))
                for v in main.list_vars() if v.persistable and not v.is_data}
        jlosses = [float(np.asarray(exe.run(main, feed=nhwc_feed(),
                                            fetch_list=[loss])[0]))
                   for _ in range(3)]
    np.savez(str(d / "init.npz"), **init)
    from paddle_tpu_torch.parallel.env import free_port

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={WORLD}", f"--started_port={free_port()}",
         "--backend=gloo", f"--run_dir={d / 'run'}",
         os.path.abspath(__file__), "--worker", str(d)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:] + proc.stdout[-4000:]
    ranks = [json.loads((d / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    # the launcher re-emits each rank's lines, prefixed, on its stderr
    return {"ranks": ranks, "init": init, "jax_losses": jlosses,
            "log": proc.stderr}


def test_auto_nhwc_composes_with_data_parallel(world):
    import paddle_tpu_torch as fl
    from paddle_tpu_torch.io import load_scope_arrays

    main, _, loss = build_nhwc(fl)
    scope = fl.Scope()
    load_scope_arrays(scope, world["init"], main, "cpu")
    exe = fl.Executor(fl.CPUPlace())
    one = [float(exe.run(main, feed=nhwc_feed(), fetch_list=[loss],
                         scope=scope)[0]) for _ in range(3)]
    for r in world["ranks"]:
        assert r["nhwc_flipped"] == 1
        np.testing.assert_allclose(r["nhwc_losses"], one, rtol=2e-5,
                                   atol=2e-6)
        np.testing.assert_allclose(r["nhwc_losses"], world["jax_losses"],
                                   rtol=1e-4, atol=1e-5)


def test_fleet_util_global_auc_sums_the_world(world):
    import paddle_tpu as jf
    from paddle_tpu.incubate.fleet.utils import FleetUtil as JFleetUtil

    import paddle_tpu_torch as fl
    from paddle_tpu_torch.incubate.fleet.utils import FleetUtil

    tscope, jscope = fl.Scope(), jf.Scope()
    for k, v in auc_stats().items():
        tscope.set_var(k, v)
        jscope.set_var(k, v)
    one = FleetUtil().get_global_auc(tscope, "sp", "sn")
    metrics = FleetUtil().get_global_metrics(tscope, **METRIC_NAMES)
    assert one == JFleetUtil().get_global_auc(jscope, "sp", "sn")
    assert metrics == JFleetUtil().get_global_metrics(jscope,
                                                      **METRIC_NAMES)
    assert 0.5 < one < 1.0
    for r in world["ranks"]:
        np.testing.assert_allclose(r["auc"], one, rtol=1e-12)
        assert r["metrics"].keys() == metrics.keys()
        for k, v in metrics.items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-12)
        assert r["zeroed"] == 0.0
    lines = [ln for ln in world["log"].splitlines() if "hello-fleet" in ln]
    assert len(lines) == 1 and "from rank 0" in lines[0], lines


def test_collective_layers_in_a_world(world):
    xs = [collective_inputs(r) for r in range(WORLD)]
    total = sum(xs)
    want = [total, np.maximum(*xs), xs[1], np.concatenate(xs)]
    for rank, r in enumerate(world["ranks"]):
        got = [np.asarray(v) for v in r["collective"]]
        for g, w in zip(got[:4], want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[4], total[rank * 2:(rank + 1) * 2])


def test_collective_layers_build_jax_programs():
    import paddle_tpu as jf

    import paddle_tpu_torch as fl

    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            x = pkg.layers.data("x", [4, 3], append_batch_size=False)
            L = pkg.layers
            L._c_allreduce(x, reduce_type="min", ring_id=1)
            L._c_broadcast(x, root=1)
            L._c_allgather(x, 2)
            L._c_reducescatter(x, 2, use_calc_stream=True)
        return main

    assert build(fl).to_dict() == build(jf).to_dict()
    # with no world the c_* ops are identities, as JAX's are without a mesh
    main = build(fl)
    x = collective_inputs(0)
    outs = fl.Executor(fl.CPUPlace()).run(
        main, feed={"x": x},
        fetch_list=[op.outputs["Out"][0] for op in main.global_block().ops],
        scope=fl.Scope())
    for o in outs:
        np.testing.assert_array_equal(np.asarray(o), x)


def test_install_check_data_parallel_arm_in_a_world():
    """``run_check``'s data-parallel arm, as it runs over the cards, on
    the CPU: 2 processes under the launcher, one SGD step of the
    compiled program each."""
    from paddle_tpu_torch import install_check

    install_check._data_parallel_check(2, backend="gloo", device="cpu",
                                       timeout_s=300)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.path.insert(0, REPO)
        _worker(sys.argv[2])
