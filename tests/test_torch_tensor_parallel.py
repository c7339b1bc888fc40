"""Megatron tensor parallelism in the port (``with_partitioning`` over a
``tp`` axis, ``runtime/tp_plan.py``) against the JAX package, on the
CPU.

The JAX side runs in the pytest process on the conftest's 8 virtual
devices; the port runs in gloo worlds spawned once (``python -m
paddle_tpu_torch.distributed.launch --nproc_per_node N --backend gloo
tests/test_torch_tensor_parallel.py --worker DIR N``): a world of 2
(tp 2) and a world of 4 (dp 2 x tp 2). Both packages start from JAX's
startup values. Scenarios and tolerances:

* ``bert``: BERT-tiny on the op-graph attention under
  ``apply_megatron_sharding`` at tp 2, one Adam step: the loss within
  1e-4 of JAX's sharded (dp 4 x mp 2) and unsharded runs, the
  parameters at rtol 2e-3 / atol 2e-5 (twin of test_parallel.py::
  test_megatron_sharded_bert_matches_unsharded);
* ``gpt``: GPT-tiny with flash attention at dp 2 x tp 2, 3 Adam steps
  under ``GradientClipByGlobalNorm`` (the clip's squared sums over the
  split gradients summed over tp): losses at rtol 1e-4, parameters at
  rtol 2e-3 / atol 2e-5 and Adam's first moments within relative L2
  1e-4 of JAX's unsharded run;
* ``dropout``: hidden and attention dropout 0.1 at tp 2 equal the
  port's world of one (the whole-shape masks): losses at 1e-5, first
  moments within relative L2 1e-4, parameters at the training
  tolerance;
* ``ck``: a tp 2 checkpoint (``__shards__`` layout, the fused QKV
  interleaved) restored by one process continues the trajectory, and a
  world-of-one checkpoint restored at tp 2 does too, at 2e-5;
* ``pred``: ``Config.enable_partitioning(mesh_axes={"tp": 2})`` at
  float32 and under ``enable_weight_quantization("int8")`` against one
  process's Predictor, within 1e-4 and 1e-3 of the largest logit;
* the fused QKV interleave both ways (``Shard`` with ``groups``, the
  plan's interleave and its inverse), in the pytest process.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 16
STEPS = 3
LOSS_ATOL = 1e-4
P_RTOL, P_ATOL = 2e-3, 2e-5
M1_RTOL = 1e-4      # relative L2 error of an Adam first moment
CK_RTOL, CK_ATOL = 2e-5, 2e-6


# -- models, built with either package ---------------------------------------


def bert(pkg, dropout=0.0):
    from importlib import import_module

    mod = import_module(pkg.__name__ + ".models.bert")
    cfg = mod.BertConfig.tiny()
    cfg.hidden_dropout = cfg.attention_dropout = dropout
    with pkg.unique_name.guard():
        main, startup, _, fetches = mod.build_bert_pretrain(
            cfg, 32, optimizer=pkg.optimizer.Adam(1e-3))
    main.random_seed = startup.random_seed = 11
    return main, startup, fetches["loss"]


def bert_batch():
    from paddle_tpu_torch.models.bert import BertConfig, synthetic_batch

    return synthetic_batch(np.random.RandomState(0), 4, 32,
                           BertConfig.tiny().vocab_size)


def gpt(pkg, flash=True, dropout=0.0, is_test=False):
    from importlib import import_module

    mod = import_module(pkg.__name__ + ".models.gpt")
    cfg = mod.GPTConfig.tiny()
    cfg.use_flash_attention = flash
    cfg.hidden_dropout = cfg.attention_dropout = dropout
    opt = None if is_test else pkg.optimizer.Adam(
        1e-3, grad_clip=pkg.clip.GradientClipByGlobalNorm(1.0))
    with pkg.unique_name.guard():
        main, startup, _, fetches = mod.build_gpt_lm(cfg, SEQ, optimizer=opt,
                                                     is_test=is_test)
    main.random_seed = startup.random_seed = 5
    return main, startup, fetches["loss"], fetches["logits"]


def gpt_batches(n=STEPS, seed=1):
    from paddle_tpu_torch.models.gpt import GPTConfig, synthetic_lm_batch

    rng = np.random.RandomState(seed)
    return [synthetic_lm_batch(rng, 4, SEQ, GPTConfig.tiny().vocab_size)
            for _ in range(n)]


def _init(pkg, built):
    main, startup = built[0], built[1]
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
    return {v.name: np.asarray(scope.get_numpy(v.name))
            for v in main.list_vars()
            if v.persistable and not v.is_data
            and scope.find_var(v.name) is not None}


def _moments(main, get):
    return {v.accumulator_owner: get(v.name)
            for v in main.global_block().vars.values()
            if getattr(v, "is_accumulator", False) and "moment1" in v.name}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# -- the worker ---------------------------------------------------------------


def _worker(out_dir, world):
    import paddle_tpu_torch as fl
    from paddle_tpu_torch import io
    from paddle_tpu_torch.inference.predictor import Config, create_predictor
    from paddle_tpu_torch.io import load_scope_arrays
    from paddle_tpu_torch.models.bert import apply_megatron_sharding
    from paddle_tpu_torch.models.gpt import apply_gpt_megatron_sharding
    from paddle_tpu_torch.parallel.env import init_parallel_env

    env = init_parallel_env()
    rank = env.rank
    fl.set_flags({"optimizer_fuse": "off"})
    init = dict(np.load(os.path.join(out_dir, "init.npz"), allow_pickle=True))
    init = {k: v.item() for k, v in init.items()}
    out = {}

    def fresh(built, key):
        scope = fl.Scope()
        exe = fl.Executor(fl.CPUPlace())
        exe.run(built[1], scope=scope)
        if key is not None:
            load_scope_arrays(scope, init[key], built[0], "cpu")
        return scope, exe

    def whole(main, scope, tag):
        d = os.path.join(out_dir, f"{tag}_w{world}")
        io.save_checkpoint(d, main, scope)
        return d

    if world == 4:
        # dp 2 x tp 2: the ranks of one dp index feed the same rows
        built = gpt(fl)
        scope, exe = fresh(built, "gpt")
        main, loss = built[0], built[2]
        apply_gpt_megatron_sharding(main, mp_axis="tp")
        prog = fl.CompiledProgram(main).with_partitioning(
            mesh_axes={"dp": 2, "tp": 2})
        d = rank // 2
        ls = [float(exe.run(prog, feed={k: v[2 * d:2 * d + 2]
                                        for k, v in b.items()},
                            fetch_list=[loss], scope=scope)[0])
              for b in gpt_batches()]
        out["gpt"] = {"losses": ls, "ck": whole(main, scope, "gpt")}
    else:
        # bert at tp 2, one Adam step
        built = bert(fl)
        scope, exe = fresh(built, "bert")
        main, loss = built[0], built[2]
        apply_megatron_sharding(main, mp_axis="tp")
        prog = fl.CompiledProgram(main).with_partitioning(mesh_axes={"tp": 2})
        ls = [float(exe.run(prog, feed=bert_batch(), fetch_list=[loss],
                            scope=scope)[0])]
        out["bert"] = {"losses": ls, "ck": whole(main, scope, "bert"),
                       "local_qkv": list(scope.find_var("enc0_qkv.w").shape)}

        # dropout 0.1 at tp 2 against the world of one, op-graph path
        runs = {}
        for kind in ("one", "tp"):
            built = gpt(fl, flash=False, dropout=0.1)
            scope, exe = fresh(built, "gpt_drop")
            main, loss = built[0], built[2]
            prog = main
            if kind == "tp":
                apply_gpt_megatron_sharding(main, mp_axis="tp")
                prog = fl.CompiledProgram(main).with_partitioning(
                    mesh_axes={"tp": 2})
            ls = [float(exe.run(prog, feed=b, fetch_list=[loss],
                                scope=scope)[0]) for b in gpt_batches()]
            runs[kind] = {"losses": ls,
                          "ck": whole(main, scope, f"drop_{kind}")}
        out["dropout"] = runs

        # checkpoints: tp 2 for 2 steps, saved, then a third step; and a
        # world-of-one checkpoint (written before the launch) continued
        # at tp 2
        built = gpt(fl)
        scope, exe = fresh(built, "gpt")
        main, loss = built[0], built[2]
        apply_gpt_megatron_sharding(main, mp_axis="tp")
        prog = fl.CompiledProgram(main).with_partitioning(mesh_axes={"tp": 2})
        bs = gpt_batches()
        for b in bs[:2]:
            exe.run(prog, feed=b, fetch_list=[loss], scope=scope)
        ck_tp = whole(main, scope, "ck_tp2")
        l3 = float(exe.run(prog, feed=bs[2], fetch_list=[loss],
                           scope=scope)[0])
        out["ck"] = {"ck_tp": ck_tp, "tp_l3": l3,
                     "tp_3": whole(main, scope, "ck_tp3")}
        built = gpt(fl)
        scope, exe = fresh(built, None)
        main, loss = built[0], built[2]
        io.load_checkpoint(os.path.join(out_dir, "ck_one2"), main, scope,
                           device="cpu")
        apply_gpt_megatron_sharding(main, mp_axis="tp")
        prog = fl.CompiledProgram(main).with_partitioning(mesh_axes={"tp": 2})
        out["ck"]["rev_l3"] = float(exe.run(prog, feed=bs[2],
                                            fetch_list=[loss],
                                            scope=scope)[0])
        out["ck"]["rev_3"] = whole(main, scope, "ck_rev3")

        # the tp Predictor, float32 and int8
        toks = gpt_batches(1, seed=9)[0]["tokens"]
        pred = {}
        for q in ("off", "int8"):
            one = create_predictor(Config(os.path.join(out_dir, "lm"))
                                   .enable_weight_quantization(q),
                                   device="cpu").run([toks])[0]
            p = create_predictor(Config(os.path.join(out_dir, "lm"))
                                 .enable_weight_quantization(q)
                                 .enable_partitioning(mesh_axes={"tp": 2}),
                                 device="cpu")
            got = p.run([toks])[0]
            qn = [n for n in p._scope.vars if n.startswith("dec0_qkv.w")]
            pred[q] = {"err": float(np.abs(got - one).max()),
                       "scale": float(np.abs(one).max()),
                       "shape": list(got.shape),
                       "local": list(p._scope.find_var(qn[0]).shape)}
        out["pred"] = pred
    with open(os.path.join(out_dir, f"rank{rank}_w{world}.json"), "w") as f:
        json.dump(out, f)


def _launch(d, world):
    from paddle_tpu_torch.parallel.env import free_port

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--nproc_per_node={world}", f"--started_port={free_port()}",
         "--backend=gloo", f"--run_dir={d / f'run{world}'}",
         os.path.abspath(__file__), "--worker", str(d), str(world)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads((d / f"rank{r}_w{world}.json").read_text())
            for r in range(world)]


def _port_plain(built, init, batches, scope=None):
    """The port's world-of-one run from ``init``: (losses, scope)."""
    import paddle_tpu_torch as fl
    from paddle_tpu_torch.io import load_scope_arrays

    scope = scope or fl.Scope()
    exe = fl.Executor(fl.CPUPlace())
    if init is not None:
        exe.run(built[1], scope=scope)
        load_scope_arrays(scope, init, built[0], "cpu")
    ls = [float(exe.run(built[0], feed=b, fetch_list=[built[2]],
                        scope=scope)[0]) for b in batches]
    return ls, scope


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import paddle_tpu as jf
    import paddle_tpu_torch as fl

    d = tmp_path_factory.mktemp("tp")
    init = {"bert": _init(jf, bert(jf)), "gpt": _init(jf, gpt(jf)),
            "gpt_drop": _init(jf, gpt(jf, flash=False, dropout=0.1))}
    np.savez(str(d / "init.npz"), **{k: np.array(v, dtype=object)
                                     for k, v in init.items()})
    old = fl.get_flags(["optimizer_fuse"])
    fl.set_flags({"optimizer_fuse": "off"})
    try:
        # a world-of-one checkpoint after 2 steps, for the reverse restore
        built = gpt(fl)
        _, scope = _port_plain(built, init["gpt"], gpt_batches()[:2])
        fl.io.save_checkpoint(str(d / "ck_one2"), built[0], scope)
        # the Predictor's model: an is_test GPT at JAX's startup values
        lm = gpt(fl, is_test=True)
        s = fl.Scope()
        exe = fl.Executor(fl.CPUPlace())
        exe.run(lm[1], scope=s)
        from paddle_tpu_torch.io import load_scope_arrays

        load_scope_arrays(s, {k: v for k, v in init["gpt"].items()
                              if lm[0].global_block().has_var(k)},
                          lm[0], "cpu")
        from paddle_tpu_torch.models.gpt import apply_gpt_megatron_sharding

        apply_gpt_megatron_sharding(lm[0], mp_axis="tp")
        with fl.scope_guard(s):
            fl.io.save_inference_model(str(d / "lm"), ["tokens"], [lm[3]],
                                       exe, lm[0])
    finally:
        fl.set_flags(old)
    return {"dir": d, "init": init, 2: _launch(d, 2), 4: _launch(d, 4)}


def _arrays(path):
    from paddle_tpu_torch.io import load_checkpoint_arrays

    return load_checkpoint_arrays(path)


def _jax_run(jf, built, batches, prog_fn=None):
    """JAX's run from its own startup values (the ``init`` the port
    loads): losses, parameters, first moments."""
    main, startup, loss = built[0], built[1], built[2]
    scope = jf.Scope()
    with jf.scope_guard(scope):
        exe = jf.Executor(jf.CPUPlace())
        exe.run(startup)
        prog = prog_fn(main) if prog_fn else main
        ls = [float(np.asarray(exe.run(prog, feed=b, fetch_list=[loss])[0])
                    .reshape(())) for b in batches]
        prm = {p.name: np.asarray(scope.get_numpy(p.name))
               for p in main.all_parameters()}
        m1 = _moments(main, lambda n: np.asarray(scope.get_numpy(n)))
    return ls, prm, m1


# -- tests ----------------------------------------------------------------------


def test_megatron_bert_at_tp2_matches_jax_sharded_and_unsharded(worlds):
    import paddle_tpu as jf
    from paddle_tpu.models.bert import apply_megatron_sharding as jax_amp

    ls1, prm1, _ = _jax_run(jf, bert(jf), [bert_batch()])

    def sharded(main):
        jax_amp(main)
        return jf.CompiledProgram(main).with_partitioning(
            mesh_axes={"dp": 4, "mp": 2})

    ls2, prm2, _ = _jax_run(jf, bert(jf), [bert_batch()], sharded)
    for r in worlds[2]:
        got = r["bert"]["losses"][0]
        assert abs(got - ls1[0]) < LOSS_ATOL and abs(got - ls2[0]) < LOSS_ATOL
        # the rank holds its columns of the fused QKV (3h = 192)
        assert r["bert"]["local_qkv"] == [64, 96]
    port = _arrays(worlds[2][0]["bert"]["ck"])
    assert len(prm1) >= 10
    for n in prm1:
        np.testing.assert_allclose(port[n], prm1[n], rtol=P_RTOL,
                                   atol=P_ATOL, err_msg=n)
        np.testing.assert_allclose(port[n], prm2[n], rtol=P_RTOL,
                                   atol=P_ATOL, err_msg=n)


def test_gpt_flash_at_dp2_tp2_with_global_norm_clip_matches_jax(worlds):
    import paddle_tpu as jf

    ls, prm, m1 = _jax_run(jf, gpt(jf), gpt_batches())
    for r in worlds[4]:
        np.testing.assert_allclose(r["gpt"]["losses"], ls, rtol=1e-4,
                                   atol=1e-5)
    port = _arrays(worlds[4][0]["gpt"]["ck"])
    for n in prm:
        np.testing.assert_allclose(port[n], prm[n], rtol=P_RTOL,
                                   atol=P_ATOL, err_msg=n)
    main = gpt(jf)[0]
    moments = _moments(main, lambda n: port[n])
    assert len(moments) == len(m1) > 20
    for n in m1:
        assert _rel_l2(moments[n], m1[n]) < M1_RTOL, n


def test_dropout_at_tp2_equals_the_world_of_one(worlds):
    for r in worlds[2]:
        runs = r["dropout"]
        np.testing.assert_allclose(runs["tp"]["losses"],
                                   runs["one"]["losses"], rtol=1e-5)
    a = _arrays(worlds[2][0]["dropout"]["one"]["ck"])
    b = _arrays(worlds[2][0]["dropout"]["tp"]["ck"])
    main = gpt(__import__("paddle_tpu_torch"), flash=False, dropout=0.1)[0]
    for p in main.all_parameters():
        np.testing.assert_allclose(b[p.name], a[p.name], rtol=P_RTOL,
                                   atol=P_ATOL, err_msg=p.name)
    # the gradients themselves: another mask moves a moment by O(1)
    ma, mb = _moments(main, lambda n: a[n]), _moments(main, lambda n: b[n])
    for n in ma:
        assert _rel_l2(mb[n], ma[n]) < M1_RTOL, n


def test_tp_checkpoint_restores_on_a_world_of_one_and_back(worlds):
    import paddle_tpu_torch as fl

    ck = worlds[2][0]["ck"]
    bs = gpt_batches()
    old = fl.get_flags(["optimizer_fuse"])
    fl.set_flags({"optimizer_fuse": "off"})
    try:
        # the uninterrupted world of one
        ls, s_ref = _port_plain(gpt(fl), worlds["init"]["gpt"], bs)
        # tp 2's checkpoint restored by this process, one more step
        built = gpt(fl)
        scope = fl.Scope()
        fl.Executor(fl.CPUPlace()).run(built[1], scope=scope)
        fl.io.load_checkpoint(ck["ck_tp"], built[0], scope, device="cpu")
        l3, scope = _port_plain(built, None, bs[2:], scope)
    finally:
        fl.set_flags(old)
    assert abs(l3[0] - ck["tp_l3"]) < CK_ATOL + CK_RTOL * abs(l3[0])
    np.testing.assert_allclose(ck["rev_l3"], ls[2], rtol=CK_RTOL,
                               atol=CK_ATOL)
    tp3, rev3 = _arrays(ck["tp_3"]), _arrays(ck["rev_3"])
    for p in built[0].all_parameters():
        ref = s_ref.get_numpy(p.name)
        np.testing.assert_allclose(scope.get_numpy(p.name), tp3[p.name],
                                   rtol=CK_RTOL, atol=CK_ATOL, err_msg=p.name)
        np.testing.assert_allclose(rev3[p.name], ref, rtol=CK_RTOL,
                                   atol=CK_ATOL, err_msg=p.name)


def test_tp_predictor_matches_one_process_float32_and_int8(worlds):
    for r in worlds[2]:
        f32, i8 = r["pred"]["off"], r["pred"]["int8"]
        assert f32["shape"] == [4, SEQ, 1000]
        assert f32["err"] <= 1e-4 * f32["scale"]
        assert i8["err"] <= 1e-3 * i8["scale"]
        # each rank holds its columns of the quantized fused QKV
        assert f32["local"] == [64, 96] and i8["local"] == [64, 96]


@pytest.mark.parametrize("groups,parts", [(3, 2), (3, 4), (1, 2)])
def test_fused_qkv_interleave_both_ways(groups, parts):
    import torch

    from paddle_tpu_torch.parallel.sharding import Shard
    from paddle_tpu_torch.runtime.tp_plan import _deinterleave, _interleave

    rng = np.random.RandomState(0)
    full = torch.from_numpy(rng.randn(4, groups * parts * 2).astype("f"))
    whole = np.zeros(tuple(full.shape), np.float32)
    chunks = []
    for r in range(parts):
        sh = Shard(1, parts, r, tuple(full.shape), True, groups)
        loc = sh.take(full)
        chunks.append(loc)
        # the rank's local split is its slice of each of q, k and v
        for g, piece in enumerate(torch.split(loc, loc.shape[1] // groups,
                                              dim=1)):
            run = torch.split(full, full.shape[1] // groups, dim=1)[g]
            k = run.shape[1] // parts
            assert torch.equal(piece, run[:, r * k:(r + 1) * k])
        # the ranges a checkpoint writes the chunk to put it back whole
        at = 0
        for lo, hi in sh.pieces():
            whole[:, lo:hi] = loc.numpy()[:, at:at + hi - lo]
            at += hi - lo
    np.testing.assert_array_equal(whole, full.numpy())
    gathered = torch.cat(chunks, dim=1)
    assert torch.equal(_interleave(full, 1, parts, groups), gathered)
    assert torch.equal(_deinterleave(gathered, 1, parts, groups), full)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        sys.path.insert(0, REPO)
        _worker(sys.argv[2], int(sys.argv[3]))
