"""Sequence parallelism in the port (``with_sequence_parallel``, ring
and Ulysses attention) against the JAX package, on the CPU.

The JAX side runs in the pytest process on the conftest's 8 virtual
devices; the port runs in one gloo world of 4 spawned once (``python
-m paddle_tpu_torch.distributed.launch --nproc_per_node 4 --backend
gloo tests/test_torch_sequence_parallel.py --worker DIR``), each rank
on its slice of the sequence. Scenarios and tolerances (JAX's own):

* ``attn``: ``ring_attention`` and ``ulysses_attention`` over an sp
  group of 2 (the ``sp`` axis of a dp 2 x sp 2 mesh) and of 4, with and
  without a key mask, causal and not: outputs and the q / k / v
  gradients of sum(out²) against JAX's ``make_ring_attention_fn`` /
  ``make_ulysses_attention_fn`` (ring 3e-5 / 5e-5, Ulysses 3e-5 /
  3e-4; twins of test_parallel.py::test_ring_attention_gradient_and_
  mask_parity and test_ulysses_attention_fwd_grad_mask_parity), and
  Ulysses whole against JAX's flash kernels in interpret mode, which
  it runs (a query row that sees no key differs between JAX's kernels
  and its plain path, and the port follows the kernels);
* ``gpt_*``: GPT-tiny with flash attention trained 3 Adam steps at
  sp 4 and at dp 2 x sp 2, ring and Ulysses, against JAX's
  ``with_sequence_parallel`` at 2e-4 (twins of test_parallel.py::
  test_gpt_sequence_parallel_training_parity, test_gpt_trains_with_
  ulysses_sequence_parallel, test_gpt_trains_with_combined_dp_sp);
* ``fallback``: a flash op of 2 heads at sp 4 under Ulysses falls back
  to the ring with JAX's warning, and its loss equals JAX's at 1e-5
  (twin of test_parallel.py::test_sequence_parallel_bool_mask_and_odd_
  dims, with its [B, 1] label left whole on dim 1).
"""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
B, H, S, D = 2, 4, 64, 8
GPT_SEQ = 64
GPT_RTOL = 2e-4
TOL = {"ring": (3e-5, 5e-5), "ulysses": (3e-5, 3e-4)}


def _qkv():
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(B, H, S, D).astype("float32") for _ in range(3))
    mask = np.where(rng.rand(B, S) > 0.25, 0.0, -1e30).astype("float32")
    return q, k, v, mask


def _cases():
    return [(mode, sp, causal, use_mask)
            for mode in ("ring", "ulysses") for sp in (2, 4)
            for causal in (False, True) for use_mask in (False, True)]


def gpt(pkg, seed=23):
    from importlib import import_module

    mod = import_module(pkg.__name__ + ".models.gpt")
    cfg = mod.GPTConfig.tiny()
    cfg.use_flash_attention = True
    with pkg.unique_name.guard():
        main, startup, _, fetches = mod.build_gpt_lm(
            cfg, GPT_SEQ, optimizer=pkg.optimizer.Adam(1e-3))
    main.random_seed = startup.random_seed = seed
    return main, startup, fetches["loss"]


def gpt_batches(n=3):
    from paddle_tpu_torch.models.gpt import GPTConfig, synthetic_lm_batch

    rng = np.random.RandomState(0)
    return [synthetic_lm_batch(rng, 4, GPT_SEQ, GPTConfig.tiny().vocab_size)
            for _ in range(n)]


def odd(pkg):
    """test_sequence_parallel_bool_mask_and_odd_dims's program: 2 heads."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        q = pkg.layers.data("q", [32, 16])
        mask = pkg.layers.data("mask", [32])
        lbl = pkg.layers.data("lbl", [1])
        mod = __import__(pkg.__name__ + ".kernels", fromlist=["x"])
        ctx = mod.flash_attention_layer(q, q, q, 2, causal=False,
                                        mask_var=mask, mask_type="binary")
        out = pkg.layers.reduce_mean(ctx, dim=[1, 2], keep_dim=True)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            pkg.layers.reshape(out, [-1, 1]), lbl))
    return main, startup, loss


def odd_feed():
    rng = np.random.RandomState(2)
    maskb = (rng.rand(2, 32) > 0.3).astype("float32")
    maskb[:, 0] = 1.0
    return {"q": rng.randn(2, 32, 16).astype("float32"), "mask": maskb,
            "lbl": np.zeros((2, 1), "float32")}


# -- the worker ---------------------------------------------------------------


def _worker(out_dir):
    import torch

    import paddle_tpu_torch as fl
    from paddle_tpu_torch.io import load_scope_arrays
    from paddle_tpu_torch.parallel import comm
    from paddle_tpu_torch.parallel.env import init_parallel_env
    from paddle_tpu_torch.parallel.mesh import make_mesh
    from paddle_tpu_torch.parallel.ring_attention import ring_attention
    from paddle_tpu_torch.parallel.ulysses import ulysses_attention

    env = init_parallel_env()
    rank = env.rank
    fl.set_flags({"optimizer_fuse": "off"})
    out = {"attn": {}}
    q, k, v, mask = _qkv()
    meshes = {2: make_mesh({"dp": 2, "sp": 2}), 4: make_mesh({"sp": 4})}
    for mode, sp, causal, use_mask in _cases():
        mesh = meshes[sp]
        group, i = mesh.group("sp"), mesh.coord("sp")
        n = S // sp
        loc = [torch.from_numpy(t[:, :, i * n:(i + 1) * n].copy())
               .requires_grad_(True) for t in (q, k, v)]
        m = None
        if use_mask:
            m = torch.from_numpy(mask[:, i * n:(i + 1) * n].copy()
                                 if mode == "ring" else mask)
        fn = ring_attention if mode == "ring" else ulysses_attention
        o = fn(*loc, group, causal=causal, mask=m)
        (o ** 2).sum().backward()
        res = [comm._gather(t.detach(), 2, group)
               for t in [o] + [x.grad for x in loc]]
        out["attn"][f"{mode}-{sp}-{causal}-{use_mask}"] = \
            [t.numpy().tolist() for t in res]

    init = dict(np.load(os.path.join(out_dir, "init.npz"), allow_pickle=True))
    init = {kk: vv.item() for kk, vv in init.items()}
    for mode in ("ring", "ulysses"):
        for dp, sp in ((1, 4), (2, 2)):
            main, startup, loss = gpt(fl)
            scope = fl.Scope()
            exe = fl.Executor(fl.CPUPlace())
            exe.run(startup, scope=scope)
            load_scope_arrays(scope, init["gpt"], main, "cpu")
            prog = fl.CompiledProgram(main).with_sequence_parallel(
                sp=sp, dp=dp, mode=mode)
            di, si = rank // sp, rank % sp
            rows, cols = 4 // dp, GPT_SEQ // sp
            ls = [float(exe.run(prog, feed={
                kk: vv[di * rows:(di + 1) * rows, si * cols:(si + 1) * cols]
                for kk, vv in b.items()}, fetch_list=[loss],
                scope=scope)[0]) for b in gpt_batches()]
            out[f"gpt_{mode}_{dp}x{sp}"] = ls

    # 2 heads at sp 4 under Ulysses: the ring, with the warning
    seen = []

    class _Catch(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    logging.getLogger("paddle_tpu_torch.tp_plan").addHandler(_Catch())
    main, startup, loss = odd(fl)
    scope = fl.Scope()
    exe = fl.Executor(fl.CPUPlace())
    exe.run(startup, scope=scope)
    prog = fl.CompiledProgram(main).with_sequence_parallel(sp=4,
                                                           mode="ulysses")
    f = odd_feed()
    n = 32 // 4
    local = {"q": f["q"][:, rank * n:(rank + 1) * n],
             "mask": f["mask"][:, rank * n:(rank + 1) * n], "lbl": f["lbl"]}
    out["fallback"] = {"loss": float(exe.run(prog, feed=local,
                                             fetch_list=[loss],
                                             scope=scope)[0]),
                       "warnings": seen}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import paddle_tpu as jf
    from paddle_tpu_torch.parallel.env import free_port

    d = tmp_path_factory.mktemp("sp")
    main, startup, _ = gpt(jf)
    scope = jf.Scope()
    with jf.scope_guard(scope):
        jf.Executor(jf.CPUPlace()).run(startup)
    init = {"gpt": {v.name: np.asarray(scope.get_numpy(v.name))
                    for v in main.list_vars()
                    if v.persistable and not v.is_data
                    and scope.find_var(v.name) is not None}}
    np.savez(str(d / "init.npz"), **{kk: np.array(vv, dtype=object)
                                     for kk, vv in init.items()})
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
    return [json.loads((d / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def _jax_attn(mode, sp, causal, use_mask):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from paddle_tpu.parallel.ring_attention import make_ring_attention_fn
    from paddle_tpu.parallel.ulysses import make_ulysses_attention_fn

    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    make = (make_ring_attention_fn if mode == "ring"
            else make_ulysses_attention_fn)
    fn = make(mesh, "sp", causal=causal, with_mask=use_mask)
    q, k, v, mask = (jnp.asarray(t) for t in _qkv())
    args = (q, k, v, mask) if use_mask else (q, k, v)
    o = jax.jit(fn)(*args)

    def loss(q, k, v):
        return (fn(*((q, k, v, mask) if use_mask else (q, k, v)))
                .astype(jnp.float32) ** 2).sum()

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(o)] + [np.asarray(g) for g in grads]


def _jax_kernel_attn(causal, use_mask):
    """JAX's flash kernels (interpret mode) on the whole sequence: what
    Ulysses computes locally on its heads."""
    import importlib

    import jax
    import jax.numpy as jnp

    jf_flash = importlib.import_module("paddle_tpu.kernels.flash_attention")
    q, k, v, mask = (jnp.asarray(t) for t in _qkv())
    m = mask if use_mask else None

    def loss(q, k, v):
        return (jf_flash.flash_attention(q, k, v, causal=causal, mask=m)
                ** 2).sum()

    o = jf_flash.flash_attention(q, k, v, causal=causal, mask=m)
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(o)] + [np.asarray(g) for g in grads]


def _live_rows(causal, use_mask):
    """[B, 1, S, 1] True where a query row sees at least one key."""
    _, _, _, mask = _qkv()
    seen = np.ones((B, S, S), bool)
    if use_mask:
        seen &= (mask > -1)[:, None, :]
    if causal:
        seen &= np.tril(np.ones((S, S), bool))[None]
    return seen.any(-1)[:, None, :, None]


@pytest.mark.parametrize("mode,sp,causal,use_mask", _cases())
def test_attention_forward_and_gradients_match_jax(world, monkeypatch, mode,
                                                   sp, causal, use_mask):
    want = _jax_attn(mode, sp, causal, use_mask)
    fwd_tol, grad_tol = TOL[mode]
    live = np.broadcast_to(_live_rows(causal, use_mask), want[0].shape)
    if mode == "ulysses":
        # Ulysses runs the flash kernels (K6 / K8), which port JAX's
        # Pallas kernels: held whole to them (interpret mode), and to
        # JAX's Ulysses on every query row that sees a key. A row that
        # sees none has the kernels' lse-based gradient
        # (test_torch_flash_attention.py::test_fully_masked_row_matches_
        # jax); JAX's Ulysses on the CPU takes its plain path there
        monkeypatch.setenv("PADDLE_TPU_FLASH_INTERPRET", "1")
        kern = _jax_kernel_attn(causal, use_mask)
    for r in world:
        got = [np.asarray(t) for t in
               r["attn"][f"{mode}-{sp}-{causal}-{use_mask}"]]
        np.testing.assert_allclose(got[0], want[0], rtol=fwd_tol,
                                   atol=fwd_tol)
        for g, w, name in zip(got[1:], want[1:], "qkv"):
            rows = live if name == "q" else np.ones_like(live)
            if mode == "ulysses" and name != "q":
                # a dead query row's gradient reaches every key
                rows = np.broadcast_to(live.all(axis=2, keepdims=True),
                                       live.shape)
            np.testing.assert_allclose(g[rows], w[rows], rtol=grad_tol,
                                       atol=grad_tol, err_msg=name)
        if mode == "ulysses":
            for g, w, name in zip(got, kern, "oqkv"):
                np.testing.assert_allclose(g, w, rtol=grad_tol,
                                           atol=grad_tol, err_msg=name)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
@pytest.mark.parametrize("dp,sp", [(1, 4), (2, 2)])
def test_gpt_trains_sequence_parallel_like_jax(world, mode, dp, sp):
    import paddle_tpu as jf

    main, startup, loss = gpt(jf)
    scope = jf.Scope()
    with jf.scope_guard(scope):
        exe = jf.Executor(jf.CPUPlace())
        exe.run(startup)
        prog = jf.CompiledProgram(main).with_sequence_parallel(
            sp=sp, dp=dp, mode=mode)
        want = [float(np.asarray(exe.run(prog, feed=b,
                                         fetch_list=[loss])[0]).reshape(()))
                for b in gpt_batches()]
    for r in world:
        np.testing.assert_allclose(r[f"gpt_{mode}_{dp}x{sp}"], want,
                                   rtol=GPT_RTOL, atol=GPT_RTOL)


def test_ulysses_with_heads_not_dividing_falls_back_to_the_ring(world):
    import paddle_tpu as jf

    main, startup, loss = odd(jf)
    scope = jf.Scope()
    with jf.scope_guard(scope):
        exe = jf.Executor(jf.CPUPlace())
        exe.run(startup)
        prog = jf.CompiledProgram(main).with_sequence_parallel(
            sp=4, mode="ulysses")
        want = float(np.asarray(exe.run(prog, feed=odd_feed(),
                                        fetch_list=[loss])[0]).reshape(()))
    for r in world:
        assert abs(r["fallback"]["loss"] - want) < 1e-5
        assert any("using ring" in w for w in r["fallback"]["warnings"])


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.path.insert(0, REPO)
        _worker(sys.argv[2])
