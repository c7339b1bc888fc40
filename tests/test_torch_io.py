"""paddle_tpu_torch.io against paddle_tpu.io, on the CPU.

Both packages write the same files (``__params__.npz`` and a JSON
``__model__``; ``save``'s ``.pdparams.npz`` / ``.pdmodel.json``), so a
directory written by either loads in the other with equal arrays and
equal programs. Each package builds the same program under
``unique_name.guard()``, so the programs compare as ``to_dict()``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.generation.model import GPTConfig as JaxGPTConfig
from paddle_tpu.generation.model import build_lm_program as jax_build_lm

import paddle_tpu_torch as fluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.generation import build_lm_program
from paddle_tpu_torch.models.gpt import GPTConfig

PKGS = {"jax": jfluid, "torch": fluid}


def _cpu(pkg):
    return pkg.Executor(pkg.CPUPlace())


def _mlp(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [6])
        h = pkg.layers.fc(x, 12, act="relu")
        out = pkg.layers.fc(h, 3, act="softmax")
    return main, startup, ["x"], [out]


def _masked(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        ids = pkg.layers.data("ids", [-1], dtype="int64")
        mask = pkg.layers.data("mask", [-1], dtype="float32")
        emb = pkg.layers.embedding(ids, size=[50, 8])
        m = pkg.layers.unsqueeze(mask, [2])
        pooled = pkg.layers.elementwise_div(
            pkg.layers.reduce_sum(pkg.layers.elementwise_mul(emb, m), dim=[1]),
            pkg.layers.reduce_sum(m, dim=[1]))
        out = pkg.layers.fc(pooled, 16, act="softmax")
    return main, startup, ["ids", "mask"], [out]


def _lm(pkg, flash=False):
    kw = dict(vocab_size=61, hidden_size=16, num_layers=2, num_heads=2,
              ffn_size=32, max_position=16, hidden_dropout=0.0,
              attention_dropout=0.0, use_flash_attention=flash)
    if pkg is jfluid:
        main, startup, _f, fetches = jax_build_lm(JaxGPTConfig(**kw), 12)
    else:
        main, startup, _f, fetches = build_lm_program(GPTConfig(**kw), 12)
    return main, startup, ["tokens"], [fetches["logits"]]


BUILDERS = {"mlp": _mlp, "masked": _masked, "lm": _lm,
            "lm_flash": lambda pkg: _lm(pkg, flash=True)}


def _save(pkg, build, d):
    """Build, initialize (the package's own startup) and save; returns
    the saved params as numpy."""
    main, startup, feeds, targets = build(pkg)
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        exe = _cpu(pkg)
        exe.run(startup)
        pkg.io.save_inference_model(d, feeds, targets, exe, main)
    with np.load(f"{d}/__params__.npz") as z:
        return {k: z[k] for k in z.files}


def _load(pkg, d):
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        program, feeds, fetches = pkg.io.load_inference_model(d, _cpu(pkg))
    arrays = {v.name: np.asarray(scope.find_var(v.name)) if pkg is jfluid
              else scope.find_var(v.name).numpy()
              for v in program.global_block().vars.values()
              if v.persistable and not v.is_data}
    return program, feeds, [v.name for v in fetches], arrays


@pytest.mark.parametrize("model", sorted(BUILDERS))
@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_inference_dir_loads_in_the_other_package(tmp_path, model, writer,
                                                  reader):
    d = str(tmp_path)
    saved = _save(PKGS[writer], BUILDERS[model], d)
    rprog, rfeeds, rfetch, rarrays = _load(PKGS[reader], d)
    wprog, wfeeds, wfetch, warrays = _load(PKGS[writer], d)
    assert rprog.to_dict() == wprog.to_dict()
    assert (rfeeds, rfetch) == (wfeeds, wfetch)
    assert set(rarrays) == set(warrays) == set(saved)
    for n, a in saved.items():
        np.testing.assert_array_equal(rarrays[n], a, err_msg=n)
        np.testing.assert_array_equal(warrays[n], a, err_msg=n)
    # the program each package saves is the same one
    other = str(tmp_path / "other")
    _save(PKGS[reader], BUILDERS[model], other)
    assert tio.load_model_meta(other) == tio.load_model_meta(d)


def _train_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [6])
        y = pkg.layers.data("y", [1], dtype="int64")
        h = pkg.layers.fc(x, 12, act="relu")
        logits = pkg.layers.fc(h, 3)
        prob = pkg.layers.softmax(logits)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        pkg.optimizer.AdamOptimizer(1e-2).minimize(loss)
    return main, startup, prob, loss


@pytest.mark.parametrize("target", ["prob", "loss"])
def test_prune_program_matches_jax(target):
    from paddle_tpu.io import _prune_program as jax_prune

    from paddle_tpu_torch.io import _prune_program

    jm, _, jprob, jloss = _train_program(jfluid)
    tm, _, tprob, tloss = _train_program(fluid)
    jt, tt = (jprob, tprob) if target == "prob" else (jloss, tloss)
    jp = jax_prune(jm, ["x"], [jt]).to_dict()
    tp = _prune_program(tm, ["x"], [tt]).to_dict()
    assert [o["type"] for o in tp["blocks"][0]["ops"]] == \
        [o["type"] for o in jp["blocks"][0]["ops"]]
    assert tp == jp
    # the training ops never survive a prune to the forward
    assert not {"adam", "mul_grad"} & {o["type"]
                                       for o in tp["blocks"][0]["ops"]}


def _trained_state(pkg, steps=2):
    main, startup, _prob, loss = _train_program(pkg)
    scope = pkg.Scope()
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(8, 6).astype("float32"),
            "y": rng.randint(0, 3, (8, 1)).astype("int64")}
    with pkg.scope_guard(scope):
        exe = _cpu(pkg)
        exe.run(startup)
        for _ in range(steps):
            exe.run(main, feed=feed, fetch_list=[loss])
    return main, scope


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch"),
                                           ("torch", "torch")])
def test_save_and_load_whole_state(tmp_path, writer, reader):
    """``save(program, path)`` then ``load(program, path)``: every
    persistable (parameters, Adam moments, beta pows, learning rate)
    round-trips exactly, across packages too; ``load_program_state``
    reads the same file and ``set_program_state`` writes it back."""
    wpkg, rpkg = PKGS[writer], PKGS[reader]
    wmain, wscope = _trained_state(wpkg)
    path = str(tmp_path / "model")
    with wpkg.scope_guard(wscope):
        wpkg.io.save(wmain, path)
    rmain, _s, _p, _l = _train_program(rpkg)
    rscope = rpkg.Scope()
    with rpkg.scope_guard(rscope):
        if rpkg is fluid:
            fluid.io.load(rmain, path, _cpu(fluid))
        else:
            jfluid.io.load(rmain, path)
    names = sorted(v.name for v in wmain.list_vars()
                   if v.persistable and not v.is_data)
    assert len(names) > 6
    for n in names:
        np.testing.assert_array_equal(np.asarray(rscope.find_var(n)),
                                      np.asarray(wscope.find_var(n)),
                                      err_msg=n)
    state = rpkg.io.load_program_state(path)
    assert sorted(state) == names
    fresh = rpkg.Scope()
    with rpkg.scope_guard(fresh):
        if rpkg is fluid:
            n_set = fluid.io.set_program_state(rmain, state, device="cpu")
        else:
            n_set = jfluid.io.set_program_state(rmain, state)
    assert n_set == len(names)
    for n in names:
        np.testing.assert_array_equal(np.asarray(fresh.find_var(n)),
                                      state[n], err_msg=n)
    only = rpkg.io.load_program_state(path, var_list=names[:2])
    assert sorted(only) == names[:2]


def test_save_vars_params_and_persistables(tmp_path):
    """The port's per-kind savers write what the JAX ones write, and
    its loaders take it back into the declared dtypes on the CPU."""
    tmain, tscope = _trained_state(fluid)
    jmain, jscope = _trained_state(jfluid)
    for kind in ("params", "persistables"):
        tdir, jdir = str(tmp_path / f"t_{kind}"), str(tmp_path / f"j_{kind}")
        with fluid.scope_guard(tscope):
            getattr(fluid.io, f"save_{kind}")(None, tdir, tmain)
        with jfluid.scope_guard(jscope):
            getattr(jfluid.io, f"save_{kind}")(None, jdir, jmain)
        with np.load(f"{tdir}/__params__.npz") as t, \
                np.load(f"{jdir}/__params__.npz") as j:
            assert sorted(t.files) == sorted(j.files)
            for n in t.files:
                assert t[n].shape == j[n].shape and t[n].dtype == j[n].dtype
        back = fluid.Scope()
        with fluid.scope_guard(back):
            getattr(fluid.io, f"load_{kind}")(_cpu(fluid), tdir, tmain)
        for n in back.local_var_names():
            v = tmain.global_block().var(n)
            assert back.find_var(n).dtype == fluid.core.executor.torch_dtype(
                v.dtype)
            torch.testing.assert_close(back.find_var(n), tscope.find_var(n),
                                       rtol=0, atol=0)
    assert [p.name for p in fluid.io.get_program_parameter(tmain)] == \
        [p.name for p in jfluid.io.get_program_parameter(jmain)]
    assert [v.name for v in fluid.io.get_program_persistable_vars(tmain)] \
        == [v.name for v in jfluid.io.get_program_persistable_vars(jmain)]


def test_bfloat16_arrays_cross_bit_for_bit():
    """A bfloat16 array as the JAX package saves it (``ml_dtypes``, or a
    2-byte void without it) becomes the same bfloat16 tensor."""
    import ml_dtypes

    x = np.random.RandomState(0).randn(5, 7).astype(ml_dtypes.bfloat16)
    want = torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    for arr in (x, x.view("V2")):
        t = tio.array_to_tensor(arr)
        assert t.dtype == torch.bfloat16
        assert torch.equal(t.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("flash", [False, True])
def test_build_lm_program_matches_jax(flash):
    kw = dict(vocab_size=97, hidden_size=32, num_layers=3, num_heads=4,
              ffn_size=64, max_position=64, use_flash_attention=flash)
    jm, js, jf, jo = jax_build_lm(JaxGPTConfig(**kw), 24)
    tm, ts, tf, to = build_lm_program(GPTConfig(**kw), 24)
    assert tm.to_dict() == jm.to_dict()
    assert ts.to_dict() == js.to_dict()
    assert sorted(tf) == sorted(jf) == ["tokens"]
    assert to["logits"].name == jo["logits"].name
    assert tuple(to["logits"].shape) == tuple(jo["logits"].shape)
