"""The port's switch-MoE (``ops/moe.py``, ``layers/extras.py``, the
``moe_every`` path of ``models/gpt.py``) against the JAX package, on the
CPU: twins of the dense tests of tests/test_moe.py, plus:

(a) the op against JAX's dense lowering on the same inputs, with tokens
    dropped (capacity factor 0.5) and without: ``Out`` and ``AuxLoss``
    at ``OP_RTOL`` / ``OP_ATOL``, the gradients of all six inputs at
    ``GRAD_RTOL`` / ``GRAD_ATOL``; ties in the router go to the lower
    expert, as ``jnp.argmax``'s; the capacity in JAX's float arithmetic;
(b) the experts' GELU is the tanh approximation (JAX's default), not
    the dense FFN's exact one;
(c) the tiny MoE GPT (two switch layers) trains 3 Adam steps as JAX's
    from JAX's startup values (losses and every persistable at
    ``TRAIN_RTOL`` / ``TRAIN_ATOL``), and its programs (training and
    ``is_test``) equal JAX's op for op;
(d) an ``ep`` mesh set on a bare lowering context is refused naming
    A10a (expert parallelism runs through
    ``CompiledProgram.with_expert_parallel`` in a world:
    tests/test_torch_parallel.py), and
    the generation engines' GPTLM refuses ``moe_every`` (the JAX engine
    builds dense FFNs only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core.framework import unique_name as jax_unique_name
from paddle_tpu.core.registry import get_op_def as jget_op_def
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.io import load_scope_arrays
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops.moe import moe_capacity

OP_RTOL, OP_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5
SLOTS = ("X", "GateW", "ExpertW1", "ExpertB1", "ExpertW2", "ExpertB2")


def _names(pkg):
    return jax_unique_name if pkg is jfluid else fluid.unique_name


def _build(pkg, E=4, D=8, F=16, seed=21, cap=8.0):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), _names(pkg).guard():
        x = pkg.layers.data("x", [6, D])
        y = pkg.layers.data("y", [6, D])
        out, aux = pkg.layers.switch_moe(x, E, F, capacity_factor=cap)
        mse = pkg.layers.mean(pkg.layers.square_error_cost(out, y))
        loss = pkg.layers.elementwise_add(
            mse, pkg.layers.scale(aux, scale=0.01))
        loss = pkg.layers.mean(loss)
        pkg.optimizer.Adam(5e-3).minimize(loss)
    return main, startup, loss


def _feed(rng, B=8, S=6, D=8):
    x = rng.randn(B, S, D).astype("float32")
    return {"x": x, "y": np.tanh(x[..., ::-1].copy())}


def _persistables(program):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and not v.is_data)


# -- twins of tests/test_moe.py ------------------------------------------------


def test_switch_moe_trains_dense():
    main, startup, loss = _build(fluid)
    rng = np.random.RandomState(0)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    ls = [float(exe.run(main, feed=_feed(rng), fetch_list=[loss],
                        scope=scope)[0]) for _ in range(40)]
    assert ls[-1] < ls[0] * 0.6, (ls[0], ls[-1])


def test_capacity_drops_tokens():
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4, 8])
        out, aux = fluid.layers.switch_moe(x, 4, 8, capacity_factor=0.25)
    rng = np.random.RandomState(2)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    o, a = exe.run(main, feed={"x": rng.randn(4, 4, 8).astype("f")},
                   fetch_list=[out, aux], scope=scope)
    assert np.isfinite(o).all()
    assert float(a.reshape(-1)[0]) > 0
    # capacity 1 per expert over 16 tokens: most rows must be zeros
    zero_rows = np.sum(np.all(o.reshape(-1, 8) == 0, axis=1))
    assert zero_rows >= 8, zero_rows


def test_switch_moe_user_param_attr_names():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4, 8])
        fluid.layers.switch_moe(x, 2, 8,
                                param_attr=fluid.ParamAttr(name="moe"),
                                bias_attr=fluid.ParamAttr(name="moeb"))
    names = sorted(p.name for p in main.all_parameters())
    assert names == ["moe.gate", "moe.w1", "moe.w2", "moeb.b1", "moeb.b2"]


def _tiny_moe_cfg(mod):
    cfg = mod.GPTConfig.tiny()
    cfg.moe_every, cfg.moe_experts, cfg.moe_capacity = 1, 4, 8.0
    return cfg


def test_gpt_moe_trains_dense():
    cfg = _tiny_moe_cfg(tgpt)
    batch = tgpt.synthetic_lm_batch(np.random.RandomState(0), 2, 32,
                                    cfg.vocab_size)
    main, startup, _, fetches = tgpt.build_gpt_lm(
        cfg, 32, optimizer=fluid.optimizer.Adam(1e-3))
    main.random_seed = startup.random_seed = 7
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    ls = [float(exe.run(main, feed=batch, fetch_list=[fetches["loss"]],
                        scope=scope)[0]) for _ in range(3)]
    assert ls[-1] < ls[0], ls


def test_moe_inference_roundtrip(tmp_path):
    from paddle_tpu_torch.inference import Config, create_predictor

    d = str(tmp_path / "moe_model")
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 31
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4, 8])
        out, aux = fluid.layers.switch_moe(x, 4, 16, capacity_factor=8.0)
        y = fluid.layers.fc(out, 3)
    scope = fluid.Scope()
    xv = np.random.RandomState(6).randn(2, 4, 8).astype("float32")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(d, ["x"], [y], exe, main_program=main)
        (want,) = exe.run(main, feed={"x": xv}, fetch_list=[y])
    pred = create_predictor(Config(d), device="cpu")
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(xv)
    pred.zero_copy_run()
    got = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5, atol=1e-6)


def test_moe_program_roundtrips_with_tags():
    main, startup, loss = _build(fluid)
    r = fluid.Program.from_json(main.to_json())
    gb, ob = r.global_block(), main.global_block()
    for name, v in ob.vars.items():
        rv = gb.var(name)
        for t in ("_moe_expert_param", "is_accumulator", "accumulator_owner"):
            assert getattr(rv, t, None) == getattr(v, t, None), (name, t)
    tagged = sorted(n for n, v in gb.vars.items()
                    if getattr(v, "_moe_expert_param", False))
    assert len(tagged) == 4, tagged
    # the loaded program runs as the built one
    rng = np.random.RandomState(0)
    feed = _feed(rng)
    got = []
    for prog in (main, r):
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        got.append(exe.run(prog, feed=feed, fetch_list=[loss.name],
                           scope=scope)[0])
    np.testing.assert_array_equal(got[0], got[1])


def test_switch_moe_fd_gradients():
    """Finite differences of the port's lowering (float64 on the CPU)
    match autograd for every input, router logits well away from the
    argmax boundaries (JAX's test's construction)."""
    rng = np.random.RandomState(17)
    T, D, E, F = 6, 4, 3, 5
    pick = rng.randint(0, E, T)
    x = np.concatenate([rng.randn(T, D) * 0.3, np.eye(E)[pick] * 3.0], 1)
    wg = np.concatenate([rng.randn(D, E) * 0.01, np.eye(E)])
    D2 = D + E
    args = [x, wg, rng.randn(E, D2, F) * 0.3, rng.randn(E, F) * 0.1,
            rng.randn(E, F, D2) * 0.3, rng.randn(E, D2) * 0.1]
    proj = torch.from_numpy(rng.randn(T, D2))

    class _Op:
        attrs = {"capacity_factor": 8.0, "act": "gelu"}

    def loss(*a):
        outs = get_op_def("switch_moe").lower(None, _Op(), dict(
            zip(SLOTS, [[t] for t in a])))
        return (outs["Out"][0] * proj).sum() + 0.1 * outs["AuxLoss"][0][0]

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    grads = torch.autograd.grad(loss(*leaves), leaves)
    eps = 1e-6
    for ai, (a, g) in enumerate(zip(args, grads)):
        flat = a.reshape(-1)
        for i in rng.choice(flat.size, size=min(8, flat.size), replace=False):
            ap, am = flat.copy(), flat.copy()
            ap[i] += eps
            am[i] -= eps
            vp = [torch.from_numpy(v) for v in args]
            vm = list(vp)
            vp[ai] = torch.from_numpy(ap.reshape(a.shape))
            vm[ai] = torch.from_numpy(am.reshape(a.shape))
            fd = (float(loss(*vp)) - float(loss(*vm))) / (2 * eps)
            np.testing.assert_allclose(g.numpy().reshape(-1)[i], fd,
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"arg {ai} coord {i}")


# -- (a) the op against JAX's ------------------------------------------------


class _MoeOp:
    type = "switch_moe"

    def __init__(self, cap, act="gelu"):
        self.attrs = {"capacity_factor": cap, "act": act}


def _moe_inputs(rng, T=24, D=8, E=4, F=12, ties=False):
    x = rng.randn(2, T // 2, D).astype("f")
    wg = rng.randn(D, E).astype("f")
    if ties:
        wg[:, 1] = wg[:, 0]      # experts 0 and 1 always tie
    return [x, wg, (rng.randn(E, D, F) * 0.3).astype("f"),
            (rng.randn(E, F) * 0.1).astype("f"),
            (rng.randn(E, F, D) * 0.3).astype("f"),
            (rng.randn(E, D) * 0.1).astype("f")]


def _jax_op(args, op):
    outs = jget_op_def("switch_moe").lower(
        jfluid.core.registry.LoweringContext(), op,
        dict(zip(SLOTS, [[jnp.asarray(a)] for a in args])))
    return outs["Out"][0], outs["AuxLoss"][0]


@pytest.mark.parametrize("cap", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_switch_moe_op_and_grads_equal_jax(cap, act):
    rng = np.random.RandomState(5)
    args = _moe_inputs(rng)
    op = _MoeOp(cap, act)
    jout, jaux = _jax_op(args, op)
    w = rng.randn(*np.asarray(jout).shape).astype("f")
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    outs = get_op_def("switch_moe").lower(None, op, dict(
        zip(SLOTS, [[t] for t in leaves])))
    tout, taux = outs["Out"][0], outs["AuxLoss"][0]
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=OP_RTOL, atol=OP_ATOL)
    np.testing.assert_allclose(taux.detach().numpy(), np.asarray(jaux),
                               rtol=OP_RTOL, atol=OP_ATOL)
    if cap == 0.5:
        dropped = np.all(tout.detach().numpy().reshape(-1, 8) == 0, axis=1)
        assert dropped.sum() > 0

    def jloss(*a):
        o, aux = _jax_op(a, op)
        return jnp.sum(o * w) + 0.3 * aux[0]

    jg = jax.grad(jloss, argnums=tuple(range(6)))(*[jnp.asarray(a)
                                                     for a in args])
    tl = (tout * torch.from_numpy(w)).sum() + 0.3 * taux[0]
    tg = torch.autograd.grad(tl, leaves)
    for slot, a, b in zip(SLOTS, tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=slot)


def test_router_ties_go_to_the_lower_expert():
    rng = np.random.RandomState(9)
    args = _moe_inputs(rng, ties=True)
    op = _MoeOp(8.0)
    jout, _ = _jax_op(args, op)
    tout = get_op_def("switch_moe").lower(None, op, dict(
        zip(SLOTS, [[torch.from_numpy(a)] for a in args])))["Out"][0]
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=OP_RTOL,
                               atol=OP_ATOL)
    from paddle_tpu_torch.ops.moe import route

    probs = torch.softmax(torch.from_numpy(args[0]).reshape(-1, 8)
                          @ torch.from_numpy(args[1]), -1)
    expert = route(probs, 100)[0]
    assert 1 not in expert.tolist()


@pytest.mark.parametrize("T,f,E", [(2048, 1.25, 8), (16, 0.25, 4),
                                   (48, 1.25, 8), (7, 0.3, 3), (1, 0.01, 8)])
def test_capacity_uses_jax_float_arithmetic(T, f, E):
    assert moe_capacity(T, f, E) == max(int(-(-T * f // E)), 1)
    assert moe_capacity(2048, 1.25, 8) == 320


def test_experts_use_the_tanh_gelu():
    rng = np.random.RandomState(2)
    args = _moe_inputs(rng)
    op = _MoeOp(8.0)
    outs = get_op_def("switch_moe").lower(None, op, dict(
        zip(SLOTS, [[torch.from_numpy(a)] for a in args])))
    x2 = torch.from_numpy(args[0]).reshape(-1, 8)
    probs = torch.softmax(x2 @ torch.from_numpy(args[1]), -1)
    e = torch.argmax(probs, -1)
    w1, b1 = torch.from_numpy(args[2]), torch.from_numpy(args[3])
    w2, b2 = torch.from_numpy(args[4]), torch.from_numpy(args[5])
    gate = probs.gather(1, e[:, None])[:, 0]
    for approx, equal in (("tanh", True), ("none", False)):
        h = torch.nn.functional.gelu(
            torch.einsum("td,tdf->tf", x2, w1[e]) + b1[e], approximate=approx)
        want = (torch.einsum("tf,tfd->td", h, w2[e]) + b2[e]) * gate[:, None]
        close = np.allclose(outs["Out"][0].reshape(-1, 8).numpy(),
                            want.numpy(), rtol=1e-5, atol=1e-6)
        assert close == equal, approx


# -- (c) the tiny MoE GPT against JAX ------------------------------------------


def _op_view(op):
    return (op.type, op.inputs, op.outputs,
            {k: v for k, v in op.attrs.items() if k != "op_ident"})


@pytest.mark.parametrize("is_test", [False, True])
def test_moe_gpt_program_equals_jax(is_test):
    progs = []
    for pkg, mod in ((jfluid, jgpt), (fluid, tgpt)):
        with _names(pkg).guard():
            opt = None if is_test else pkg.optimizer.Adam(1e-3)
            main, _, _, _ = mod.build_gpt_lm(_tiny_moe_cfg(mod), 32,
                                             optimizer=opt, is_test=is_test)
        progs.append(main)
    j, t = (p.global_block().ops for p in progs)
    assert [o.type for o in t].count("switch_moe") == 2
    assert [_op_view(o) for o in t] == [_op_view(o) for o in j]


def test_moe_gpt_trains_as_jax():
    cfg_j, cfg_t = _tiny_moe_cfg(jgpt), _tiny_moe_cfg(tgpt)
    cfg_j.moe_capacity = cfg_t.moe_capacity = 1.0     # tokens drop
    batch = tgpt.synthetic_lm_batch(np.random.RandomState(0), 2, 32,
                                    cfg_t.vocab_size)
    with jax_unique_name.guard():
        jmain, jstart, _, jf = jgpt.build_gpt_lm(
            cfg_j, 32, optimizer=jfluid.optimizer.Adam(1e-3))
    jmain.random_seed = jstart.random_seed = 7
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(jmain)}
        jl = [float(np.asarray(exe.run(jmain, feed=batch,
                                       fetch_list=[jf["loss"]])[0]))
              for _ in range(3)]
        jfinal = {n: np.asarray(scope.find_var(n)) for n in init}
    with fluid.unique_name.guard():
        tmain, _, _, tf_ = tgpt.build_gpt_lm(
            cfg_t, 32, optimizer=fluid.optimizer.Adam(1e-3))
    tscope = fluid.Scope()
    load_scope_arrays(tscope, init, tmain, "cpu")
    texe = fluid.Executor(fluid.CPUPlace())
    tl = [float(texe.run(tmain, feed=batch, fetch_list=[tf_["loss"]],
                         scope=tscope)[0]) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    for n in jfinal:
        np.testing.assert_allclose(tscope.get_numpy(n), jfinal[n],
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                   err_msg=n)


# -- (d) refusals ---------------------------------------------------------------


def test_an_ep_mesh_is_refused_naming_a10():
    from paddle_tpu_torch.core.registry import LoweringContext

    ctx = LoweringContext("cpu")
    ctx.mesh = {"ep": 4, "dp": 1}
    args = _moe_inputs(np.random.RandomState(0))
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        get_op_def("switch_moe").lower(ctx, _MoeOp(1.25), dict(
            zip(SLOTS, [[torch.from_numpy(a)] for a in args])))


def test_gptlm_refuses_moe_naming_the_dense_jax_engine():
    from paddle_tpu_torch.generation.model import GPTLM

    with pytest.raises(NotImplementedError, match="dense FFNs only"):
        GPTLM(_tiny_moe_cfg(tgpt), "cpu")


def test_moe_gpt_program_served_by_the_predictor(tmp_path):
    """A saved is_test MoE GPT: the predictor reads its config (the MoE
    layers from their parameter names and the program's switch_moe
    attrs), builds no dense GPTLM module, and serves the Program: logits
    equal the Executor's."""
    from paddle_tpu_torch.inference import Config, create_predictor

    cfg = _tiny_moe_cfg(tgpt)
    cfg.moe_every, cfg.moe_capacity, cfg.use_flash_attention = 2, 1.25, True
    with fluid.unique_name.guard():
        main, startup, _, fetches = tgpt.build_gpt_lm(cfg, 16, is_test=True)
    main.random_seed = startup.random_seed = 3
    batch = tgpt.synthetic_lm_batch(np.random.RandomState(1), 2, 16,
                                    cfg.vocab_size)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    (want,) = exe.run(main, feed=batch, fetch_list=[fetches["logits"]],
                      scope=scope)
    d = str(tmp_path / "moe_gpt")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, ["tokens"], [fetches["logits"]],
                                      exe, main)
    pred = create_predictor(Config(d), device="cpu")
    assert pred.lm is None
    got_cfg = pred.gpt_config
    assert (got_cfg.moe_every, got_cfg.moe_experts, got_cfg.moe_capacity,
            got_cfg.num_layers, got_cfg.ffn_size) == (2, 4, 1.25, 2, 256)
    (got,) = pred.run([batch["tokens"]])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
