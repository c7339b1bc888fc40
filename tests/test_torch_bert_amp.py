"""The port's flash-attention models and bfloat16 AMP against the JAX
package, on the CPU.

(a) ``build_gpt_lm(use_flash_attention=True)`` and
    ``build_bert_pretrain`` (flash and op-graph attention, with and
    without ``contrib.mixed_precision.decorate``) give the JAX package's
    programs, main and startup, casts and AMP ops included;
(b) from the JAX startup's parameters (``io.load_scope_arrays``), five
    Adam steps give the JAX losses within rtol 2e-4 / atol 2e-5 and every
    persistable within 1e-5 in float32 (the training tests' bounds), the
    JAX flash op running its Pallas kernels in interpret mode. All
    dropout is 0: the two frameworks' random streams differ.
    Under bfloat16 AMP the matmuls round their operands and outputs to
    bfloat16 in both packages, with float32 sums in another order, so a
    product can land one bfloat16 step (2^-8 relative) apart: the
    losses agree within rtol 1e-4, and a parameter within 2·lr per
    step (Adam moves an entry by about lr a step, in the direction of
    its gradient's sign, which can differ for entries near 0);
(c) ``check_finite_and_unscale`` and ``update_loss_scaling`` against the
    JAX lowerings on gradients holding inf and nan, over a scripted
    sequence that grows and shrinks the scale.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.contrib.mixed_precision import decorate as jax_decorate
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.core.framework import unique_name as jax_unique_name
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import registry as port_registry
from paddle_tpu_torch.io import load_scope_arrays
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt

SEQ, BATCH, STEPS, LR = 16, 4, 5, 1e-3

# name -> (model, flash, amp, dynamic loss scaling)
VARIANTS = {
    "gpt_flash": ("gpt", True, False, False),
    "bert_flash": ("bert", True, False, False),
    "bert_graph": ("bert", False, False, False),
    "bert_flash_amp": ("bert", True, True, False),
    "bert_graph_amp": ("bert", False, True, False),
    "bert_flash_amp_dynamic": ("bert", True, True, True),
}


@pytest.fixture
def unfused():
    """The unfused adam op in both packages (the port's "auto" is off on
    a machine without CUDA; the JAX default may differ)."""
    saved = (jfluid.get_flags("optimizer_fuse")["optimizer_fuse"],
             fluid.get_flags("optimizer_fuse")["optimizer_fuse"])
    jfluid.set_flags({"optimizer_fuse": "off"})
    fluid.set_flags({"optimizer_fuse": "off"})
    yield
    jfluid.set_flags({"optimizer_fuse": saved[0]})
    fluid.set_flags({"optimizer_fuse": saved[1]})


def _build(pkg, variant):
    model, flash, amp, dynamic = VARIANTS[variant]
    jax_side = pkg is jfluid
    opt = pkg.optimizer.AdamOptimizer(LR)
    if amp:
        dec = jax_decorate if jax_side else fluid.contrib.mixed_precision.decorate
        opt = dec(opt, init_loss_scaling=1.0 if not dynamic else 8.0,
                  use_dynamic_loss_scaling=dynamic, incr_every_n_steps=2,
                  dest_dtype="bfloat16")
    unique = jax_unique_name if jax_side else fluid.unique_name
    with unique.guard():
        if model == "gpt":
            mod = jgpt if jax_side else tgpt
            cfg = mod.GPTConfig.tiny()
            cfg.use_flash_attention = flash
            return mod.build_gpt_lm(cfg, SEQ, opt)
        mod = jbert if jax_side else tbert
        cfg = mod.BertConfig.tiny()
        cfg.use_flash_attention = flash
        cfg.hidden_dropout = cfg.attention_dropout = 0.0
        return mod.build_bert_pretrain(cfg, SEQ, opt)


def _batch(variant):
    rng = np.random.RandomState(7)
    if VARIANTS[variant][0] == "gpt":
        return tgpt.synthetic_lm_batch(rng, BATCH, SEQ, 1000)
    return tbert.synthetic_batch(rng, BATCH, SEQ, 1024, min_len=5)


def _persistables(program):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and not v.is_data)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_program_matches_jax(variant, unfused):
    jmain, jstart, _, _ = _build(jfluid, variant)
    tmain, tstart, _, _ = _build(fluid, variant)
    for jp, tp in ((jmain, tmain), (jstart, tstart)):
        jb, tb = jp.to_dict()["blocks"][0], tp.to_dict()["blocks"][0]
        assert [op["type"] for op in tb["ops"]] == \
            [op["type"] for op in jb["ops"]]
        assert tb == jb
    types_ = [op.type for op in tmain.global_block().ops]
    model, flash, amp, dynamic = VARIANTS[variant]
    layers_ = 2
    assert types_.count("flash_attention") == (layers_ if flash else 0)
    assert types_.count("flash_attention_grad") == (layers_ if flash else 0)
    assert ("cast" in types_) == amp
    assert ("check_finite_and_unscale" in types_) == amp
    assert ("update_loss_scaling" in types_) == dynamic


def _train_jax(variant, batch):
    main, startup, _, fetches = _build(jfluid, variant)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
        losses = [float(np.asarray(exe.run(main, feed=batch,
                                           fetch_list=[fetches["loss"]])[0])
                        .reshape(-1)[0]) for _ in range(STEPS)]
        final = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
    return init, losses, final


def _train_port(variant, batch, init):
    main, _, _, fetches = _build(fluid, variant)
    scope = fluid.Scope()
    load_scope_arrays(scope, init, main, "cpu")
    exe = fluid.Executor(fluid.CPUPlace())
    losses = [float(np.asarray(exe.run(main, feed=batch,
                                       fetch_list=[fetches["loss"]],
                                       scope=scope)[0]).reshape(-1)[0])
              for _ in range(STEPS)]
    return losses, {n: scope.get_numpy(n) for n in _persistables(main)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_training_matches_jax(variant, unfused, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLASH_INTERPRET", "1")
    batch = _batch(variant)
    init, jlosses, jfinal = _train_jax(variant, batch)
    tlosses, tfinal = _train_port(variant, batch, init)
    assert np.all(np.isfinite(tlosses)) and tlosses[-1] < tlosses[0]
    assert sorted(tfinal) == sorted(jfinal)
    if VARIANTS[variant][2]:      # bfloat16 AMP: see the module docstring
        np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4, atol=0)
        atol = 2 * LR * STEPS
    else:
        np.testing.assert_allclose(tlosses, jlosses, rtol=2e-4, atol=2e-5)
        atol = 1e-5
    for n in jfinal:
        np.testing.assert_allclose(tfinal[n], jfinal[n], rtol=0, atol=atol,
                                   err_msg=n)


def test_amp_forward_dtypes():
    """Under the decorator the matmuls take bfloat16 operands (the casts
    inserted before them) and the black-list ops float32; the fused Adam
    / adam ops update float32 parameters with float32 gradients."""
    main, startup, feeds, fetches = _build(fluid, "bert_flash_amp")
    block = main.global_block()
    for op in block.ops:
        if op.type == "mul" and int(op.attrs.get("op_role", 0)) == 0:
            assert block.var(op.inputs["Y"][0]).dtype == "bfloat16"
        if op.type in ("layer_norm", "softmax_with_cross_entropy"):
            for n in op.inputs.get("X", []) + op.inputs.get("Logits", []):
                assert block.var(n).dtype == "float32", (op.type, n)
        if op.type == "adam":
            assert block.var(op.inputs["Param"][0]).dtype == "float32"
            assert block.var(op.inputs["Grad"][0]).dtype == "float32"


class _Op:
    def __init__(self, **attrs):
        self.attrs = attrs


def _jax_run(type_, op, ins):
    return jax_registry.get_op_def(type_).lower(
        types.SimpleNamespace(), op,
        {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()})


def _port_run(type_, op, ins):
    return port_registry.get_op_def(type_).lower(
        None, op, {k: [torch.tensor(np.asarray(v)) for v in vs]
                   for k, vs in ins.items()})


def test_loss_scaling_ops_match_jax():
    """A scripted run of check_finite_and_unscale + update_loss_scaling:
    finite steps grow the scale every 3, two non-finite ones (inf, nan)
    shrink it, a clean step resets the bad count; outputs, flag, scale
    and counters equal the JAX lowerings' at every step."""
    rng = np.random.RandomState(0)
    upd = _Op(incr_every_n_steps=3, decr_every_n_nan_or_inf=2,
              incr_ratio=2.0, decr_ratio=0.5)
    state = {"scale": np.array([2.0], "float32"),
             "good": np.array([0], "int32"), "bad": np.array([0], "int32")}
    script = ["ok", "ok", "ok", "inf", "ok", "nan", "inf", "ok", "ok", "ok",
              "nan", "nan", "nan", "nan", "nan", "nan", "ok"]
    scales = []
    for step, kind in enumerate(script):
        grads = [rng.randn(3, 4).astype("float32"),
                 rng.randn(5).astype("float32")]
        if kind != "ok":
            grads[step % 2].flat[step % 5] = np.inf if kind == "inf" else np.nan
        ins = {"X": grads, "Scale": [state["scale"]]}
        j = _jax_run("check_finite_and_unscale", _Op(), ins)
        t = _port_run("check_finite_and_unscale", _Op(), ins)
        assert bool(t["FoundInfinite"][0]) == bool(j["FoundInfinite"][0]) \
            == (kind != "ok")
        for a, b in zip(t["Out"], j["Out"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        ins2 = {"X": [np.asarray(x) for x in j["Out"]],
                "FoundInfinite": [np.asarray(j["FoundInfinite"][0])],
                "PrevLossScaling": [state["scale"]],
                "InGoodSteps": [state["good"]], "InBadSteps": [state["bad"]]}
        j2 = _jax_run("update_loss_scaling", upd, ins2)
        t2 = _port_run("update_loss_scaling", upd, ins2)
        for slot in ("LossScaling", "OutGoodSteps", "OutBadSteps"):
            a, b = t2[slot][0].numpy(), np.asarray(j2[slot][0])
            assert a.dtype == b.dtype and a.shape == b.shape, slot
            np.testing.assert_array_equal(a, b, err_msg=f"{slot} step {step}")
        for a, b in zip(t2["Out"], j2["Out"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        state = {"scale": np.asarray(j2["LossScaling"][0]),
                 "good": np.asarray(j2["OutGoodSteps"][0]),
                 "bad": np.asarray(j2["OutBadSteps"][0])}
        scales.append(float(state["scale"][0]))
    # grew at steps 2 and 9, shrank at 6, 11 and 13, held at the floor 1
    assert [scales[i] for i in (2, 6, 9, 11, 13, 15)] == [4, 2, 4, 2, 1, 1]
