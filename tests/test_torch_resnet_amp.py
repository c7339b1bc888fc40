"""ResNet-50 under bfloat16 AMP, the JAX bench's own ResNet recipe
(``decorate(Adam(1e-4), init_loss_scaling=1.0,
use_dynamic_loss_scaling=False, dest_dtype="bfloat16")``), the port
against the JAX package on the CPU.

(a) the decorated ``build_resnet50(1000, 224, ...)`` gives JAX's main
    and startup programs (``to_dict()``), NCHW and NHWC: 53 ``conv2d``s
    and the head's ``mul`` take bfloat16, batch norm, relu, the residual
    adds and the pools stay float32;
(b) the two-bottleneck net of ``test_torch_resnet.py`` under
    ``decorate`` (five Adam steps, lr 1e-3, batch 8 x 16^2) trains as
    JAX does: losses, parameters and batch-norm statistics within
    ``TRAIN_RTOL`` / ``TRAIN_ATOL``, Adam's moments within 2^-7 of each
    entry's own value; every forward bfloat16 tensor of the first step
    equal bit for bit;
(c) every op of the first step, given JAX's values of its inputs, gives
    JAX's outputs: each bfloat16 entry within one bfloat16 step of its
    own value (rtol 2^-7, atol bfloat16's smallest normal) and every
    forward bfloat16 output bit for bit; each float32 output within
    2^-20 of its largest entry, the level of float32 sums taken in
    another order.

(c) is where the bfloat16 gradients of a whole step are traced to their
ops. Given the same inputs, every bfloat16 output of the step is
bit-equal to JAX's but one entry of one filter gradient
(``conv2d_grad``'s Filter@GRAD, a float32 sum over the batch and the
image rounded one bfloat16 step apart). Over a whole step the bfloat16
gradients drift further: ``batch_norm_grad``'s X@GRAD sums dy and
dy·x̂ over the batch and the image in float32 in another order
(about 1e-8 apart at entries of 0.1), and where N·dy − Σdy − x̂·Σ(dy·x̂)
cancels to a small entry, its cast to bfloat16 (a convolution's output
gradient) lands up to 20 steps of its own value apart; the data and
filter gradients of the convolutions below carry that on. So the
step's bfloat16 gradients are held whole (one bfloat16 step at the
tensor's largest entry) and per entry only in (c).

The JAX side of (b) runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``. By default XLA:CPU
keeps a bfloat16 op's float32 result through the cast back to float32
that follows it, so JAX's CPU numbers skip the bfloat16 rounding the
program asks for and the card does (ROADMAP, known non-faults); the
flag restores it. It is set only in that subprocess: in the pytest
process it would change every JAX test. The full-depth net is no loss
oracle under AMP (its gradients at initialisation are ill-conditioned,
``test_torch_resnet.py``), so only its programs are compared.
"""

import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.contrib.mixed_precision import decorate as jax_decorate
from paddle_tpu.core.framework import unique_name as jax_unique_name
from paddle_tpu.models import resnet as jresnet

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core.executor import _Plan
from paddle_tpu_torch.core.registry import LoweringContext, run_recorded
from paddle_tpu_torch.io import load_scope_arrays
from paddle_tpu_torch.models import resnet as tresnet

from test_torch_resnet import (TRAIN_ATOL, TRAIN_RTOL, _batch, _fetchable,
                               _small_net)

LR, STEPS, BATCH, SIZE = 1e-3, 5, 8, 16
ORACLE_FLAGS = "--xla_allow_excess_precision=false"
# one bfloat16 step of an entry's own value, and bfloat16's smallest
# normal for the entries that are zero
BF16_RTOL, BF16_TINY = 2.0 ** -7, 2.0 ** -126


def _amp(pkg, lr):
    dec = jax_decorate if pkg is jfluid else fluid.contrib.mixed_precision.decorate
    return dec(pkg.optimizer.AdamOptimizer(lr), init_loss_scaling=1.0,
               use_dynamic_loss_scaling=False, dest_dtype="bfloat16")


@pytest.fixture
def fuse_flag():
    saved = (jfluid.get_flags("optimizer_fuse")["optimizer_fuse"],
             fluid.get_flags("optimizer_fuse")["optimizer_fuse"])

    def set_fuse(value):
        jfluid.set_flags({"optimizer_fuse": value})
        fluid.set_flags({"optimizer_fuse": value})

    yield set_fuse
    jfluid.set_flags({"optimizer_fuse": saved[0]})
    fluid.set_flags({"optimizer_fuse": saved[1]})


@pytest.mark.parametrize("fuse", ["on", "off"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_decorated_resnet50_program_matches_jax(fmt, fuse, fuse_flag):
    fuse_flag(fuse)
    with jax_unique_name.guard():
        jmain, jstart, _, _ = jresnet.build_resnet50(1000, 224,
                                                     _amp(jfluid, 1e-4), fmt)
    with fluid.unique_name.guard():
        tmain, tstart, _, _ = tresnet.build_resnet50(1000, 224,
                                                     _amp(fluid, 1e-4), fmt)
    assert tmain.to_dict() == jmain.to_dict()
    assert tstart.to_dict() == jstart.to_dict()
    ops = tmain.global_block().ops
    types = [op.type for op in ops]
    assert types.count("cast") == 158
    assert types.count("fused_adam" if fuse == "on" else "adam") == 161
    assert len(ops) == 853 + (2 if fmt == "NHWC" else 0)   # the transpose
    block = tmain.global_block()

    def dtype(name):
        return str(block._find_var_recursive(name).dtype)

    # the decorator casts the operands of the 53 convolutions and the
    # head's mul to bfloat16 (and their outputs back to float32); every
    # other forward op takes float32
    for op in ops:
        if op.type in ("conv2d", "mul"):
            assert all(dtype(n) == "bfloat16"
                       for n in op.input_arg_names), op.type
        elif op.type in ("batch_norm", "relu", "pool2d", "elementwise_add"):
            assert all(dtype(n) == "float32"
                       for n in op.input_arg_names + op.output_arg_names
                       if not n.endswith(("mean", "var"))), op.type
    assert sum(op.type in ("conv2d", "mul") for op in ops) == 54


# -- (b) the two-bottleneck net, trained ---------------------------------------------

def _build(pkg):
    resnet = jresnet if pkg is jfluid else tresnet
    unique = jax_unique_name if pkg is jfluid else fluid.unique_name
    main, startup, loss, _ = _small_net(pkg, unique, resnet, "NCHW",
                                        _amp(pkg, LR), size=SIZE)
    return main, startup, loss


def _persistables(program):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and not v.is_data)


def _step_tensors(main):
    """Every op output of the step, forward and backward, that is not a
    persistable (the bfloat16 ones are picked by their run-time dtype:
    a convolution's declared dtype is its float32 input's)."""
    return _fetchable(main)


def _jax_oracle(path):
    """The JAX side of (b) and (c), run in the subprocess: the startup's
    parameters, the first step's tensors (the bfloat16 ones as float32
    under ``bf16/``, the others under ``step/``), the losses and the
    final persistables, saved to ``path``."""
    jfluid.set_flags({"optimizer_fuse": "off"})
    main, startup, loss = _build(jfluid)
    batch = _batch(BATCH, SIZE, 5, 1)
    names = _step_tensors(main)
    scope = jfluid.Scope()
    out = {}
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        for n in _persistables(main):
            out[f"init/{n}"] = np.asarray(scope.find_var(n))
        first = exe.run(main, feed=batch, fetch_list=[loss] + names)
        losses = [float(np.asarray(first[0]).reshape(-1)[0])]
        for n, v in zip(names, first[1:]):
            v = np.asarray(v)
            if str(v.dtype) == "bfloat16":
                out[f"bf16/{n}"] = v.astype(np.float32)
            else:
                out[f"step/{n}"] = v
        for _ in range(STEPS - 1):
            (lv,) = exe.run(main, feed=batch, fetch_list=[loss])
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
        for n in _persistables(main):
            out[f"final/{n}"] = np.asarray(scope.find_var(n)).astype(
                np.float32)
    out["losses"] = np.asarray(losses)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_amp_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_amp") / "oracle.npz")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " " + ORACLE_FLAGS).strip()
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.dirname(here), env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, __file__, path], env=env,
                          cwd=here, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def port_amp_run(jax_amp_run):
    saved = fluid.get_flags("optimizer_fuse")["optimizer_fuse"]
    fluid.set_flags({"optimizer_fuse": "off"})
    try:
        main, _, loss = _build(fluid)
        init = {k[len("init/"):]: v for k, v in jax_amp_run.items()
                if k.startswith("init/")}
        scope = fluid.Scope()
        load_scope_arrays(scope, init, main, "cpu")
        exe = fluid.Executor(fluid.CPUPlace())
        batch = _batch(BATCH, SIZE, 5, 1)
        names = _step_tensors(main)
        first = exe.run(main, feed=batch, fetch_list=[loss] + names,
                        scope=scope, return_numpy=False)
        losses = [float(first[0].reshape(-1)[0])]
        bf16 = {n: v.float().numpy() for n, v in zip(names, first[1:])
                if v.dtype == torch.bfloat16}
        for _ in range(STEPS - 1):
            (lv,) = exe.run(main, feed=batch, fetch_list=[loss], scope=scope)
            losses.append(float(np.asarray(lv).reshape(-1)[0]))
        return {"losses": np.asarray(losses),
                "bf16": bf16,
                "final": {n: scope.get_numpy(n)
                          for n in _persistables(main)}}
    finally:
        fluid.set_flags({"optimizer_fuse": saved})


def test_small_net_amp_training_matches_jax(jax_amp_run, port_amp_run):
    """Losses, parameters and batch-norm statistics within the training
    tolerances; Adam's moments within 2^-7 of each entry's own value
    (the stem's, which sum the most cancelling batch-norm gradients,
    come to 4.4e-3 of theirs)."""
    jlosses = jax_amp_run["losses"]
    tlosses = port_amp_run["losses"]
    assert np.all(np.isfinite(tlosses)) and tlosses[-1] < tlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=TRAIN_RTOL,
                               atol=TRAIN_ATOL)
    jfinal = {k[len("final/"):]: v for k, v in jax_amp_run.items()
              if k.startswith("final/")}
    assert sorted(port_amp_run["final"]) == sorted(jfinal)
    moments = [n for n in jfinal if "_moment" in n]
    assert len(moments) == 2 * 38       # the net's 38 parameters
    for n, v in jfinal.items():
        t = port_amp_run["final"][n]
        if n in moments:
            np.testing.assert_allclose(t, v, rtol=BF16_RTOL, atol=BF16_TINY,
                                       err_msg=n)
        else:
            np.testing.assert_allclose(t, v, rtol=TRAIN_RTOL,
                                       atol=TRAIN_ATOL, err_msg=n)


def test_small_net_amp_bf16_tensors_match_jax(jax_amp_run, port_amp_run):
    """The first step's bfloat16 tensors: every forward one (the casts of
    images, activations and weights, the convolutions' and the head's
    outputs) equal bit for bit; every gradient within one bfloat16 step
    at its tensor's largest entry (2^-8 of max|JAX's|): the drift of
    ``batch_norm_grad``'s float32 sums over a whole step, which (c)
    traces op by op and holds per entry."""
    jbf16 = {k[len("bf16/"):]: v for k, v in jax_amp_run.items()
             if k.startswith("bf16/")}
    tbf16 = port_amp_run["bf16"]
    assert sorted(tbf16) == sorted(jbf16)
    forward = [n for n in jbf16 if "@GRAD" not in n]
    assert sum(n.startswith("conv2d") for n in forward) == 12
    assert "image.cast_bfloat16_0" in forward and "fc_0.tmp_0" in forward
    for n in forward:
        np.testing.assert_array_equal(tbf16[n], jbf16[n], err_msg=n)
    for n in set(jbf16) - set(forward):
        np.testing.assert_allclose(tbf16[n], jbf16[n], rtol=0,
                                   atol=2.0 ** -8 * np.abs(jbf16[n]).max(),
                                   err_msg=n)


def _ops_on_jax_inputs(main, batch, oracle):
    """Run the port's first step op by op, each op on JAX's values of its
    inputs where the oracle has them (the feed, the startup's values,
    every tensor of JAX's first step written once) and on the port's own
    values elsewhere (the loss's seed gradient, names that a ``sum``
    writes again). Yields (op, output name, port value, JAX value) for
    every output the oracle holds, at the output's last write."""
    block = main.global_block()
    plan = _Plan(block, list(batch), [])
    writes = Counter(n for op in plan.ops for n in op.output_arg_names)

    def jax_value(n):
        if writes[n] > 1:
            return None
        for key in (f"bf16/{n}", f"step/{n}", f"init/{n}"):
            if key in oracle:
                v = torch.from_numpy(oracle[key])
                return v.to(torch.bfloat16) if key[0] == "b" else v
        if n in batch:
            return torch.from_numpy(batch[n])
        return None

    ctx = LoweringContext("cpu", seed=0, step=1)
    env, done = {}, Counter()
    with torch.no_grad():
        for op, opdef, reads in zip(plan.ops, plan.defs, plan.reads):
            ins = {}
            for slot, names in reads:
                vals = [jax_value(n) for n in names]
                ins[slot] = [env[n] if v is None else v
                             for n, v in zip(names, vals)]
            ident = int(op.attrs.get("op_ident", 0))
            if not opdef.auto_grad and ident in plan.record:
                outs = run_recorded(ctx, opdef, op, ins, plan.record[ident])
            else:
                outs = opdef.lower(ctx, op, ins)
            for slot, names in op.outputs.items():
                for n, v in zip(names, outs.get(slot, [])):
                    env[n] = v
                    done[n] += 1
                    for key in (f"bf16/{n}", f"step/{n}"):
                        if key in oracle and done[n] == writes[n]:
                            yield op, n, v, oracle[key]


def test_small_net_amp_ops_match_jax_on_its_inputs(jax_amp_run):
    """(c): each op of the first step on JAX's inputs. bfloat16 outputs
    per entry within one bfloat16 step of their own value, the forward
    ones bit for bit; float32 outputs within 2^-20 of their largest
    entry. Today one entry of one filter gradient is a bfloat16 step
    apart and every other bfloat16 output is bit-equal."""
    saved = fluid.get_flags("optimizer_fuse")["optimizer_fuse"]
    fluid.set_flags({"optimizer_fuse": "off"})
    try:
        main, _, _ = _build(fluid)
    finally:
        fluid.set_flags({"optimizer_fuse": saved})
    batch = _batch(BATCH, SIZE, 5, 1)
    checked = {"bf16": 0, "f32": 0}
    apart = []
    for op, n, t, j in _ops_on_jax_inputs(main, batch, jax_amp_run):
        msg = f"{op.type} -> {n}"
        if t.dtype == torch.bfloat16:
            t = t.float().numpy()
            if "@GRAD" in n:
                np.testing.assert_allclose(t, j, rtol=BF16_RTOL,
                                           atol=BF16_TINY, err_msg=msg)
                if not np.array_equal(t, j):
                    apart.append(op.type)
            else:
                np.testing.assert_array_equal(t, j, err_msg=msg)
            checked["bf16"] += 1
        elif t.is_floating_point():
            np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                       atol=2.0 ** -20 * np.abs(j).max(),
                                       err_msg=msg)
            checked["f32"] += 1
    # every bfloat16 tensor of the step (forward and gradient) was held
    assert checked["bf16"] == sum(k.startswith("bf16/") for k in jax_amp_run)
    assert checked["f32"] > 100
    assert set(apart) <= {"conv2d_grad"}, apart


if __name__ == "__main__":
    _jax_oracle(sys.argv[1])
