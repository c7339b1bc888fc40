"""The rest of the public surface (ROADMAP A11g and A11j's ``HDFSClient``)
held against the JAX package on the CPU.

Tolerances: programs are compared whole (``to_dict()``) or op by op;
values computed by the same arithmetic in both packages are compared
exactly (bilinear weights, byte counts, AUC, the generators' bytes, the
memory and FLOPs tables); random initializers are held to their
distributions, as the op sweep holds random ops (mean within 3 standard
errors, standard deviation within 3 %, the support's bounds exact);
training steps at the port's training tolerance (rtol 2e-4 / atol 2e-5,
``test_torch_resnet.py``) against JAX and at 1e-6 between the port's own
fused and unfused updates.

``test_fault_error_clip_by_value_*`` shows a fault of the JAX package
that the port does not copy: JAX accepts ``ErrorClipByValue`` and
ignores it; the port clips the variable's gradient as the reference's
``append_backward`` does.
"""

import contextlib
import os
import stat
import textwrap
from importlib import import_module

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid

import paddle_tpu_torch as fluid
from paddle_tpu_torch.io import load_scope_arrays

TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5


def _pair(build):
    """``build(pkg)`` under both packages, each in a fresh name scope:
    {"jax": (main, startup, out), "port": (...)}."""
    out = {}
    for name, pkg in (("jax", jfluid), ("port", fluid)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 5
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            res = build(pkg)
        out[name] = (main, startup, res)
    return out


def _jax_startup(main, startup):
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in main.list_vars()
            if v.persistable and not v.is_data
            and scope.find_var(v.name) is not None}


# -- initializers ----------------------------------------------------------------


def _init_param(pkg, init, shape, name="w"):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        pkg.layers.create_parameter(shape, "float32", name=name,
                                    default_initializer=init)
    return main, startup


def _draw(pkg, init, shape):
    main, startup = _init_param(pkg, init, shape)
    if pkg is jfluid:
        return _jax_startup(main, startup)["w"]
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return scope.get_numpy("w")


def test_bilinear_initializer_is_exact():
    for shape in ((4, 4, 4, 4), (3, 1, 5, 6)):
        want = _draw(jfluid, jfluid.initializer.Bilinear(), shape)
        got = _draw(fluid, fluid.initializer.BilinearInitializer(), shape)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="4-D"):
        _init_param(fluid, fluid.Bilinear(), (4, 4))


def _held_to(x, mean, std, lo=None, hi=None):
    x = x.astype(np.float64).ravel()
    assert abs(x.mean() - mean) <= 3 * std / np.sqrt(x.size), (x.mean(), mean)
    assert abs(x.std() - std) <= 0.03 * std, (x.std(), std)
    if lo is not None:
        assert x.min() >= lo and x.max() <= hi, (x.min(), x.max(), lo, hi)


@pytest.mark.parametrize("which", ["msra_uniform", "msra_normal",
                                   "truncated_normal"])
def test_random_initializers_by_their_statistics(which):
    shape = (64, 32, 3, 3)
    fan_in = 32 * 9
    # the standard deviation of N(0, 1) cut at +-2
    trunc = 0.8796256610342398
    cases = {
        "msra_uniform": (lambda pkg: pkg.initializer.MSRA(), 0.0,
                         np.sqrt(2.0 / fan_in), -np.sqrt(6.0 / fan_in),
                         np.sqrt(6.0 / fan_in)),
        "msra_normal": (lambda pkg: pkg.initializer.MSRAInitializer(
            uniform=False), 0.0, np.sqrt(2.0 / fan_in), None, None),
        "truncated_normal": (lambda pkg: pkg.initializer.TruncatedNormal(
            loc=0.5, scale=2.0), 0.5, 2.0 * trunc, 0.5 - 4.0, 0.5 + 4.0),
    }
    make, mean, std, lo, hi = cases[which]
    jm, _ = _init_param(jfluid, make(jfluid), shape)
    tm, _ = _init_param(fluid, make(fluid), shape)
    assert tm.to_dict() == jm.to_dict()
    for pkg in (jfluid, fluid):
        _held_to(_draw(pkg, make(pkg), shape), mean, std, lo, hi)


def test_init_on_cpu_flips_the_flag_and_moves_nothing():
    init = fluid.initializer
    assert init.force_init_on_cpu() is False
    with init.init_on_cpu():
        assert init.force_init_on_cpu() is True
        main, startup = _init_param(fluid, fluid.Constant(2.0), (3,))
    assert init.force_init_on_cpu() is False
    jm, _ = _init_param(jfluid, jfluid.Constant(2.0), (3,))
    assert main.to_dict() == jm.to_dict()
    for n in ("Constant", "Uniform", "Normal", "TruncatedNormal", "Xavier",
              "MSRA", "Bilinear", "NumpyArrayInitializer",
              "WeightNormParamAttr"):
        assert getattr(fluid, n).__name__ == getattr(jfluid, n).__name__


# -- framework and places --------------------------------------------------------


def test_astype_and_name_scope_build_jax_programs():
    def build(pkg):
        x = pkg.layers.data("x", [3])
        with pkg.name_scope("block1"):
            y = pkg.layers.fc(x, 2)
        z = y.astype("float64")
        p = pkg.default_main_program().global_block().all_parameters()[0]
        return [z, p.astype("int32")]

    pair = _pair(build)
    tm, ts, (z, pi) = pair["port"]
    assert tm.to_dict() == pair["jax"][0].to_dict()
    assert isinstance(p := tm.global_block().all_parameters()[0],
                      fluid.Parameter) and isinstance(p, fluid.Variable)
    scopes = {op.attrs.get("name_scope") for op in tm.global_block().ops
              if op.type in ("mul", "elementwise_add")}
    assert scopes == {"block1"}
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(ts, scope=scope)
    zv, piv = exe.run(tm, feed={"x": np.ones((2, 3), "float32")},
                      fetch_list=[z, pi], scope=scope)
    assert zv.dtype == np.float64 and piv.dtype == np.int32
    for cls in ("Block", "Operator", "Parameter", "Place"):
        assert getattr(fluid, cls).__name__ == cls


def test_place_helpers():
    assert fluid.cpu_places(3) == [fluid.CPUPlace()] * 3
    assert fluid.cpu_places() == [fluid.CPUPlace()]
    assert fluid.cuda_pinned_places(2) == [fluid.CPUPlace()] * 2
    assert fluid.cuda_places([0, 1]) == [fluid.CUDAPlace(0),
                                         fluid.CUDAPlace(1)]
    assert fluid.cuda_places() == [fluid.CUDAPlace(i) for i in
                                   range(torch.cuda.device_count())]
    assert fluid.is_compiled_with_cuda() == torch.cuda.is_available()
    assert fluid.is_compiled_with_tpu() is False
    assert isinstance(fluid.CUDAPlace(0), fluid.Place)
    # device_guard is accepted and changes nothing, as JAX's
    pair = {}
    for guard in (True, False):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", [3])
            with (fluid.device_guard("gpu") if guard
                  else contextlib.nullcontext()):
                fluid.layers.fc(x, 2)
        pair[guard] = main.to_dict()
    assert pair[True] == pair[False]


def test_require_version_and_version_module():
    from paddle_tpu import version as jv

    from paddle_tpu_torch import version as tv

    fluid.require_version("0.0.1")
    fluid.require_version("0.1")            # pads to 0.1.0: any 0.1.x
    fluid.require_version("0.1.0", "0.1.9")
    for bad in (("99.0.0",), ("0.0.1", "0.0.9")):
        with pytest.raises(Exception, match="paddle_tpu_torch version"):
            fluid.require_version(*bad)
    for k in ("full_version", "major", "minor", "patch", "rc", "istaged",
              "commit"):
        assert getattr(tv, k) == getattr(jv, k), k
    assert fluid.__version__ == jfluid.__version__
    assert fluid.__git_commit__ == jfluid.__git_commit__
    assert tv.cuda() == ("ON" if torch.version.cuda else "OFF")


def test_load_op_library_registers_a_python_op(tmp_path):
    src = tmp_path / "my_ops.py"
    src.write_text(textwrap.dedent('''
        from paddle_tpu_torch.core.registry import register_op


        @register_op("surface_test_twice", inputs=("X",), outputs=("Out",))
        def _twice(ctx, op, ins):
            return {"Out": [2.0 * ins["X"][0]]}
    '''))
    assert fluid.load_op_library(str(src)) is None
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [3])
        out = main.global_block().create_var(name="out", dtype="float32")
        main.global_block().append_op(type="surface_test_twice",
                                      inputs={"X": [x]},
                                      outputs={"Out": [out]})
    xv = np.arange(6, dtype="float32").reshape(2, 3)
    (got,) = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"x": xv}, fetch_list=[out], scope=fluid.Scope())
    np.testing.assert_array_equal(got, 2 * xv)
    import ctypes.util

    # any other path is a host library, loaded through ctypes
    lib = fluid.load_op_library(ctypes.util.find_library("m"))
    assert lib.cos is not None


def _saved_model(pkg):
    x = pkg.layers.data("x", [4])
    y = pkg.layers.data("y", [1])
    loss = pkg.layers.mean(pkg.layers.square_error_cost(
        pkg.layers.fc(x, 1, param_attr=pkg.ParamAttr(name="sw")), y))
    pkg.optimizer.Adam(1e-2).minimize(loss)
    return loss


def test_save_and_load_aliases_round_trip(tmp_path):
    pair = _pair(_saved_model)
    main, startup, loss = pair["port"]
    exe = fluid.Executor(fluid.CPUPlace())
    feed = {"x": np.ones((4, 4), "float32"), "y": np.zeros((4, 1), "float32")}
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])
        want = {v.name: scope.get_numpy(v.name) for v in main.list_vars()
                if v.persistable and not v.is_data}
        fluid.save(main, str(tmp_path / "m" / "model"))
        fluid.save_params(exe, str(tmp_path / "p"), main)
        fluid.save_persistables(exe, str(tmp_path / "s"), main)
    for load, arg in ((lambda: fluid.load(main, str(tmp_path / "m" / "model"),
                                          exe), "all"),
                      (lambda: fluid.load_params(exe, str(tmp_path / "p"),
                                                 main), "params"),
                      (lambda: fluid.load_persistables(
                          exe, str(tmp_path / "s"), main), "all")):
        fresh = fluid.Scope()
        with fluid.scope_guard(fresh):
            load()
        names = ({p.name for p in main.all_parameters()} if arg == "params"
                 else set(want))
        assert set(fresh.local_var_names()) == names
        for n in names:
            np.testing.assert_array_equal(fresh.get_numpy(n), want[n])


def test_debugger_prints_jax_text(tmp_path):
    pair = _pair(_saved_model)
    (jm, _, _), (tm, _, _) = pair["jax"], pair["port"]
    from paddle_tpu import debugger as jdbg

    from paddle_tpu_torch import debugger as tdbg

    assert tdbg.pprint_program(tm) == jdbg.pprint_program(jm)
    assert (tdbg.draw_block_graphviz(tm.global_block(), highlights=["sw"])
            == jdbg.draw_block_graphviz(jm.global_block(),
                                        highlights=["sw"]))
    path = tmp_path / "g.dot"
    tdbg.draw_block_graphviz(tm.global_block(), path=str(path))
    assert path.read_text().startswith("digraph G {")


def test_install_check_refuses_without_a_card():
    """``run_check`` runs on the card and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: run_check would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fluid.install_check.run_check()


# -- contrib: memory, FLOPs, op frequencies ----------------------------------------


def _stat_model(pkg):
    img = pkg.layers.data("img", [3, 16, 16])
    h = pkg.layers.conv2d(img, 8, 3, padding=1)
    h = pkg.layers.pool2d(h, 2, "max", pool_stride=2)
    h = pkg.layers.conv2d(h, 4, 3, padding=1, groups=4)
    h = pkg.layers.fc(h, 10)
    return pkg.layers.mean(h)


def test_memory_usage_and_op_frequencies_equal_jax(capsys):
    pair = _pair(_stat_model)
    (jm, _, _), (tm, _, _) = pair["jax"], pair["port"]
    from paddle_tpu import contrib as jc

    from paddle_tpu_torch import contrib as tc

    for bs in (1, 32):
        assert tc.memory_usage(tm, bs) == jc.memory_usage(jm, bs)
    with pytest.raises(ValueError, match="positive"):
        tc.memory_usage(tm, 0)
    assert tc.op_freq_statistic(tm) == jc.op_freq_statistic(jm)


def test_summary_counts_jax_conv_rows_and_the_fc_weight(capsys):
    """Convolution and pooling rows equal JAX's. A ``mul`` row counts
    its weight: JAX's reads the shape off the input's name (a string),
    so its row says 1 parameter and 2 FLOPs (shown beside)."""
    pair = _pair(_stat_model)
    (jm, _, _), (tm, _, _) = pair["jax"], pair["port"]
    from paddle_tpu import contrib as jc

    from paddle_tpu_torch import contrib as tc

    jp, jfl = jc.summary(jm)
    tp, tfl = tc.summary(tm)
    conv1, conv2 = 8 * 3 * 3 * 3, 4 * 2 * 3 * 3
    conv = conv1 + conv2
    conv_flops = 2 * conv1 * 16 * 16 + 2 * conv2 * 8 * 8
    fc = 4 * 8 * 8 * 10
    assert (jp, jfl) == (conv + 1, conv_flops + 2)
    assert (tp, tfl) == (conv + fc, conv_flops + 2 * fc)
    text = capsys.readouterr().out
    assert "TOTAL" in text and f"{tp:14d}" in text


# -- kernels helpers ---------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "int8_block", "fp8"])
def test_kernel_weight_helpers_equal_jax(mode):
    import jax.numpy as jnp

    from paddle_tpu import kernels as jk

    from paddle_tpu_torch import kernels as tk

    w = np.random.RandomState(3).randn(300, 24).astype("float32")
    tq, ts = tk.quantize_weight(torch.from_numpy(w), mode, 128)
    jw = jk.dequantize_weight(
        jnp.asarray(tq.float().numpy()).astype(
            jnp.float8_e4m3fn if mode == "fp8" else jnp.int8),
        jnp.asarray(ts.numpy()), mode, 128)
    tw = tk.dequantize_weight(tq, ts, mode, 128)
    assert str(tw.dtype).split(".")[-1] == str(jw.dtype)
    np.testing.assert_array_equal(tw.float().numpy(),
                                  np.asarray(jw.astype(jnp.float32)))
    for shape in ((300, 24), (2048, 6144)):
        for block in (128, 256):
            assert (tk.quantized_weight_bytes(shape, mode, block)
                    == jk.quantized_weight_bytes(shape, mode, block))


def test_lora_helpers_and_k12_rank_rule():
    from paddle_tpu import kernels as jk

    from paddle_tpu_torch import kernels as tk
    from paddle_tpu_torch.kernels import lora as tlora

    for args in ((2048, 6144, 8, 5), (8192, 2048, 16, 9)):
        assert tk.lora_pool_shapes(*args) == jk.lora_pool_shapes(*args)
        assert tk.lora_slot_bytes(*args[:3]) == jk.lora_slot_bytes(*args[:3])
    # K12 takes any rank from 1 to MAX_RANK_SUM (Mosaic wanted multiples
    # of 8, so JAX's answers differ there)
    for r in (None, 1, 4, 8, 12, 16, tlora.MAX_RANK_SUM):
        assert tk.lora_rank_geometry_issue(r) is None, r
    assert jk.lora_rank_geometry_issue(12) is not None
    # the message is the one K12's own guard raises
    for r in (0, tlora.MAX_RANK_SUM + 1):
        msg = tk.lora_rank_geometry_issue(r)
        assert "K12" in msg and str(r) in msg
        x, out = torch.zeros(2, 8), torch.zeros(2, 6)
        a, b = torch.zeros(3, 8, r), torch.zeros(3, r, 6)
        with pytest.raises(ValueError) as e:
            tlora._check_pools(x, out, [a], [b], [torch.zeros(3)], 1)
        assert str(e.value) == msg


def test_optimizer_fuse_enabled_reads_the_flag():
    from paddle_tpu_torch import kernels as tk

    saved = fluid.get_flags("optimizer_fuse")["optimizer_fuse"]
    try:
        for v, want in (("on", True), ("off", False),
                        ("auto", torch.cuda.is_available())):
            fluid.set_flags({"optimizer_fuse": v})
            assert tk.optimizer_fuse_enabled() is want
    finally:
        fluid.set_flags({"optimizer_fuse": saved})


# -- generation and quantize ---------------------------------------------------------


def test_paged_kv_cache_methods_follow_jax_on_one_trace():
    from paddle_tpu.generation import PagedKVCache as JCache

    from paddle_tpu_torch.generation import PagedKVCache as TCache

    geo = dict(num_pages=12, page_size=4, max_seqs=4, max_pages_per_seq=6)
    jc, tc = JCache(2, 2, 8, **geo), TCache(2, 2, 8, device="cpu", **geo)

    def state(c):
        return (c.free_pages(), c.active_slots(),
                [c.can_allocate(n) for n in (0, 4, 20, 40, 44, 45)])

    trace = [("allocate_slot", 9), ("allocate_slot", 3),
             ("ensure_capacity", 0, 17), ("allocate_slot", 12),
             ("release", 1), ("advance", 0, 2), ("allocate_slot", 1),
             ("evict", 2), ("release", 0)]
    assert state(tc) == state(jc)
    for step in trace:
        rj = getattr(jc, step[0])(*step[1:])
        rt = getattr(tc, step[0])(*step[1:])
        assert rt == rj, step
        assert state(tc) == state(jc), step
    # set_buffers swaps in a step's pools (scale planes for int8)
    kp = [torch.ones(2, 12, 4, 8) for _ in range(2)]
    vp = [torch.full((2, 12, 4, 8), 2.0) for _ in range(2)]
    tc.set_buffers(kp, vp)
    assert tc.k_pages[1] is kp[1] and tc.v_pages[0] is vp[0]
    with pytest.raises(ValueError, match="layer count"):
        tc.set_buffers(kp[:1], vp)
    q = TCache(2, 2, 8, device="cpu", dtype="int8", **geo)
    with pytest.raises(ValueError, match="scale planes"):
        q.set_buffers(kp, vp)
    q.set_buffers(kp, vp, kp, vp)
    assert q.k_scales[0] is kp[0]


def _tagged_fc(pkg):
    x = pkg.layers.data("x", [16])
    h = pkg.layers.fc(x, 32, param_attr=pkg.ParamAttr(
        name="q_w1", logical_axes=("embed", "mlp")))
    w2 = pkg.ParamAttr(name="q_w2", logical_axes=("mlp", "embed"))
    out = pkg.layers.fc(h, 8, param_attr=w2)
    blk = pkg.default_main_program().global_block()
    blk.var("q_w2").sharding = ("tp", None, None)      # a 3-tag drop
    return out


def test_quantize_report_tag_record_rows_equal_jax():
    from paddle_tpu.quantize import rewrite_for_inference as jrewrite

    from paddle_tpu_torch.quantize import QuantizeReport
    from paddle_tpu_torch.quantize import rewrite_for_inference as trewrite

    pair = _pair(_tagged_fc)
    (jm, js, _), (tm, _, _) = pair["jax"], pair["port"]
    init = _jax_startup(jm, js)
    jscope = jfluid.Scope()
    for k, v in init.items():
        jscope.set_var(k, v)
    tscope = fluid.Scope()
    load_scope_arrays(tscope, init, tm, "cpu")
    jrep = jrewrite(jm, jscope, "int8")
    trep = trewrite(tm, tscope, "int8")
    assert trep.to_dict()["partition_tags"] == jrep.to_dict()["partition_tags"]
    assert tm._quant_tag_record == jm._quant_tag_record
    assert any(r["dropped_reason"] for r in trep.tag_rows)
    row = QuantizeReport("int8", 256).tag_record(
        "w", "w.q", "w.qscale", "sharding", ("tp", None), ("tp", None))
    assert row == jrep.tag_record("w", "w.q", "w.qscale", "sharding",
                                  ("tp", None), ("tp", None))


# -- clip: ErrorClipByValue (a JAX fault the port does not copy) ---------------------


def _error_clip_net(pkg, clip):
    x = pkg.layers.data("x", [4])
    h = pkg.layers.fc(x, 6, param_attr=pkg.ParamAttr(name="w1"),
                      bias_attr=False)
    if clip:
        h.error_clip = pkg.clip.ErrorClipByValue(max=0.05, min=-0.02)
    out = pkg.layers.fc(h, 1, param_attr=pkg.ParamAttr(name="w2"),
                        bias_attr=False)
    loss = pkg.layers.reduce_sum(pkg.layers.square(out))
    pkg.append_backward(loss)
    return h, loss


def test_fault_error_clip_by_value_is_ignored_by_jax_and_applied_by_the_port():
    feed = {"x": np.random.RandomState(6).randn(5, 4).astype("float32")}
    grads = {}
    for clip in (False, True):
        pair = _pair(lambda pkg: _error_clip_net(pkg, clip))
        (jm, js, (jh, _)), (tm, _, (th, _)) = pair["jax"], pair["port"]
        init = _jax_startup(jm, js)
        jscope = jfluid.Scope()
        with jfluid.scope_guard(jscope):
            jexe = jfluid.Executor(jfluid.CPUPlace())
            jexe.run(js)
            jg = jexe.run(jm, feed=feed, fetch_list=[jh.name + "@GRAD",
                                                     "w1@GRAD"])
        tscope = fluid.Scope()
        load_scope_arrays(tscope, init, tm, "cpu")
        tg = fluid.Executor(fluid.CPUPlace()).run(
            tm, feed=feed, fetch_list=[th.name + "@GRAD", "w1@GRAD"],
            scope=tscope)
        grads[clip] = ([np.asarray(g) for g in jg], [np.asarray(g) for g in tg])
        types = [op.type for op in tm.global_block().ops]
        assert types.count("clip") == (1 if clip else 0)
    (j0, t0), (j1, t1) = grads[False], grads[True]
    # JAX: the error clip changes nothing (its fault)
    np.testing.assert_array_equal(j1[0], j0[0])
    # the port: the var's gradient is clipped, and the clipped error is
    # what reaches w1
    assert (t0[0] > 0.05).any() and (t0[0] < -0.02).any()
    np.testing.assert_allclose(t1[0], np.clip(t0[0], -0.02, 0.05),
                               rtol=1e-6)
    np.testing.assert_allclose(t1[1], feed["x"].T @ t1[0], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(t0[0], j0[0], rtol=1e-5, atol=1e-7)


# -- contrib.extend_optimizer --------------------------------------------------------


def _weight_decay_run(pkg, mode, feed, init=None):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [4])
        y = pkg.layers.data("y", [1])
        w_pred = pkg.layers.fc(x, 1, param_attr=pkg.ParamAttr(name="w_dec"),
                               bias_attr=False)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(w_pred, y))
        if mode == "adam":
            pkg.optimizer.Adam(1e-2).minimize(loss)
        else:
            contrib = import_module(f"{pkg.__name__}.contrib")
            AdamW = contrib.extend_with_decoupled_weight_decay(
                pkg.optimizer.Adam)
            AdamW(weight_decay=0.1, learning_rate=1e-2).minimize(loss)
    types = [op.type for op in main.global_block().ops]
    if pkg is jfluid:
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe = jfluid.Executor(jfluid.CPUPlace())
            exe.run(startup)
            w0 = np.asarray(scope.find_var("w_dec")).copy()
            exe.run(main, feed=feed, fetch_list=[loss])
            return types, w0, np.asarray(scope.find_var("w_dec")).copy()
    scope = fluid.Scope()
    load_scope_arrays(scope, init, main, "cpu")
    w0 = scope.get_numpy("w_dec").copy()
    fluid.Executor(fluid.CPUPlace()).run(main, feed=feed, fetch_list=[loss],
                                         scope=scope)
    return types, w0, scope.get_numpy("w_dec").copy()


@pytest.mark.parametrize("fuse", ["off", "on"])
def test_extend_optimizer_with_weight_decay(fuse):
    """Twin of ``test_contrib_layers.py::test_extend_optimizer_with_
    weight_decay``: AdamW equals a plain Adam step plus the decoupled
    ``coeff * p`` shrink, applied once; with ``optimizer_fuse`` on the
    update is K10's ``fused_adam`` op for both."""
    rng = np.random.RandomState(8)
    feed = {"x": rng.randn(8, 4).astype("float32"),
            "y": rng.randn(8, 1).astype("float32")}
    jtypes, w0, jw = _weight_decay_run(jfluid, "adamw", feed)
    _, _, ja = _weight_decay_run(jfluid, "adam", feed)
    init = None
    saved = fluid.get_flags("optimizer_fuse")["optimizer_fuse"]
    fluid.set_flags({"optimizer_fuse": fuse})
    try:
        out = {}
        for mode in ("adam", "adamw"):
            # the JAX startup's parameters and optimizer state
            jmain = jfluid.Program()
            jstart = jfluid.Program()
            jmain.random_seed = jstart.random_seed = 3
            with jfluid.program_guard(jmain, jstart), \
                    jfluid.unique_name.guard():
                x = jfluid.layers.data("x", [4])
                y = jfluid.layers.data("y", [1])
                loss = jfluid.layers.mean(jfluid.layers.square_error_cost(
                    jfluid.layers.fc(x, 1, param_attr=jfluid.ParamAttr(
                        name="w_dec"), bias_attr=False), y))
                jfluid.optimizer.Adam(1e-2).minimize(loss)
            init = _jax_startup(jmain, jstart)
            out[mode] = _weight_decay_run(fluid, mode, feed, init)
    finally:
        fluid.set_flags({"optimizer_fuse": saved})
    (ta, _, wa), (tw, tw0, ww) = out["adam"], out["adamw"]
    update = "fused_adam" if fuse == "on" else "adam"
    assert ta.count(update) == tw.count(update) == 1
    assert tw.count("elementwise_sub") == ta.count("elementwise_sub") + 1
    assert tw.count("scale") == ta.count("scale") + 1
    np.testing.assert_array_equal(tw0, w0)
    np.testing.assert_allclose(ww, wa - 0.1 * tw0, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ww, jw, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    np.testing.assert_allclose(wa, ja, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    assert "elementwise_sub" in jtypes


def test_extend_optimizer_refuses_a_non_optimizer():
    from paddle_tpu_torch.contrib import extend_with_decoupled_weight_decay

    with pytest.raises(TypeError, match="derived class of Optimizer"):
        extend_with_decoupled_weight_decay(object)
    AdamW = extend_with_decoupled_weight_decay(fluid.optimizer.Adam)
    assert AdamW.__name__ == (fluid.optimizer.Adam.__name__
                              + "WithDecoupledWeightDecay")
    with pytest.raises(TypeError, match="coeff"):
        AdamW(weight_decay="0.1", learning_rate=1e-2)


# -- incubate.data_generator ----------------------------------------------------------


def _generator(pkg):
    base = import_module(f"{pkg.__name__}.incubate.data_generator")

    class Gen(base.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def reader():
                for i in range(6):
                    yield [("show", [i % 2]),
                           ("feat", [0.5 * i, 1.0 * i, 1.5 * i])]
            return reader

    class StrGen(base.MultiSlotStringDataGenerator):
        def generate_sample(self, line):
            def reader():
                for i in range(5):
                    yield [("words", [f"w{i}", f"w{i + 1}"]), ("id", [str(i)])]
            return reader
    return Gen, StrGen


def test_data_generator_roundtrips_into_dataset(tmp_path):
    """Twin of ``test_contrib_layers.py::test_data_generator_roundtrips_
    into_dataset``: the port's generators write JAX's bytes, and the
    port's dataset reads them."""
    from paddle_tpu_torch.dataset import DatasetFactory

    files = {}
    for name, pkg in (("jax", jfluid), ("port", fluid)):
        Gen, StrGen = _generator(pkg)
        d = tmp_path / name
        d.mkdir()
        files[name] = Gen().write_to_files(lines_per_file=3,
                                           prefix=str(d / "ds"))
        files[name + "_str"] = StrGen().write_to_files(
            lines_per_file=10, prefix=str(d / "str"))
    for key in ("", "_str"):
        pj, pt = files["jax" + key], files["port" + key]
        assert [os.path.basename(p) for p in pt] == \
            [os.path.basename(p) for p in pj]
        for a, b in zip(pt, pj):
            assert open(a, "rb").read() == open(b, "rb").read()
    assert len(files["port"]) == 2
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        show = fluid.layers.data("show", [1], dtype="int64")
        feat = fluid.layers.data("feat", [3])
    dataset = DatasetFactory().create_dataset("InMemoryDataset")
    dataset.set_batch_size(2)
    dataset.set_use_var([show, feat])
    dataset.set_filelist(files["port"])
    dataset.load_into_memory()
    assert dataset.get_memory_data_size() == 6
    batches = list(dataset._iter_batches())
    feats = np.concatenate([np.asarray(b["feat"]).reshape(-1, 3)
                            for b in batches])
    shows = np.concatenate([np.asarray(b["show"]).reshape(-1)
                            for b in batches])
    np.testing.assert_array_equal(
        feats, [[0.5 * i, 1.0 * i, 1.5 * i] for i in range(6)])
    np.testing.assert_array_equal(shows, [i % 2 for i in range(6)])


def test_data_generator_validates_inconsistent_slots(capsys):
    from paddle_tpu_torch.incubate.data_generator import (
        DataGenerator, MultiSlotDataGenerator)

    g = MultiSlotDataGenerator()
    g._gen_str([("a", [1]), ("b", [2.0])])
    with pytest.raises(ValueError, match="not match"):
        g._gen_str([("a", [1]), ("c", [2.0])])
    with pytest.raises(ValueError, match="inconsistent"):
        g._gen_str([("a", [1])])
    with pytest.raises(ValueError, match="at least one"):
        MultiSlotDataGenerator()._gen_str([("a", [])])
    with pytest.raises(NotImplementedError):
        DataGenerator()._gen_str([("a", [1])])
    # run_from_memory writes the batches to stdout, as JAX's
    Gen, _ = _generator(fluid)
    JGen, _ = _generator(jfluid)
    for gen in (Gen(), JGen()):
        gen.set_batch(4)
        gen.run_from_memory()
    out = capsys.readouterr().out.splitlines()
    assert out[:6] == out[6:] and out[1] == "1 1 3 0.5 1.0 1.5"


# -- incubate.fleet.utils.FleetUtil --------------------------------------------------


def test_fleet_util_auc_and_logging(capsys):
    """Twin of ``test_convenience_surface.py::test_fleet_util_auc_and_
    logging`` (the world of 2 is in ``test_torch_world_surface.py``)."""
    from paddle_tpu.incubate.fleet.utils import FleetUtil as JFleetUtil

    from paddle_tpu_torch.incubate.fleet.utils import FleetUtil

    fu = FleetUtil()
    fu.rank0_print("hello-fleet")
    assert "hello-fleet" in capsys.readouterr().out
    pos, neg = np.zeros(128), np.zeros(128)
    pos[100], neg[10] = 50, 50
    scope = fluid.Scope()
    scope.set_var("sp", pos.astype("int64"))
    scope.set_var("sn", torch.from_numpy(neg.astype("int64")))
    auc = fu.get_global_auc(scope, "sp", "sn")
    jscope = jfluid.Scope()
    jscope.set_var("sp", pos.astype("int64"))
    jscope.set_var("sn", neg.astype("int64"))
    assert auc == JFleetUtil().get_global_auc(jscope, "sp", "sn") > 0.99
    fu.set_zero("sp", scope)
    fu.set_zero("sn", scope)
    assert np.asarray(scope.find_var("sp")).sum() == 0
    assert isinstance(scope.find_var("sn"), torch.Tensor)
    assert fu.get_global_auc(scope, "sp", "sn") == 0.5
    with pytest.raises(KeyError):
        fu.set_zero("nope", scope)
    for args in (("", "0", 30, 2, False), ("", "3", 60, 1, True)):
        assert (fu.get_online_pass_interval(*args)
                == JFleetUtil().get_online_pass_interval(*args))
    iv = fu.get_online_pass_interval("", "0", 30, 2, False)
    assert len(iv) == 24 and len(iv[0]) == 2


def test_fleet_util_saves_and_loads_the_model(tmp_path):
    from paddle_tpu_torch.incubate.fleet.utils import FleetUtil

    main, startup, loss = _pair(_saved_model)["port"]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope), fluid.program_guard(main, startup):
        exe.run(startup)
        FleetUtil().save_model(str(tmp_path), 20240101, 3)
        want = scope.get_numpy("sw")
    fresh = fluid.Scope()
    with fluid.scope_guard(fresh), fluid.program_guard(main, startup):
        FleetUtil().load_fleet_model(str(tmp_path / "20240101" / "3"),
                                     executor=exe)
    np.testing.assert_array_equal(fresh.get_numpy("sw"), want)


# -- fs.HDFSClient ---------------------------------------------------------------------


def test_hdfs_client_without_hadoop(tmp_path):
    """Twin of ``test_misc.py::test_hdfs_client_without_hadoop``."""
    from paddle_tpu_torch.fs import ExecuteError, HDFSClient

    cli = HDFSClient(hadoop_home=str(tmp_path))  # no hadoop binary here
    with pytest.raises(ExecuteError, match="hadoop binary not found"):
        cli.is_exist("/foo")
    assert cli._cmd("-ls", "/x")[-2:] == ["-ls", "/x"]
    # 7 files over 3 trainers -> blocks [3, 2, 2]; trainer 1 gets d, e
    assert HDFSClient.split_files(list("abcdefg"), 1, 3) == ["d", "e"]
    assert cli.need_upload_download() is True


FAKE_HADOOP = """#!/bin/sh
# a stand-in for `hadoop fs`: logs its arguments, answers -test by a
# marker file, -cat with a fixed text, -ls with one dir and one file
echo "$@" >> "$(dirname "$0")/calls.log"
case "$3" in
  -test) [ -e "$(dirname "$0")/exists" ] ;;
  -cat) printf 'hello from %s\\n' "$4" ;;
  -ls) echo "drwxr-xr-x - u g 0 2024-01-01 00:00 /d/sub"
       echo "-rw-r--r-- 3 u g 9 2024-01-01 00:00 /d/f.txt" ;;
  *) : ;;
esac
"""


def test_hdfs_client_drives_the_hadoop_command_line(tmp_path):
    """A fake ``bin/hadoop`` in ``tmp_path``: the port's client runs the
    same command lines as JAX's and reads the same answers."""
    from paddle_tpu.fs import HDFSClient as JHDFSClient

    from paddle_tpu_torch.fs import ExecuteError, HDFSClient

    home = tmp_path / "hadoop"
    (home / "bin").mkdir(parents=True)
    fake = home / "bin" / "hadoop"
    fake.write_text(FAKE_HADOOP)
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    log = home / "bin" / "calls.log"
    local = tmp_path / "local.txt"
    local.write_text("x")

    def drive(cls):
        cli = cls(hadoop_home=str(home), configs={"fs.default.name": "h:1"},
                  sleep_inter=1)
        out = [cli.is_exist("/a"), cli.is_dir("/a")]
        (home / "bin" / "exists").write_text("")
        out += [cli.is_exist("/a"), cli.is_file("/a"), cli.cat("/d/f.txt"),
                cli.ls_dir("/d")]
        (home / "bin" / "exists").unlink()
        cli.upload("/d/up.txt", str(local), overwrite=True)
        cli.download("/d/f.txt", str(tmp_path / "down.txt"))
        cli.mkdirs("/d/new")
        cli.delete("/d/old")
        cli.rename("/d/a", "/d/b", overwrite=True)
        calls = log.read_text().splitlines()
        log.unlink()
        return out, calls

    got, want = drive(HDFSClient), drive(JHDFSClient)
    assert got == want
    assert got[0][:4] == [False, False, True, False]
    assert got[1][0] == "fs -Dfs.default.name=h:1 -test -e /a"
    with pytest.raises(NotImplementedError, match="atomic"):
        HDFSClient(hadoop_home=str(home)).atomic_rename("/a", "/b")
    fake.write_text("#!/bin/sh\nexit 3\n")
    with pytest.raises(ExecuteError, match="failed"):
        HDFSClient(hadoop_home=str(home), sleep_inter=1)._run(["-ls", "/"],
                                                              retry_times=2)
