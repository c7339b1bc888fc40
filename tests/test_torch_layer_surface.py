"""The rest of the layer surface: every public callable of
``paddle_tpu.layers`` is one of ``paddle_tpu_torch.layers``, and each of
the 80 this slice adds builds the same Program as JAX's (ops, attrs and
vars, op idents and call stacks aside), among them the SSD layers
``multi_box_head``, ``ssd_loss`` and ``detection_output`` over
``models.ssd``. The control-flow sugar (``IfElse``, ``case``,
``switch_case``, ``while_loop``) also runs, with its gradients, against
JAX's.

JAX runs without x64: where its shape inference meets an int64 output it
records int32 (``jax.eval_shape``), where the port records the op's
int64. The var comparison reads the two as one (``_norm``).

Ratchets: the port registers 397 lowerings, the 424 of JAX but the 27
named in ``NOT_PORTED`` (the fused ops, the parameter server's and the
kernels' Program forms); every registered lowering has a JAX parity case
in a ``test_torch_*`` CPU file that names it in quotes, or is one of the
slice's ops the sweep twins hold (``test_torch_sweep_tensor.NEW_OPS``).
"""

import glob
import os
import re

import numpy as np
import pytest

from test_torch_rnn import check_split, f32

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401 (registers ssd_loss_dense)
import paddle_tpu.ops  # noqa: F401
import paddle_tpu_torch as fluid
import paddle_tpu_torch.models  # noqa: F401
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu.core.framework import unique_name as jax_unique_name
from paddle_tpu.core.registry import _OP_REGISTRY as JAX_REGISTRY
from paddle_tpu_torch.core.registry import _OP_REGISTRY
from paddle_tpu_torch.io import load_scope_arrays


def _names(pkg):
    return jax_unique_name if pkg is jfluid else fluid.unique_name


def _build(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), _names(pkg).guard():
        build(pkg.layers, pkg)
    return main, startup


def _d(L, name, shape, dtype="float32"):
    return L.data(name, shape, append_batch_size=False, dtype=dtype)


def _norm(d):
    for b in d["blocks"]:
        for op in b["ops"]:
            op["attrs"].pop("op_ident", None)
            op["attrs"].pop("op_callstack", None)
        for v in b["vars"].values() if isinstance(b["vars"], dict) else \
                b["vars"]:
            if isinstance(v, dict) and v.get("dtype") == "int64":
                v["dtype"] = "int32"
    return d


def _x(L, shape=(2, 4, 6, 6)):
    return _d(L, "x", list(shape))


def _ids(L):
    return _d(L, "ids", [8], "int64")


def _cond(L):
    return L.less_than(L.reduce_mean(_d(L, "c", [1])),
                       L.fill_constant([1], "float32", 0.0))


def _while(L, pkg):
    i = L.fill_constant([1], "int64", 0)
    lim = L.fill_constant([1], "int64", 3)
    acc = _d(L, "a", [2, 3])
    L.while_loop(lambda i, a: L.less_than(i, lim),
                 lambda i, a: [L.increment(i, in_place=False),
                               L.scale(a, 2.0)], [i, acc])


def _ifelse(L, pkg):
    x = _d(L, "x", [4, 3])
    ie = L.IfElse(L.greater_than(L.reduce_sum(x), L.fill_constant(
        [1], "float32", 0.0)))
    with ie.true_block():
        ie.output(L.scale(ie.input(x), 2.0))
    with ie.false_block():
        ie.output(L.scale(ie.input(x), -1.0))
    ie()


def _ssd_head(L, pkg):
    img = _d(L, "img", [2, 3, 32, 32])
    f1, f2 = _d(L, "f1", [2, 8, 4, 4]), _d(L, "f2", [2, 8, 2, 2])
    L.multi_box_head([f1, f2], img, 3, [8.0, 16.0], max_sizes=[16.0, 24.0],
                     aspect_ratios=[[2.0], [2.0]])


def _ssd_loss(L, pkg):
    L.ssd_loss(_d(L, "loc", [2, 6, 4]), _d(L, "conf", [2, 6, 3]),
               _d(L, "gb", [2, 2, 4]), _d(L, "gl", [2, 2], "int64"),
               _d(L, "pb", [6, 4]), _d(L, "pv", [6, 4]))


def _det_out(L, pkg):
    L.detection_output(_d(L, "loc", [2, 6, 4]), _d(L, "conf", [2, 6, 3]),
                       _d(L, "pb", [6, 4]), _d(L, "pv", [6, 4]),
                       keep_top_k=4)


def _py_func(L, pkg):
    x = _d(L, "x", [2, 3])
    out = pkg.default_main_program().global_block().create_var(
        name="pf_out", shape=(2, 3), dtype="float32")
    L.py_func(np.tanh, x, out)


def _load(L, pkg):
    out = pkg.default_main_program().global_block().create_var(
        name="restored", shape=(3, 4), dtype="float32")
    L.load(out, "some/file")


LAYERS = {
    # layers/auto.py rows
    "add_position_encoding": lambda L, p: L.add_position_encoding(
        _d(L, "x", [2, 5, 8]), 0.5, 2.0),
    "affine_channel": lambda L, p: L.affine_channel(
        _x(L), _d(L, "s", [4]), _d(L, "b", [4])),
    "affine_grid": lambda L, p: L.affine_grid(_d(L, "t", [2, 2, 3]),
                                              [2, 1, 4, 5]),
    "bpr_loss": lambda L, p: L.bpr_loss(_d(L, "x", [4, 6]),
                                        _d(L, "l", [4, 1], "int64")),
    "brelu": lambda L, p: L.brelu(_x(L), 0.5, 3.0),
    "center_loss": lambda L, p: L.center_loss(
        _d(L, "x", [4, 8]), _d(L, "l", [4, 1], "int64"),
        _d(L, "c", [3, 8])),
    "continuous_value_model": lambda L, p: L.continuous_value_model(
        _d(L, "x", [4, 6]), _d(L, "c", [4, 2])),
    "cos_sim": lambda L, p: L.cos_sim(_d(L, "x", [4, 5]), _d(L, "y", [4, 5])),
    "crop_tensor": lambda L, p: L.crop_tensor(_x(L), shape=[2, 4, 3, 3],
                                              offsets=[0, 0, 1, 2]),
    "data_norm": lambda L, p: L.data_norm(
        _d(L, "x", [4, 3]), _d(L, "n", [3]), _d(L, "s", [3]),
        _d(L, "q", [3])),
    "diag": lambda L, p: L.diag(_d(L, "d", [5])),
    "filter_by_instag": lambda L, p: L.filter_by_instag(
        _d(L, "x", [4, 3]), _d(L, "t", [4, 2], "int64"),
        _d(L, "f", [2], "int64")),
    "fsp_matrix": lambda L, p: L.fsp_matrix(_x(L), _d(L, "y", [2, 3, 6, 6])),
    "gaussian_random_batch_size_like": lambda L, p:
        L.gaussian_random_batch_size_like(_d(L, "x", [4, 3]), [1, 7]),
    "grid_sampler": lambda L, p: L.grid_sampler(_x(L),
                                                _d(L, "g", [2, 3, 3, 2])),
    "has_inf": lambda L, p: L.has_inf(_x(L)),
    "has_nan": lambda L, p: L.has_nan(_x(L)),
    "hash": lambda L, p: L.hash(_d(L, "i", [8, 1], "int64"), 2, 1000),
    "hsigmoid": lambda L, p: L.hsigmoid(
        _d(L, "x", [4, 8]), _d(L, "l", [4, 1], "int64"), _d(L, "w", [7, 8]),
        num_classes=8),
    "is_empty": lambda L, p: L.is_empty(_x(L)),
    "isfinite": lambda L, p: L.isfinite(_x(L)),
    "label_smooth": lambda L, p: L.label_smooth(_d(L, "x", [4, 5]),
                                                epsilon=0.2),
    "lrn": lambda L, p: L.lrn(_x(L), n=3),
    "margin_rank_loss": lambda L, p: L.margin_rank_loss(
        _d(L, "l", [4, 1]), _d(L, "a", [4, 1]), _d(L, "b", [4, 1])),
    "mean_iou": lambda L, p: L.mean_iou(_d(L, "p", [8], "int32"),
                                        _d(L, "l", [8], "int32"), 3),
    "multiplex": lambda L, p: L.multiplex(
        [_d(L, "a", [4, 3]), _d(L, "b", [4, 3])], _d(L, "i", [4, 1], "int32")),
    "npair_loss": lambda L, p: L.npair_loss(
        _d(L, "a", [4, 3]), _d(L, "p", [4, 3]), _d(L, "l", [4])),
    "pad_constant_like": lambda L, p: L.pad_constant_like(
        _d(L, "x", [4, 5]), _d(L, "y", [2, 3]), 0.5),
    "pixel_shuffle": lambda L, p: L.pixel_shuffle(_x(L), 2),
    "random_crop": lambda L, p: L.random_crop(_x(L), [3, 3]),
    "rank_loss": lambda L, p: L.rank_loss(
        _d(L, "l", [4, 1]), _d(L, "a", [4, 1]), _d(L, "b", [4, 1])),
    "reverse": lambda L, p: L.reverse(_x(L), [1, 3]),
    "sampling_id": lambda L, p: L.sampling_id(_d(L, "p", [4, 5])),
    "scatter_nd_add": lambda L, p: L.scatter_nd_add(
        _d(L, "x", [4, 3]), _d(L, "i", [2, 1], "int64"), _d(L, "u", [2, 3])),
    "selu": lambda L, p: L.selu(_x(L)),
    "similarity_focus": lambda L, p: L.similarity_focus(_x(L), 1, [0, 2]),
    "size": lambda L, p: L.size(_x(L)),
    "space_to_depth": lambda L, p: L.space_to_depth(_x(L), 2),
    "teacher_student_sigmoid_loss": lambda L, p:
        L.teacher_student_sigmoid_loss(_d(L, "x", [4, 1]), _d(L, "l", [4, 1])),
    "temporal_shift": lambda L, p: L.temporal_shift(_x(L), 2),
    "unfold": lambda L, p: L.unfold(_x(L), [3, 3], paddings=[1, 1, 1, 1]),
    "uniform_random_batch_size_like": lambda L, p:
        L.uniform_random_batch_size_like(_d(L, "x", [4, 3]), [1, 7]),
    "unique": lambda L, p: L.unique(_ids(L)),
    "unique_with_counts": lambda L, p: L.unique_with_counts(_ids(L)),
    # layers/nn.py
    "instance_norm": lambda L, p: L.instance_norm(_x(L)),
    "maxout": lambda L, p: L.maxout(_x(L), 2),
    "l2_normalize": lambda L, p: L.l2_normalize(_x(L), 1),
    "shuffle_channel": lambda L, p: L.shuffle_channel(_x(L), 2),
    "pad2d": lambda L, p: L.pad2d(_x(L), [1, 2, 3, 0], mode="reflect"),
    "image_resize": lambda L, p: L.image_resize(_x(L), [9, 4]),
    "resize_bilinear": lambda L, p: L.resize_bilinear(_x(L), scale=1.5,
                                                      align_corners=False,
                                                      align_mode=0),
    "resize_nearest": lambda L, p: L.resize_nearest(_x(L), [3, 12]),
    "shard_index": lambda L, p: L.shard_index(_ids(L), 20, 3, 1),
    # layers/loss.py
    "cross_entropy": lambda L, p: L.cross_entropy(_d(L, "x", [4, 5]),
                                                  _d(L, "l", [4, 1], "int64")),
    "huber_loss": lambda L, p: L.huber_loss(_d(L, "x", [4, 1]),
                                            _d(L, "y", [4, 1]), 0.5),
    "kldiv_loss": lambda L, p: L.kldiv_loss(_d(L, "x", [4, 5]),
                                            _d(L, "t", [4, 5]), "batchmean"),
    "log_loss": lambda L, p: L.log_loss(_d(L, "x", [4, 1]),
                                        _d(L, "y", [4, 1])),
    "mse_loss": lambda L, p: L.mse_loss(_d(L, "x", [4, 3]),
                                        _d(L, "y", [4, 3])),
    "smooth_l1": lambda L, p: L.smooth_l1(_d(L, "x", [4, 3]),
                                          _d(L, "y", [4, 3]), sigma=2.0),
    # layers/extras.py
    "IfElse": _ifelse,
    "Print": lambda L, p: L.Print(_x(L), message="x is"),
    "autoincreased_step_counter": lambda L, p:
        L.autoincreased_step_counter(begin=5),
    "case": lambda L, p: L.case([(_cond(L), lambda: _d(L, "a", [2, 3]))],
                                default=lambda: _d(L, "b", [2, 3])),
    "switch_case": lambda L, p: L.switch_case(
        _d(L, "i", [1], "int64"), [lambda: _d(L, "a", [2, 3]),
                                   lambda: _d(L, "b", [2, 3])]),
    "while_loop": _while,
    "rank": lambda L, p: L.rank(_x(L)),
    "crop": lambda L, p: L.crop(_x(L), shape=[2, 4, 3, 3],
                                offsets=[0, 0, 1, 1]),
    "eye": lambda L, p: L.eye(3, 4, batch_shape=[2]),
    "ctc_greedy_decoder": lambda L, p: L.ctc_greedy_decoder(
        _d(L, "x", [2, 6, 5]), 0, _d(L, "n", [2], "int64")),
    "dice_loss": lambda L, p: L.dice_loss(_d(L, "x", [4, 5]),
                                          _d(L, "l", [4, 5], "int64")),
    "image_resize_short": lambda L, p: L.image_resize_short(
        _d(L, "x", [2, 3, 6, 9]), 4),
    "load": _load,
    "lod_append": lambda L, p: L.lod_append(_d(L, "x", [4, 3]), [0, 2, 4]),
    "scatter_nd": lambda L, p: L.scatter_nd(_d(L, "i", [2, 1], "int64"),
                                            _d(L, "u", [2, 3]), [4, 3]),
    "sampled_softmax_with_cross_entropy": lambda L, p:
        L.sampled_softmax_with_cross_entropy(_d(L, "x", [4, 10]),
                                             _d(L, "l", [4, 1], "int64"), 3),
    "multi_box_head": _ssd_head,
    "ssd_loss": _ssd_loss,
    "detection_output": _det_out,
    # metric_op, py_func_registry
    "auc": lambda L, p: L.auc(_d(L, "p", [8, 2]), _d(L, "l", [8, 1], "int64"),
                              num_thresholds=63),
    "py_func": _py_func,
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_functions_build_jax_programs(name):
    jm, js = _build(jfluid, LAYERS[name])
    tm, ts = _build(fluid, LAYERS[name])
    jd, td = _norm(jm.to_dict()), _norm(tm.to_dict())
    assert [op["type"] for op in td["blocks"][0]["ops"]] == \
        [op["type"] for op in jd["blocks"][0]["ops"]]
    assert td["blocks"] == jd["blocks"]
    assert _norm(ts.to_dict()) == _norm(js.to_dict())


# -- the control-flow sugar runs as JAX's --------------------------------------


def _run_both(build, feed, fetch):
    """``build(L, pkg)`` -> loss in both packages; the fetches and the
    gradients of the loss with respect to ``x``."""
    res = []
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), _names(pkg).guard():
            loss = build(pkg.layers, pkg)
            pkg.append_backward(loss)
        vals = pkg.Executor(pkg.CPUPlace()).run(
            main, feed=feed, fetch_list=[loss.name] + fetch,
            scope=pkg.Scope())
        res.append({n: np.asarray(v) for n, v in zip(["loss"] + fetch,
                                                     vals)})
    return res


def _sel(L, pkg, kind):
    x = L.data("x", [4, 3], append_batch_size=False, stop_gradient=False)
    c = L.data("c", [1], append_batch_size=False)
    pos = L.greater_than(c, L.fill_constant([1], "float32", 0.0))
    if kind == "ifelse":
        ie = L.IfElse(pos)
        with ie.true_block():
            ie.output(L.tanh(ie.input(x)))
        with ie.false_block():
            ie.output(L.scale(ie.input(x), -2.0))
        out = ie()
    elif kind == "case":
        out = L.case([(pos, lambda: L.tanh(x))],
                     default=lambda: L.square(x))
    else:
        idx = L.cast(L.scale(c, 0.0, bias=1.0), "int64")
        out = L.switch_case(idx, {0: lambda: L.tanh(x),
                                  1: lambda: L.scale(L.sigmoid(x), 3.0)})
    return L.reduce_sum(L.elementwise_mul(out, L.data(
        "w", [4, 3], append_batch_size=False)))


@pytest.mark.parametrize("kind", ["ifelse", "case", "switch"])
@pytest.mark.parametrize("c", [1.0, -1.0])
def test_select_sugar_and_its_gradient_match_jax(kind, c):
    feed = {"x": f32(4, 3, seed=1), "c": np.array([c], np.float32),
            "w": f32(4, 3, seed=2)}
    j, t = _run_both(lambda L, p: _sel(L, p, kind), feed, ["x@GRAD"])
    check_split(j, t)


def test_while_loop_matches_jax():
    def build(L, pkg):
        i = L.fill_constant([1], "int64", 0)
        lim = L.fill_constant([1], "int64", 4)
        a = L.data("a", [2, 3], append_batch_size=False)
        _, out = L.while_loop(lambda i, a: L.less_than(i, lim),
                              lambda i, a: [L.increment(i, in_place=False),
                                            L.scale(a, 1.5, bias=0.5)],
                              [i, a])
        return L.reduce_sum(out)

    res = []
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), _names(pkg).guard():
            loss = build(pkg.layers, pkg)
        res.append(np.asarray(pkg.Executor(pkg.CPUPlace()).run(
            main, feed={"a": f32(2, 3, seed=3)}, fetch_list=[loss],
            scope=pkg.Scope())[0]))
    np.testing.assert_allclose(res[1], res[0], rtol=1e-5, atol=1e-6)


def test_step_counter_counts_from_begin():
    res = []
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), _names(pkg).guard():
            cnt = pkg.layers.autoincreased_step_counter(begin=5, step=2)
        scope, exe = pkg.Scope(), pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        res.append([int(np.asarray(exe.run(main, fetch_list=[cnt],
                                           scope=scope)[0])[0])
                    for _ in range(3)])
    assert res[0] == res[1] == [5, 7, 9]


def test_ssd_layers_train_as_jax():
    """multi_box_head -> ssd_loss over both packages from JAX's startup
    values: the loss and the head's gradients."""
    rng = np.random.RandomState(4)
    gb = np.array([[[0.1, 0.1, 0.5, 0.6], [0, 0, 0, 0]],
                   [[0.3, 0.2, 0.9, 0.8], [0.1, 0.5, 0.4, 0.9]]], np.float32)
    feed = {"img": rng.randn(2, 3, 32, 32).astype(np.float32),
            "f1": rng.randn(2, 8, 4, 4).astype(np.float32),
            "gb": gb, "gl": np.array([[1, 0], [2, 1]], np.int64)}

    def build(pkg):
        L = pkg.layers
        img = _d(L, "img", [2, 3, 32, 32])
        f1 = _d(L, "f1", [2, 8, 4, 4])
        loc, conf, pb, pv = L.multi_box_head([f1], img, 3, [8.0],
                                             max_sizes=[16.0],
                                             aspect_ratios=[[2.0]])
        return L.ssd_loss(loc, conf, _d(L, "gb", [2, 2, 4]),
                          _d(L, "gl", [2, 2], "int64"), pb, pv)

    out = []
    init = None
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 3
        with pkg.program_guard(main, startup), _names(pkg).guard():
            loss = build(pkg)
            pkg.append_backward(loss)
        scope, exe = pkg.Scope(), pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        params = [p.name for p in main.all_parameters()]
        if init is None:
            init = {n: np.asarray(scope.find_var(n)) for n in params}
        else:
            load_scope_arrays(scope, init, main, "cpu")
        vals = exe.run(main, feed=feed, fetch_list=[loss] + [
            n + "@GRAD" for n in params], scope=scope)
        out.append({n: np.asarray(v) for n, v in zip(["loss"] + [
            n + "@GRAD" for n in params], vals)})
    check_split(*out)


# -- ratchets ---------------------------------------------------------------------

# the lowerings of the JAX package the port does not register (ROADMAP A11)
NOT_PORTED = {
    # ops/fused.py
    "fc", "fused_elemwise_activation", "fused_fc_elementwise_layernorm",
    "fused_batch_norm_act", "fusion_repeated_fc_relu",
    "fusion_squared_mat_sub", "fusion_transpose_flatten_concat",
    "multihead_matmul", "conv2d_fusion", "conv2d_inception_fusion",
    # ops/dist_compute.py (the parameter server)
    "split_ids", "merge_ids", "split_byref", "ref_by_trainer_id",
    "split_selected_rows", "distributed_lookup_table", "lookup_sparse_table",
    "fake_init", "delete_var", "coalesce_tensor",
    # the Program forms of the kernel ops
    "batched_lora_matmul", "batched_lora_fc", "paged_attention",
    "kv_cache_write", "ragged_paged_attention", "ragged_paged_attention_q",
    "kv_cache_write_q",
}


def _registered(reg):
    """The registered lowerings, without the automatic grad ops both
    registries cache as they are asked for."""
    return {n for n, d in reg.items()
            if "_make_auto_grad" not in d.lower.__qualname__}


def test_the_port_registers_397_lowerings():
    port, jax_ops = _registered(_OP_REGISTRY), _registered(JAX_REGISTRY)
    assert len(jax_ops) == 424
    assert len(port) == 397
    assert port <= jax_ops
    assert jax_ops - port == NOT_PORTED


def test_every_layer_of_jax_is_exported():
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and callable(getattr(mod, n))}

    missing = sorted(public(jfluid.layers) - public(fluid.layers))
    assert not missing, missing
    assert len(public(jfluid.layers)) == 300
    assert len(LAYERS) == 80
    from paddle_tpu_torch.layers import distributions

    for cls in ("Uniform", "Normal", "Categorical", "MultivariateNormalDiag"):
        assert hasattr(distributions, cls)


# the parity files of the earlier slices, by the ops they hold to JAX's
HERE = os.path.dirname(os.path.abspath(__file__))


def _parity_text():
    return {os.path.basename(p): open(p).read()
            for p in glob.glob(os.path.join(HERE, "test_torch_*.py"))
            if not p.endswith("test_torch_gpu.py")}


def test_every_registered_lowering_has_a_parity_case():
    """Each lowering the port registers is named, as a string, by a
    ``test_torch_*`` file (the CPU parity files; ``test_torch_gpu.py``
    runs on the card); the ops of this slice are all in the sweep twins'
    ``NEW_OPS``."""
    from test_torch_sweep_tensor import NEW_OPS

    new = {n for ops in NEW_OPS.values() for n in ops}
    assert len(new) == 108
    texts = _parity_text()
    named = set()
    for text in texts.values():
        named |= set(re.findall(r'"([a-z0-9_]+)"', text))
    missing = sorted(_registered(_OP_REGISTRY) - named - new)
    assert not missing, f"registered without a parity case: {missing}"
