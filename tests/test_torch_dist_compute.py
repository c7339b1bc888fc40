"""The parameter server's tensor ops (``ops/dist_compute.py``) against
the JAX package, on the CPU: each of the 10 lowerings as a one-op
Program in both packages on the same seeded inputs
(``test_torch_activations.both``), outputs equal (integer and data
movement) or within rtol 1e-5 / atol 1e-6 (sums), gradients within
rtol 2e-4 / atol 2e-5; the port's static-shape forms are JAX's (full
length, -1 sentinels, zero rows). Fed tensors and the scope are left
as JAX leaves them.
"""

import numpy as np
import pytest
import torch

from test_torch_activations import (ATOL, RTOL, TRAIN_ATOL, TRAIN_RTOL,
                                    both, check)
from test_torch_layer_surface import _names

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid


def _f(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_split_ids_routes_by_modulo():
    ids = np.array([3, 4, 7, 10, 0, 5], np.int64)
    j, t = both("split_ids", {"Ids": ids}, {}, {"Out": 3})
    check(j, t, exact=True)
    np.testing.assert_array_equal(t["o_Out_1"], [-1, 4, 7, 10, -1, -1])


def test_merge_ids_sums_the_shards():
    ids = np.array([[3], [4], [6]], np.int64)
    x0 = np.array([[0, 0], [4.0, 4.5], [0, 0]], np.float32)
    x1 = np.array([[3.0, 3.5], [0, 0], [6.0, 6.5]], np.float32)
    j, t = both("merge_ids", {"Ids": ids, "Rows": ids, "X": [x0, x1]}, {},
                {"Out": 1}, grads=("X",))
    check(j, t, TRAIN_RTOL, TRAIN_ATOL)
    np.testing.assert_array_equal(t["o_Out_0"], x0 + x1)


@pytest.mark.parametrize("sections", [[], [2, 5]])
def test_split_byref(sections):
    j, t = both("split_byref", {"X": _f(7, 3)}, {"sections": sections},
                {"Out": 2}, grads=("X",))
    check(j, t, TRAIN_RTOL, TRAIN_ATOL)
    assert t["o_Out_1"].shape[0] == (4 if not sections else 5)


@pytest.mark.parametrize("tid", [0, 1, 5])
def test_ref_by_trainer_id_clamps_as_jax(tid):
    ins = {"X": [_f(2, 3), _f(2, 3, seed=1)],
           "TrainerId": np.array([tid], np.int64)}
    j, t = both("ref_by_trainer_id", ins, {}, {"Out": 1}, grads=("X",))
    check(j, t, TRAIN_RTOL, TRAIN_ATOL)
    np.testing.assert_array_equal(t["o_Out_0"], ins["X"][min(tid, 1)])


@pytest.mark.parametrize("shape", [(4, 1), (2, 3)])
def test_distributed_lookup_table(shape):
    ids = np.random.RandomState(1).randint(0, 10, shape).astype(np.int64)
    ids2 = np.random.RandomState(2).randint(0, 10, (3, 1)).astype(np.int64)
    j, t = both("distributed_lookup_table", {"W": _f(10, 4), "Ids": [ids,
                                                                     ids2]},
                {}, {"Outputs": 2}, grads=("W",))
    check(j, t, TRAIN_RTOL, TRAIN_ATOL)
    lead = shape[:-1] if shape[-1] == 1 else shape
    assert t["o_Outputs_0"].shape == tuple(lead) + (4,)


def test_lookup_sparse_table():
    ids = np.array([[1], [7], [1], [0]], np.int64)
    j, t = both("lookup_sparse_table", {"W": _f(8, 3), "Ids": ids}, {},
                {"Out": 1}, grads=("W",))
    check(j, t, TRAIN_RTOL, TRAIN_ATOL)


def test_fake_init_makes_zeros():
    j, t = both("fake_init", {}, {"shape": [3, 4]}, {"Out": 1})
    check(j, t, exact=True)
    assert t["o_Out_0"].shape == (3, 4) and not t["o_Out_0"].any()


@pytest.mark.parametrize("set_constant", [False, True])
def test_coalesce_tensor(set_constant):
    ins = {"Input": [_f(2, 3), _f(4, seed=1), _f(1, 2, 2, seed=2)]}
    attrs = {"set_constant": set_constant, "constant": 0.5}
    j, t = both("coalesce_tensor", ins, attrs,
                {"Output": 3, "FusedOutput": 1})
    check(j, t, exact=True)
    assert t["o_FusedOutput_0"].shape == (14,)
    if not set_constant:
        j, t = both("coalesce_tensor", ins, attrs,
                    {"Output": 3, "FusedOutput": 1}, grads=("Input",))
        check(j, t, TRAIN_RTOL, TRAIN_ATOL)


def _split_selected_rows(pkg):
    """JAX's ``test_split_selected_rows`` Program: a sparse embedding
    gradient split by height sections, each shard merged and made
    dense."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), _names(pkg).guard():
        ids = pkg.layers.data("ids", [3], dtype="int64")
        emb = pkg.layers.embedding(ids, size=[8, 4], is_sparse=True,
                                   param_attr=pkg.ParamAttr(name="emb.w"))
        loss = pkg.layers.reduce_sum(emb * emb)
        pkg.optimizer.SGD(0.0).minimize(loss)
        block = main.global_block()
        shards = [block.create_var(name=f"shard{k}", stop_gradient=True)
                  for k in range(2)]
        block.append_op(type="split_selected_rows",
                        inputs={"X": ["emb.w@GRAD"]},
                        outputs={"Out": shards},
                        attrs={"height_sections": [3, 5]})
        dense = []
        for s in shards:
            d = block.create_var(name=s.name + "_d", stop_gradient=True)
            block.append_op(type="get_tensor_from_selected_rows",
                            inputs={"X": [s]}, outputs={"Out": [d]})
            dense.append(d)
    return main, startup, dense


def test_split_selected_rows_as_jax():
    feed = {"ids": np.array([[0, 4, 4], [7, 2, 0]], np.int64)}
    res, init = [], None
    for pkg in (jfluid, fluid):
        main, startup, dense = _split_selected_rows(pkg)
        scope, exe = pkg.Scope(), pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        if init is None:
            init = np.asarray(scope.find_var("emb.w"))
        else:
            scope.set_var("emb.w", torch.from_numpy(init.copy()))
        res.append([np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=dense, scope=scope)])
    for a, b in zip(*res):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    # the shards' rows cover the full gradient
    full = np.zeros((8, 4), np.float32)
    for k, ids in enumerate(feed["ids"].reshape(-1)):
        full[ids] += 2 * init[ids]
    np.testing.assert_allclose(np.concatenate([res[1][0], res[1][1]]),
                               full, rtol=1e-5, atol=1e-6)


def test_delete_var_leaves_the_scope_as_jax():
    """``delete_var`` lowers to nothing in both packages: the scope's var
    is still there after the run, with its value."""
    res = []
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), _names(pkg).guard():
            x = pkg.layers.data("x", [2])
            w = pkg.layers.create_parameter([2], "float32", name="dv.w")
            out = pkg.layers.elementwise_add(x, w)
            main.global_block().append_op(type="delete_var",
                                          inputs={"X": [w]})
        scope, exe = pkg.Scope(), pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        before = np.asarray(scope.find_var("dv.w")).copy()
        (v,) = exe.run(main, feed={"x": np.ones((1, 2), np.float32)},
                       fetch_list=[out], scope=scope)
        assert scope.find_var("dv.w") is not None
        np.testing.assert_array_equal(np.asarray(scope.find_var("dv.w")),
                                      before)
        res.append(np.asarray(v) - before)
    np.testing.assert_array_equal(res[0], res[1])


def test_fed_tensors_are_never_written():
    """The port's lowerings leave the tensors they are fed as they were
    (JAX's are functional): coalesce_tensor under set_constant, the
    split ops and merge_ids."""
    cases = [
        ("coalesce_tensor", {"Input": [_f(2, 3), _f(4, seed=1)]},
         {"set_constant": True, "constant": 2.0},
         {"Output": 2, "FusedOutput": 1}),
        ("split_ids", {"Ids": np.arange(6, dtype=np.int64)}, {}, {"Out": 2}),
        ("merge_ids", {"Ids": np.zeros((2, 1), np.int64),
                       "Rows": np.zeros((2, 1), np.int64),
                       "X": [_f(2, 2), _f(2, 2, seed=1)]}, {}, {"Out": 1}),
        ("split_byref", {"X": _f(5, 2)}, {}, {"Out": 2}),
    ]
    from test_torch_activations import _program

    for op, ins, attrs, outs in cases:
        main, _, fetch, _ = _program(fluid, op, ins, attrs, outs, ())
        feed = {f"{slot}_{k}": torch.from_numpy(np.asarray(a).copy())
                for slot, vals in ins.items()
                for k, a in enumerate(vals if isinstance(vals, list)
                                      else [vals])}
        before = {k: v.clone() for k, v in feed.items()}
        fluid.Executor(fluid.CPUPlace()).run(main, feed=feed,
                                             fetch_list=fetch,
                                             scope=fluid.Scope())
        for k in feed:
            assert torch.equal(feed[k], before[k]), (op, k)
