"""The port's SelectedRows sparse gradients against the JAX package, on
the CPU.

(a) Twins of tests/test_selected_rows.py: the type's ``to_dense`` and
    ``merge``; sparse SGD equals dense SGD; sparse Momentum leaves the
    untouched rows alone; sparse Adam against the lazy numpy oracle; the
    sum of two sparse gradients of one table (rename-then-sum). JAX's
    two jit / pytree tests become: the port's merge and ``to_dense``
    equal JAX's (its dense tensor and its touched rows; not its padded
    layout), and the type's arithmetic. The jaxpr-counting test becomes
    the fetched gradient: a SelectedRows of the batch's N rows.
(b) An embedding program's trajectory under SGD, Momentum (plain and
    Nesterov), Adam and Adagrad with ``is_sparse=True``, fused and
    unfused, equals JAX's at ``TRAIN_RTOL`` / ``TRAIN_ATOL``.
(c) DeepFM and wide&deep (``models/ctr.py``) under SGD, Momentum, Adam
    and Adagrad, sparse and dense: losses and every persistable after 3
    steps from JAX's startup values, at the same tolerance.
(d) The ops over a SelectedRows (``merge_selected_rows``,
    ``get_tensor_from_selected_rows``, ``sum`` of sparse and of mixed
    inputs, ``scale``), the fused ops' hand-off with a clip scale, both
    lookups and their gradients (sparse and dense, a padding id), and
    the new layers' lowerings (``sigmoid``, ``concat``,
    ``sigmoid_cross_entropy_with_logits``) with their gradients.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core.framework import unique_name as jax_unique_name
from paddle_tpu.core.selected_rows import SelectedRows as JSR
from paddle_tpu.models import ctr as jctr

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.core.selected_rows import SelectedRows, is_selected_rows
from paddle_tpu_torch.io import load_scope_arrays
from paddle_tpu_torch.models import ctr as tctr

TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5
OP_RTOL, OP_ATOL = 1e-6, 1e-6
VOCAB, DIM = 1000, 8


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


def _names(pkg):
    return jax_unique_name if pkg is jfluid else fluid.unique_name


def _persistables(program):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and not v.is_data)


def train_both(build, feeds):
    """``build(pkg) -> (main, startup, loss)`` in each package; the port
    starts from JAX's startup values. Returns (JAX losses, JAX
    persistables, port losses, port persistables)."""
    jmain, jstart, jloss = build(jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        init = {n: np.asarray(scope.find_var(n)) for n in _persistables(jmain)}
        jl = [float(np.asarray(exe.run(jmain, feed=f, fetch_list=[jloss])[0]))
              for f in feeds]
        jfinal = {n: np.asarray(scope.find_var(n))
                  for n in _persistables(jmain)}
    tmain, _, tloss = build(fluid)
    assert _persistables(tmain) == sorted(init)
    tscope = fluid.Scope()
    load_scope_arrays(tscope, init, tmain, "cpu")
    texe = fluid.Executor(fluid.CPUPlace())
    tl = [float(texe.run(tmain, feed=f, fetch_list=[tloss],
                         scope=tscope)[0]) for f in feeds]
    return jl, jfinal, tl, {n: tscope.get_numpy(n) for n in jfinal}


def assert_trained_alike(jl, jfinal, tl, tfinal):
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    for n in jfinal:
        np.testing.assert_allclose(tfinal[n], jfinal[n], rtol=TRAIN_RTOL,
                                   atol=TRAIN_ATOL, err_msg=n)


# -- (a) twins of tests/test_selected_rows.py --------------------------------


def _embedding_program(pkg, is_sparse, make_opt):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup), _names(pkg).guard():
        ids = pkg.layers.data("ids", [4], dtype="int64")
        emb = pkg.layers.embedding(ids, [VOCAB, DIM], is_sparse=is_sparse,
                                   param_attr=pkg.ParamAttr(name="emb.w"))
        loss = pkg.layers.mean(emb)
        make_opt(pkg).minimize(loss)
    return main, startup, loss


def _port_train(main, startup, loss, n=3, seed=7):
    scope = fluid.Scope()
    rng = np.random.RandomState(seed)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    for _ in range(n):
        ids = rng.randint(0, VOCAB, size=(5, 4)).astype("int64")
        ids[0] = ids[1]     # duplicates inside a batch
        exe.run(main, feed={"ids": ids}, fetch_list=[loss], scope=scope)
    return scope.get_numpy("emb.w"), scope


class TestSelectedRowsType:
    def test_to_dense_and_merge(self):
        rows = torch.tensor([2, 5, 2, 7])
        vals = torch.arange(4 * DIM, dtype=torch.float32).reshape(4, DIM)
        sr = SelectedRows(rows, vals, height=10)
        expect = np.zeros((10, DIM), np.float32)
        for r, v in zip(rows.numpy(), vals.numpy()):
            expect[r] += v
        np.testing.assert_allclose(sr.to_dense().numpy(), expect)
        merged = sr.merge()
        np.testing.assert_allclose(merged.to_dense().numpy(), expect)
        # the port keeps the true count of distinct rows: no padding row
        assert merged.rows.tolist() == [2, 5, 7]

    @pytest.mark.parametrize("n,height,dims", [(4, 10, (DIM,)),
                                               (64, 7, (3,)),
                                               (200, 1000, (2, 5)),
                                               (1, 3, (4,))])
    def test_merge_and_to_dense_equal_jax(self, n, height, dims):
        rng = np.random.RandomState(n)
        rows = rng.randint(0, height, n)
        vals = rng.randn(n, *dims).astype(np.float32)
        j = JSR(jnp.asarray(rows), jnp.asarray(vals), height)
        t = SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals),
                         height)
        np.testing.assert_array_equal(t.to_dense().numpy(),
                                      np.asarray(j.to_dense()))
        jm, tm = j.merge(), t.merge()
        jrows = np.asarray(jm.rows)
        real = jrows < height            # JAX pads with the row `height`
        np.testing.assert_array_equal(tm.rows.numpy(), jrows[real])
        np.testing.assert_array_equal(tm.values.numpy(),
                                      np.asarray(jm.values)[real])
        np.testing.assert_array_equal(tm.to_dense().numpy(),
                                      np.asarray(jm.to_dense()))

    def test_arithmetic_and_metadata(self):
        sr = SelectedRows(torch.tensor([0, 1]), torch.ones(2, 3), height=5)
        for out in (sr * 2.0, 2.0 * sr):
            assert isinstance(out, SelectedRows) and out.height == 5
            np.testing.assert_allclose(out.values.numpy(), 2.0)
        np.testing.assert_allclose((-sr).values.numpy(), -1.0)
        assert sr.shape == (5, 3) and sr.ndim == 2
        assert sr.dtype == torch.float32
        assert sr.astype(torch.float64).dtype == torch.float64
        assert is_selected_rows(sr) and not is_selected_rows(sr.values)
        with pytest.raises(ValueError, match="height mismatch"):
            sr.concat(SelectedRows(torch.tensor([0]), torch.ones(1, 3), 6))


class TestSparseTraining:
    def test_sgd_sparse_matches_dense(self):
        w_sparse, _ = _port_train(*_embedding_program(
            fluid, True, lambda pkg: pkg.optimizer.SGD(0.5)))
        w_dense, _ = _port_train(*_embedding_program(
            fluid, False, lambda pkg: pkg.optimizer.SGD(0.5)))
        np.testing.assert_allclose(w_sparse, w_dense, rtol=1e-6)

    def test_momentum_sparse_touches_only_seen_rows(self):
        main, startup, loss = _embedding_program(
            fluid, True, lambda pkg: pkg.optimizer.Momentum(0.5, momentum=0.9))
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        w0 = scope.get_numpy("emb.w").copy()
        ids = np.array([[1, 2, 3, 1]], dtype="int64")
        exe.run(main, feed={"ids": ids}, fetch_list=[loss], scope=scope)
        w1 = scope.get_numpy("emb.w")
        touched = sorted(set(ids.ravel().tolist()))
        untouched = [r for r in range(VOCAB) if r not in touched]
        np.testing.assert_array_equal(w1[untouched], w0[untouched])
        assert not np.allclose(w1[touched], w0[touched])

    def test_adam_sparse_lazy_oracle(self):
        lr, b1, b2, eps = 0.1, 0.9, 0.999, 1e-8
        main, startup, loss = _embedding_program(
            fluid, True, lambda pkg: pkg.optimizer.Adam(
                lr, beta1=b1, beta2=b2, epsilon=eps))
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        w0 = scope.get_numpy("emb.w").astype(np.float64)
        ids = np.array([[3, 3, 8, 2]], dtype="int64")
        exe.run(main, feed={"ids": ids}, fetch_list=[loss], scope=scope)
        w1 = scope.get_numpy("emb.w")
        n_elem = ids.size * DIM
        g = np.zeros_like(w0)
        for r in ids.ravel():
            g[r] += 1.0 / n_elem
        touched = sorted(set(ids.ravel().tolist()))
        expect = w0.copy()
        for r in touched:
            m1 = (1 - b1) * g[r]
            m2 = (1 - b2) * g[r] ** 2
            lr_t = lr * np.sqrt(1 - b2) / (1 - b1)
            expect[r] = w0[r] - lr_t * m1 / (np.sqrt(m2) + eps)
        np.testing.assert_allclose(w1, expect, rtol=2e-5, atol=1e-6)
        untouched = [r for r in range(VOCAB) if r not in touched]
        np.testing.assert_array_equal(w1[untouched],
                                      w0[untouched].astype(w1.dtype))

    def test_sparse_gradient_is_the_batch_rows(self):
        """No vocab-sized gradient: the fetched W@GRAD is a SelectedRows
        of the batch's N = 5 x 4 ids (host arrays), the dense run's a
        [VOCAB, DIM] tensor."""
        grads = {}
        for sparse in (True, False):
            main, startup, loss = _embedding_program(
                fluid, sparse, lambda pkg: pkg.optimizer.SGD(0.5))
            scope = fluid.Scope()
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup, scope=scope)
            ids = np.random.RandomState(0).randint(0, VOCAB, (5, 4))
            (grads[sparse],) = exe.run(main, feed={"ids": ids},
                                       fetch_list=["emb.w@GRAD"], scope=scope)
        sg = grads[True]
        assert isinstance(sg, SelectedRows) and sg.height == VOCAB
        assert isinstance(sg.values, np.ndarray) and sg.values.shape == (20, DIM)
        assert grads[False].shape == (VOCAB, DIM)
        dense = np.zeros((VOCAB, DIM), np.float32)
        np.add.at(dense, sg.rows, sg.values)
        np.testing.assert_allclose(dense, grads[False], rtol=1e-6)

    @pytest.mark.parametrize("sparse", [True, False])
    def test_shared_embedding_sparse_grad_aggregation(self, sparse):
        """Two lookups into one table: the sum op concatenates the two
        SelectedRows; the result equals JAX's and the dense run's."""
        def build(pkg, is_sparse=sparse):
            main, startup = pkg.Program(), pkg.Program()
            main.random_seed = startup.random_seed = 2
            with pkg.program_guard(main, startup), _names(pkg).guard():
                a = pkg.layers.data("a", [4], dtype="int64")
                b = pkg.layers.data("b", [4], dtype="int64")
                attr = pkg.ParamAttr(name="shared.w")
                ea = pkg.layers.embedding(a, [VOCAB, DIM], is_sparse=is_sparse,
                                          param_attr=attr)
                eb = pkg.layers.embedding(b, [VOCAB, DIM], is_sparse=is_sparse,
                                          param_attr=attr)
                loss = pkg.layers.mean(pkg.layers.elementwise_add(ea, eb))
                pkg.optimizer.SGD(0.5).minimize(loss)
            return main, startup, loss

        rng = np.random.RandomState(0)
        feed = {"a": rng.randint(0, VOCAB, (3, 4)).astype("int64"),
                "b": rng.randint(0, VOCAB, (3, 4)).astype("int64")}
        feed["b"][0] = feed["a"][0]          # rows both lookups touch
        jl, jfinal, tl, tfinal = train_both(build, [feed, feed])
        assert_trained_alike(jl, jfinal, tl, tfinal)
        types = [op.type for op in build(fluid)[0].global_block().ops]
        assert "sum" in types


# -- (b) embedding trajectories against JAX -------------------------------------


EMB_OPTIMIZERS = {
    "sgd": lambda pkg: pkg.optimizer.SGD(0.5),
    "momentum": lambda pkg: pkg.optimizer.Momentum(0.5, momentum=0.9),
    "nesterov": lambda pkg: pkg.optimizer.Momentum(0.5, momentum=0.9,
                                                   use_nesterov=True),
    "adam": lambda pkg: pkg.optimizer.Adam(0.1),
    "adagrad": lambda pkg: pkg.optimizer.Adagrad(0.5),
}


def _emb_feeds(n=3, seed=7):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, 50, size=(5, 4)).astype("int64")
        ids[0] = ids[1]
        out.append({"ids": ids})
    return out


@pytest.mark.parametrize("fuse", ["off", "on"])
@pytest.mark.parametrize("name", sorted(EMB_OPTIMIZERS))
def test_sparse_embedding_trains_as_jax(name, fuse, fuse_flag):
    fuse_flag(fuse)
    build = lambda pkg: _embedding_program(pkg, True, EMB_OPTIMIZERS[name])
    assert_trained_alike(*train_both(build, _emb_feeds()))


# -- (c) DeepFM and wide&deep ---------------------------------------------------


CTR_OPTIMIZERS = {
    "sgd": lambda pkg: pkg.optimizer.SGD(0.1),
    "momentum": lambda pkg: pkg.optimizer.Momentum(0.05, momentum=0.9),
    "adam": lambda pkg: pkg.optimizer.Adam(0.01),
    "adagrad": lambda pkg: pkg.optimizer.Adagrad(0.05),
}


def _ctr_build(model, opt, sparse):
    def build(pkg):
        mod = jctr if pkg is jfluid else tctr
        fn = mod.build_deepfm if model == "deepfm" else mod.build_wide_deep
        main, startup, _, fetches = fn(optimizer=CTR_OPTIMIZERS[opt](pkg),
                                       is_sparse=sparse)
        main.random_seed = startup.random_seed = 4
        return main, startup, fetches["loss"]
    return build


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("opt", sorted(CTR_OPTIMIZERS))
@pytest.mark.parametrize("model", ["deepfm", "wide_deep"])
def test_ctr_model_trains_as_jax(model, opt, sparse):
    rng = np.random.RandomState(1)
    feeds = [tctr.synthetic_ctr_batch(rng, 32) for _ in range(3)]
    if model == "wide_deep":
        feeds = [{k: v for k, v in f.items() if k != "dense_x"}
                 for f in feeds]
    jl, jfinal, tl, tfinal = train_both(_ctr_build(model, opt, sparse), feeds)
    assert_trained_alike(jl, jfinal, tl, tfinal)


def test_ctr_batches_equal_jax():
    a = tctr.synthetic_ctr_batch(np.random.RandomState(5), 64)
    b = jctr.synthetic_ctr_batch(np.random.RandomState(5), 64)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


# -- (d) the ops ------------------------------------------------------------------


class _Op:
    def __init__(self, **attrs):
        self.attrs = attrs


def _pair(rows, vals, height):
    return (JSR(jnp.asarray(rows), jnp.asarray(vals), height),
            SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals),
                         height))


def _jax_lower(op_type, op, ins):
    from paddle_tpu.core.registry import get_op_def as jget

    return jget(op_type).lower(None, op, ins)


def test_merge_and_get_tensor_ops_equal_jax():
    rng = np.random.RandomState(3)
    j, t = _pair(rng.randint(0, 9, 30), rng.randn(30, 4).astype("f"), 9)
    jm = _jax_lower("merge_selected_rows", _Op(), {"X": [j]})["Out"][0]
    tm = get_op_def("merge_selected_rows").lower(None, _Op(), {"X": [t]})["Out"][0]
    np.testing.assert_array_equal(tm.to_dense().numpy(),
                                  np.asarray(jm.to_dense()))
    jd = _jax_lower("get_tensor_from_selected_rows", _Op(), {"X": [j]})["Out"][0]
    td = get_op_def("get_tensor_from_selected_rows").lower(
        None, _Op(), {"X": [t]})["Out"][0]
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    with pytest.raises(TypeError, match="SelectedRows"):
        get_op_def("merge_selected_rows").lower(None, _Op(),
                                                {"X": [torch.zeros(2)]})


def test_sum_and_scale_of_selected_rows_equal_jax():
    rng = np.random.RandomState(4)
    j1, t1 = _pair(rng.randint(0, 6, 5), rng.randn(5, 3).astype("f"), 6)
    j2, t2 = _pair(rng.randint(0, 6, 4), rng.randn(4, 3).astype("f"), 6)
    dense = rng.randn(6, 3).astype("f")
    js = _jax_lower("sum", _Op(), {"X": [j1, j2]})["Out"][0]
    ts = get_op_def("sum").lower(None, _Op(), {"X": [t1, t2]})["Out"][0]
    assert isinstance(ts, SelectedRows) and ts.rows.numel() == 9
    np.testing.assert_array_equal(ts.to_dense().numpy(),
                                  np.asarray(js.to_dense()))
    jm = _jax_lower("sum", _Op(), {"X": [j1, jnp.asarray(dense)]})["Out"][0]
    tm = get_op_def("sum").lower(None, _Op(),
                                 {"X": [t1, torch.from_numpy(dense)]})["Out"][0]
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=OP_RTOL,
                               atol=OP_ATOL)
    op = _Op(scale=0.25, bias=0.0)
    jsc = _jax_lower("scale", op, {"X": [j1]})["Out"][0]
    tsc = get_op_def("scale").lower(None, op, {"X": [t1]})["Out"][0]
    np.testing.assert_array_equal(tsc.to_dense().numpy(),
                                  np.asarray(jsc.to_dense()))
    with pytest.raises(ValueError, match="bias"):
        get_op_def("scale").lower(None, _Op(scale=1.0, bias=1.0), {"X": [t1]})


@pytest.mark.parametrize("op_type", ["fused_adam", "fused_momentum"])
def test_fused_ops_hand_sparse_gradients_to_the_plain_path(op_type):
    """A SelectedRows gradient takes the unfused sparse update with the
    clip scale on its values; untouched rows keep their bits."""
    rng = np.random.RandomState(6)
    H, D = 12, 5
    p = rng.randn(H, D).astype("f")
    rows = np.array([3, 7, 3, 0], "int64")
    vals = rng.randn(4, D).astype("f")
    clip = np.array([0.5], "f")
    lr = np.array([0.1], "f")
    state = {k: np.abs(rng.randn(H, D)).astype("f") for k in
             ("Moment1", "Moment2", "Velocity")}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "mu": 0.9}
    names = (("Moment1", "Moment2") if op_type == "fused_adam"
             else ("Velocity",))

    def ins(mk, sr):
        d = {"Param": [mk(p)], "Grad": [sr], "LearningRate": [mk(lr)],
             "ClipScale": [mk(clip)]}
        for k in names:
            d[k] = [mk(state[k])]
        if op_type == "fused_adam":
            d["Beta1Pow"] = [mk(np.array([0.9], "f"))]
            d["Beta2Pow"] = [mk(np.array([0.999], "f"))]
        return d

    j, _ = _pair(rows, vals, H)
    jout = _jax_lower(op_type, _Op(**attrs), ins(jnp.asarray, j))
    tins = ins(lambda a: torch.from_numpy(a.copy()),
               SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals), H))
    tout = get_op_def(op_type).lower(None, _Op(**attrs), tins)
    for slot, vals_ in jout.items():
        np.testing.assert_allclose(tout[slot][0].numpy(),
                                   np.asarray(vals_[0]), rtol=OP_RTOL,
                                   atol=OP_ATOL, err_msg=slot)
    untouched = [r for r in range(H) if r not in rows]
    np.testing.assert_array_equal(tout["ParamOut"][0].numpy()[untouched],
                                  p[untouched])


@pytest.mark.parametrize("op_type,slots", [
    ("sigmoid", ("X",)), ("concat", ("X", "X2")),
    ("sigmoid_cross_entropy_with_logits", ("X", "Label")),
])
def test_ctr_op_lowerings_and_grads_equal_jax(op_type, slots):
    """Forward and the gradient of sum(out * w) for each input."""
    import jax
    from paddle_tpu.core.registry import get_op_def as jget

    rng = np.random.RandomState(8)
    xs = [rng.randn(6, 3).astype("f") for _ in slots]
    if op_type == "sigmoid_cross_entropy_with_logits":
        xs[1] = (rng.rand(6, 3) > 0.5).astype("f")
        xs[1][0, 0] = -100.0                     # ignored
    op = _Op(axis=1, ignore_index=-100, normalize=True)

    def ins_of(vals):
        if op_type == "concat":
            return {"X": list(vals)}
        return dict(zip(slots, [[v] for v in vals]))

    jouts = jget(op_type).lower(None, op, ins_of([jnp.asarray(x) for x in xs]))
    w = rng.randn(*np.asarray(jouts["Out"][0]).shape).astype("f")
    touts = get_op_def(op_type).lower(
        None, op, ins_of([torch.from_numpy(x) for x in xs]))
    np.testing.assert_allclose(touts["Out"][0].numpy(),
                               np.asarray(jouts["Out"][0]), rtol=OP_RTOL,
                               atol=OP_ATOL)
    n_diff = 1 if op_type == "sigmoid_cross_entropy_with_logits" else len(xs)

    def jloss(*a):
        vals = list(a) + [jnp.asarray(x) for x in xs[n_diff:]]
        return jnp.sum(jget(op_type).lower(None, op, ins_of(vals))["Out"][0]
                       * w)

    jg = jax.grad(jloss, argnums=tuple(range(n_diff)))(
        *[jnp.asarray(x) for x in xs[:n_diff]])
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in xs[:n_diff]]
    vals = leaves + [torch.from_numpy(x) for x in xs[n_diff:]]
    out = get_op_def(op_type).lower(None, op, ins_of(vals))["Out"][0]
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("op_type", ["lookup_table", "lookup_table_v2"])
@pytest.mark.parametrize("sparse", [True, False])
def test_lookup_and_its_gradient_equal_jax(op_type, sparse):
    """Forward rows (padding row zeroed) and the gradient, a SelectedRows
    of the flat ids (padding rows zeroed) or the dense scatter-add."""
    rng = np.random.RandomState(9)
    w = rng.randn(20, 3).astype("f")
    ids = rng.randint(0, 20, (4, 5, 1) if op_type == "lookup_table"
                      else (4, 5)).astype("int64")
    ids.reshape(-1)[:3] = 7                      # the padding id, repeated
    og = rng.randn(4, 5, 3).astype("f")
    op = _Op(padding_idx=7, is_sparse=sparse)
    jf = _jax_lower(op_type, op, {"W": [jnp.asarray(w)],
                                  "Ids": [jnp.asarray(ids)]})["Out"][0]
    tf = get_op_def(op_type).lower(None, op, {
        "W": [torch.from_numpy(w)], "Ids": [torch.from_numpy(ids)]})["Out"][0]
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    gins = lambda mk: {"W": [mk(w)], "Ids": [mk(ids)], "Out@GRAD": [mk(og)]}
    jg = _jax_lower(op_type + "_grad", op, gins(jnp.asarray))["W@GRAD"][0]
    tg = get_op_def(op_type + "_grad").lower(
        None, op, gins(torch.from_numpy))["W@GRAD"][0]
    assert isinstance(tg, SelectedRows) == sparse
    if sparse:
        np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows))
        np.testing.assert_array_equal(tg.values.numpy(), np.asarray(jg.values))
        tg, jg = tg.to_dense(), jg.to_dense()
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=OP_RTOL,
                               atol=OP_ATOL)
