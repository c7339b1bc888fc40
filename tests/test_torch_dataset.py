"""The port's file datasets and host helpers held to the JAX package's on
the CPU: ``native/datafeed`` and ``dataset.py`` (twins of
``tests/test_dataset.py`` and of the dataset cases of
``tests/test_async_reader.py``), ``Executor.train_from_dataset`` at
thread 1 and Hogwild (``tests/test_downpour_hogwild.py::
test_hogwild_multithread_training``), the synthetic ``datasets`` readers,
``lod_tensor``, ``metrics``, ``average`` and ``fs``.

Parses, shuffle orders, reader samples, LoD arrays and metric values are
pure host code in both packages and must be EQUAL. Training is held bit
for bit within the port (``train_from_dataset`` at thread 1 against
``exe.run`` over the same batches) and within 1e-5 (rtol) of the JAX
package's losses from the same parameters.
"""

import logging
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import average as javerage
from paddle_tpu import dataset as jdataset
from paddle_tpu import datasets as jdatasets
from paddle_tpu import lod_tensor as jlod
from paddle_tpu import metrics as jmetrics
from paddle_tpu.native import datafeed as jfeed
from paddle_tpu_torch import average as taverage
from paddle_tpu_torch import dataset as tdataset
from paddle_tpu_torch import datasets as tdatasets
from paddle_tpu_torch import lod_tensor as tlod
from paddle_tpu_torch import metrics as tmetrics
from paddle_tpu_torch.fs import (ExecuteError, FSFileExistsError,
                                 FSFileNotExistsError,
                                 HDFSClient, LocalFS)
from paddle_tpu_torch.native import datafeed as tfeed

LOSS_RTOL = 1e-5


def _write_multislot(path, n=50, dim=4, seed=0):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            feats = rng.randn(dim)
            label = rng.randint(0, 2)
            f.write(f"{dim} " + " ".join(f"{v:.6f}" for v in feats)
                    + f" 1 {label}\n")


def _rows_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, y)


class _Var:
    def __init__(self, name, shape, dtype):
        self.name, self.shape, self.dtype = name, shape, dtype


def _vars():
    return [_Var("x", (4,), "float32"), _Var("y", (1,), "int64")]


def _dataset(mod, kind, files, batch=10, thread=1):
    ds = mod.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(batch)
    ds.set_thread(thread)
    ds.set_filelist(files)
    ds.set_use_var(_vars())
    return ds


# -- the MultiSlot parsers ----------------------------------------------------


def test_native_parser_builds_into_the_port():
    assert tfeed.available()
    assert os.path.exists(tfeed.library_path())
    assert "paddle_tpu_torch" in tfeed.library_path()


@pytest.mark.parametrize("n,dim", [(1, 1), (50, 4), (7, 13)])
def test_native_and_python_parses_equal_jax(tmp_path, n, dim):
    p = str(tmp_path / "data.txt")
    _write_multislot(p, n=n, dim=dim, seed=n)
    dtypes = ["float32", "int64"]
    native = list(tfeed.parse_file(p, 2, dtypes))
    assert len(native) == n
    if jfeed.available():
        _rows_equal(native, list(jfeed.parse_file(p, 2, dtypes)))
    ds = _dataset(tdataset, "QueueDataset", [p])
    ds.set_use_var([_Var("x", (dim,), "float32"), _Var("y", (1,), "int64")])
    jds = _dataset(jdataset, "QueueDataset", [p])
    jds.set_use_var([_Var("x", (dim,), "float32"), _Var("y", (1,), "int64")])
    py = list(ds._parse_file_py(p))
    _rows_equal(py, native)
    _rows_equal(list(ds._parse_file(p)), list(jds._parse_file(p)))


def test_native_parser_drops_malformed_lines_like_jax(tmp_path):
    p = str(tmp_path / "bad.txt")
    with open(p, "w") as f:
        f.write("2 1.0 2.0 1 7\n")       # good
        f.write("2 1.0 abc 1 7\n")       # malformed value -> dropped
        f.write("3 1.0 2.0\n")           # truncated -> must NOT eat next line
        f.write("\n")                    # blank -> skipped
        f.write("2 5.0 6.0 1 9")         # good, no trailing newline
    rows = list(tfeed.parse_file(p, 2, ["float32", "int64"]))
    assert len(rows) == 2, [r[0] for r in rows]
    np.testing.assert_allclose(rows[0][0], [1.0, 2.0])
    assert rows[0][1][0] == 7 and rows[1][1][0] == 9
    if jfeed.available():
        _rows_equal(rows, list(jfeed.parse_file(p, 2, ["float32", "int64"])))


@pytest.mark.parametrize("line", ["2 1.0 abc 1 7\n", "3 1.0 2.0\n"])
def test_python_parser_refuses_malformed_lines(tmp_path, line):
    p = str(tmp_path / "bad.txt")
    with open(p, "w") as f:
        f.write(line)
    ds = _dataset(tdataset, "QueueDataset", [p])
    with pytest.raises((ValueError, IndexError)):
        list(ds._parse_file_py(p))


def test_queue_dataset_surfaces_a_parse_error(tmp_path, monkeypatch):
    """A parse error in a channel thread reaches the consumer instead of
    leaving it waiting for a stop that never comes."""
    p = str(tmp_path / "bad.txt")
    with open(p, "w") as f:
        f.write("2 1.0 abc 1 7\n")
    monkeypatch.setattr(tfeed, "available", lambda: False)
    ds = _dataset(tdataset, "QueueDataset", [p], thread=2)
    with pytest.raises(ValueError):
        list(ds._iter_batches())


def test_missing_file_raises(tmp_path):
    with pytest.raises(IOError):
        list(tfeed.parse_file(str(tmp_path / "nope.txt"), 2,
                              ["float32", "int64"]))


# -- datasets: batches, shuffles ----------------------------------------------


def test_queue_dataset_batches_equal_jax(tmp_path):
    files = []
    for i in range(3):
        p = str(tmp_path / f"f{i}.txt")
        _write_multislot(p, n=25, seed=i)
        files.append(p)
    got = {}
    for name, mod in (("jax", jdataset), ("port", tdataset)):
        ds = _dataset(mod, "QueueDataset", files, batch=10, thread=1)
        got[name] = list(ds._iter_batches())
    assert len(got["port"]) == len(got["jax"]) == 8
    for a, b in zip(got["port"], got["jax"]):
        for k in ("x", "y"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_in_memory_local_shuffle_equals_jax(tmp_path, seed):
    p = str(tmp_path / "d.txt")
    _write_multislot(p, n=30)
    out = {}
    for name, mod in (("jax", jdataset), ("port", tdataset)):
        ds = _dataset(mod, "InMemoryDataset", [p])
        ds.load_into_memory()
        assert ds.get_memory_data_size() == 30
        before = [b["x"].copy() for b in ds._iter_batches()]
        ds.local_shuffle(seed=seed)
        out[name] = [b for b in ds._iter_batches()]
        assert not all(np.array_equal(a, b["x"])
                       for a, b in zip(before, out[name]))
        ds.release_memory()
        assert ds.get_memory_data_size() == 0
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])


@pytest.mark.parametrize("world", [2, 3])
def test_global_shuffle_partitions_equal_jax(tmp_path, monkeypatch, world):
    f = tmp_path / "data.txt"
    f.write_text("".join(f"1 {i} 1 {i % 3}\n" for i in range(10)))
    parts = {"jax": [], "port": []}
    for rank in range(world):
        monkeypatch.setenv("PADDLE_TRAINER_ID", str(rank))
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", str(world))
        for name, mod in (("jax", jdataset), ("port", tdataset)):
            ds = mod.InMemoryDataset()
            ds.set_batch_size(2)
            ds.set_use_var([_Var("a", (1,), "float32"),
                            _Var("b", (1,), "float32")])
            ds.set_filelist([str(f)])
            ds.load_into_memory()
            ds.global_shuffle(seed=5)
            parts[name].append([int(s[0][0]) for s in ds._samples])
    assert parts["port"] == parts["jax"]
    flat = [i for part in parts["port"] for i in part]
    assert sorted(flat) == list(range(10))


def test_global_shuffle_is_stable_across_epochs(tmp_path, monkeypatch):
    f = tmp_path / "data.txt"
    f.write_text("".join(f"1 {i}\n" for i in range(10)))
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    ds = tdataset.InMemoryDataset()
    ds.set_batch_size(2)
    ds.set_use_var([_Var("a2", (1,), "float32")])
    ds.set_filelist([str(f)])
    ds.load_into_memory()
    for _ in range(3):
        ds.global_shuffle()
        assert len(ds._samples) == 5


def test_dataset_factory_refuses_unknown_class():
    with pytest.raises(ValueError, match="unknown dataset class"):
        tdataset.DatasetFactory().create_dataset("Nope")


# -- train_from_dataset -------------------------------------------------------


def _linear(fluid, seed=7):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4])
        y = fluid.layers.data("y", [1], dtype="int64")
        logits = fluid.layers.fc(x, 2)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.SGD(0.05).minimize(loss)
    return main, startup, loss, x, y


def test_train_from_dataset_thread1_equals_run_and_jax(tmp_path):
    files = []
    for i in range(3):
        p = str(tmp_path / f"f{i}.txt")
        _write_multislot(p, n=40, seed=i)
        files.append(p)
    main, startup, loss, x, y = _linear(tfluid)
    ds = tdataset.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_batch_size(20)
    ds.set_thread(2)
    ds.set_filelist(files)
    ds.set_use_var([x, y])
    ds.load_into_memory()
    ds.local_shuffle(seed=1)
    batches = list(ds._iter_batches())

    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    scope2 = tfluid.Scope()
    exe2 = tfluid.Executor(tfluid.CPUPlace())
    exe2.run(startup, scope=scope2)
    jmain, jstartup, jloss, _, _ = _linear(jfluid)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstartup)
        for p in main.all_parameters():
            v = torch.from_numpy(np.array(jscope.find_var(p.name)))
            scope.set_var(p.name, v)
            scope2.set_var(p.name, v.clone())
        jl = [float(np.asarray(jexe.run(jmain, feed=b,
                                        fetch_list=[jloss])[0]).reshape(-1)[0])
              for b in batches]
    seen = []

    class Grab(logging.Handler):
        def emit(self, record):
            seen.append(record.args)

    h = Grab()
    logging.getLogger("paddle_tpu_torch.dataset").addHandler(h)
    logging.getLogger("paddle_tpu_torch.dataset").setLevel(logging.INFO)
    try:
        last = exe2.train_from_dataset(main, ds, scope2, thread=1,
                                       fetch_list=[loss], print_period=1)
    finally:
        logging.getLogger("paddle_tpu_torch.dataset").removeHandler(h)
    # exe.run over the same batches from the same parameters
    ref = [exe.run(main, feed=b, fetch_list=[loss], scope=scope)[0]
           for b in batches]
    assert last[0].tobytes() == ref[-1].tobytes()
    for p in main.all_parameters():
        assert torch.equal(scope.find_var(p.name), scope2.find_var(p.name))
    assert [a[0] for a in seen] == list(range(len(batches)))
    np.testing.assert_allclose([float(r.reshape(-1)[0]) for r in ref], jl,
                               rtol=LOSS_RTOL)


def test_queue_dataset_train(tmp_path):
    files = []
    for i in range(3):
        p = str(tmp_path / f"f{i}.txt")
        _write_multislot(p, n=40, seed=i)
        files.append(p)
    main, startup, loss, x, y = _linear(tfluid)
    ds = tdataset.DatasetFactory().create_dataset("QueueDataset")
    ds.set_batch_size(20)
    ds.set_thread(2)
    ds.set_filelist(files)
    ds.set_use_var([x, y])
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    res = exe.train_from_dataset(main, ds, scope, fetch_list=[loss])
    assert res is not None and np.isfinite(res[0]).all()
    res = exe.infer_from_dataset(main, ds, scope, fetch_list=[loss])
    assert res is not None
    with pytest.raises(ValueError, match="dataset is required"):
        exe.train_from_dataset(main, None, scope)


def _hogwild_data(path, rng, W, n=400):
    with open(path, "w") as f:
        for _ in range(n):
            xv = rng.randn(8)
            f.write("8 " + " ".join(f"{v:.6f}" for v in xv)
                    + f" 1 {float(xv @ W[:, 0]):.6f}\n")


@pytest.mark.parametrize("optimizer", ["sgd", "adam_fused"])
def test_hogwild_multithread_training(tmp_path, optimizer):
    """thread=4: every batch runs exactly once across the threads, and
    the shared parameters converge on a linear task. With the fused Adam
    op the update rewrites each parameter in place while other threads'
    steps hold it for their backward."""
    saved = tfluid.get_flags(["optimizer_fuse"])
    tfluid.set_flags({"optimizer_fuse": "on" if optimizer == "adam_fused"
                      else "off"})
    try:
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = startup.random_seed = 7
        with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
            x = tfluid.layers.data("x", [8])
            y = tfluid.layers.data("y", [1])
            pred = tfluid.layers.fc(x, 1, bias_attr=False)
            loss = tfluid.layers.mean(
                tfluid.layers.square_error_cost(pred, y))
            opt = (tfluid.optimizer.SGD(0.05) if optimizer == "sgd"
                   else tfluid.optimizer.Adam(0.05))
            opt.minimize(loss)
    finally:
        tfluid.set_flags(saved)
    rng = np.random.RandomState(3)
    W = rng.randn(8, 1).astype("float32")
    path = str(tmp_path / "data.txt")
    _hogwild_data(path, rng, W)
    ds = tdataset.InMemoryDataset()
    ds.set_batch_size(16)
    ds.set_use_var([x, y])
    ds.set_filelist([path])
    ds.load_into_memory()
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    epochs = 15
    for _ in range(epochs):
        exe.train_from_dataset(program=main, dataset=ds, scope=scope,
                               thread=4, fetch_list=[loss],
                               print_period=1000)
    runs = exe._hogwild_exe._run_counter
    assert runs == epochs * 25, runs      # 400 / 16 batches an epoch
    w = scope.get_numpy(next(n for n in scope.local_var_names()
                             if ".w_0" in n))
    assert np.abs(w - W).max() < 0.2, np.abs(w - W).max()


# -- the synthetic readers ----------------------------------------------------


READERS = [
    ("mnist", lambda m: m.mnist.train()),
    ("mnist_test", lambda m: m.mnist.test()),
    ("uci_housing", lambda m: m.uci_housing.train()),
    ("imdb", lambda m: m.imdb.train()),
    ("cifar", lambda m: m.cifar.train10()),
    ("wmt14", lambda m: m.wmt14.train(1000)),
    ("wmt16", lambda m: m.wmt16.validation(1000, 900)),
    ("movielens", lambda m: m.movielens.test()),
    ("conll05", lambda m: m.conll05.test()),
    ("imikolov_ngram", lambda m: m.imikolov.train(m.imikolov.build_dict(), 5)),
    ("imikolov_seq", lambda m: m.imikolov.test(
        None, 5, m.imikolov.DataType.SEQ)),
    ("sentiment", lambda m: m.sentiment.train()),
    ("flowers", lambda m: m.flowers.train()),
    ("flowers_valid", lambda m: m.flowers.valid()),
    ("voc2012", lambda m: m.voc2012.val()),
    ("mq2007_pairwise", lambda m: m.mq2007.train()),
    ("mq2007_listwise", lambda m: m.mq2007.test("listwise")),
]


def _same_sample(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_sample(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name,make", READERS, ids=[r[0] for r in READERS])
def test_synthetic_readers_equal_jax(name, make):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jr = jdatasets.common.firstn(make(jdatasets), 6)
        tdr = tdatasets.common.firstn(make(tdatasets), 6)
        a, b = list(tdr()), list(jr())
    assert len(a) == len(b) == 6
    for x, y in zip(a, b):
        _same_sample(x, y)


def test_synthetic_reader_warns_once_naming_the_port():
    tdatasets.common._synthetic_warned.discard("uci_housing")
    with pytest.warns(UserWarning, match="paddle_tpu_torch.datasets"):
        next(tdatasets.uci_housing.test()())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        next(tdatasets.uci_housing.test()())


def test_dataset_meta_helpers_equal_jax():
    assert tdatasets.movielens.max_user_id() == \
        jdatasets.movielens.max_user_id()
    assert tdatasets.movielens.movie_info() == jdatasets.movielens.movie_info()
    assert tdatasets.wmt16.get_dict("en", 50) == jdatasets.wmt16.get_dict(
        "en", 50)
    assert tdatasets.conll05.get_dict()[2] == jdatasets.conll05.get_dict()[2]
    np.testing.assert_array_equal(tdatasets.conll05.get_embedding(),
                                  jdatasets.conll05.get_embedding())


@pytest.mark.parametrize("deco", ["batch", "shuffle", "cache", "firstn",
                                  "map_readers", "io_batch"])
def test_reader_decorators_equal_jax(deco):
    def base():
        for i in range(11):
            yield (i, i * i)

    def apply(mod, io):
        if deco == "batch":
            return mod.batch(base, 4)
        if deco == "io_batch":
            return io.batch(base, 3, drop_last=True)
        if deco == "shuffle":
            return mod.shuffle(base, 4, seed=9)
        if deco == "cache":
            return mod.cache(base)
        if deco == "firstn":
            return mod.firstn(base, 5)
        return mod.map_readers(lambda a, b: a[0] + b[1], base, base)

    t = apply(tdatasets.common, tfluid.io)
    j = apply(jdatasets.common, jfluid.io)
    assert list(t()) == list(j())
    assert list(t()) == list(j())     # a second pass (shuffle draws anew)


# -- LoDTensor ----------------------------------------------------------------


LOD_CASES = [
    ("flat", lambda: np.arange(10, dtype="float32").reshape(10, 1),
     [[3, 1, 6]]),
    ("nested_list", lambda: [[[1], [2]], [[3]], [[4], [5], [6]]], [[2, 1, 3]]),
    ("padded", lambda: np.ones((3, 7, 2), "float32"), [[2, 7, 5]]),
    ("two_level", lambda: np.arange(6, dtype="int64").reshape(6, 1),
     [[2, 1], [1, 2, 3]]),
    ("all_ones", lambda: np.arange(4, dtype="float32").reshape(4, 1),
     [[1, 1, 1, 1]]),
    ("empty", lambda: np.zeros((0, 3), "float32"), [[]]),
]


@pytest.mark.parametrize("name,data,lens", LOD_CASES,
                         ids=[c[0] for c in LOD_CASES])
def test_create_lod_tensor_equals_jax(name, data, lens):
    t = tlod.create_lod_tensor(data(), lens, tfluid.CPUPlace())
    j = jlod.create_lod_tensor(data(), lens, None)
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    assert t.numpy().dtype == j.numpy().dtype
    assert t.lod() == j.lod()
    assert t.recursive_sequence_lengths() == j.recursive_sequence_lengths()
    assert t.has_valid_recursive_sequence_lengths() == \
        j.has_valid_recursive_sequence_lengths()
    if lens[-1]:
        np.testing.assert_array_equal(t.lengths(), j.lengths())
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def test_create_lod_tensor_refuses_mismatched_rows():
    with pytest.raises(ValueError, match="match neither"):
        tlod.create_lod_tensor(np.zeros((5, 1)), [[2, 2]])


def test_random_int_lodtensor_equals_jax():
    np.random.seed(4)
    t = tlod.create_random_int_lodtensor([[2, 3]], [1], low=0, high=9)
    np.random.seed(4)
    j = jlod.create_random_int_lodtensor([[2, 3]], [1], low=0, high=9)
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    assert t.shape == (2, 3, 1)
    t.set_recursive_sequence_lengths([[3, 2]])
    assert t.lod() == [[0, 3, 5]]


def test_lod_tensor_feeds_the_executor():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [4, 1], dtype="int64")
        out = tfluid.layers.scale(tfluid.layers.cast(x, "float32"), 2.0)
    t = tfluid.create_lod_tensor(np.arange(6).reshape(6, 1), [[2, 4]],
                                 tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    (r,) = exe.run(main, feed={"x": t}, fetch_list=[out])
    np.testing.assert_array_equal(r, 2.0 * t.numpy())


# -- metrics and WeightedAverage ----------------------------------------------


def _metric_updates(name, rng):
    preds = rng.rand(64, 2).astype("float32")
    labels = (rng.rand(64) > 0.5).astype("int64")
    if name in ("Precision", "Recall"):
        return [(np.rint(preds[:, 1]), labels)]
    if name == "Auc":
        return [(preds, labels), (preds[:10], labels[:10])]
    if name == "Accuracy":
        return [(0.5, 10), (0.75, 30)]
    if name == "EditDistance":
        return [(rng.randint(0, 3, 8).astype("float32"), 8)]
    if name == "ChunkEvaluator":
        return [(10, 12, 7), (np.array([3]), np.array([2]), np.array([2]))]
    return [(0.4, 2), (0.6, 1)]


@pytest.mark.parametrize("name", ["Precision", "Recall", "Accuracy", "Auc",
                                  "EditDistance", "ChunkEvaluator",
                                  "DetectionMAP"])
def test_metrics_equal_jax(name):
    t, j = getattr(tmetrics, name)(), getattr(jmetrics, name)()
    for args in _metric_updates(name, np.random.RandomState(5)):
        t.update(*args)
        j.update(*args)
    assert t.eval() == j.eval()
    assert sorted(t.get_config()) == sorted(j.get_config())
    t.reset()
    j.reset()
    if name in ("Accuracy", "EditDistance", "DetectionMAP"):
        with pytest.raises(ValueError):
            t.eval()


def test_composite_metric_equals_jax():
    out = []
    for mod in (tmetrics, jmetrics):
        c = mod.CompositeMetric()
        c.add_metric(mod.Precision())
        c.add_metric(mod.Recall())
        rng = np.random.RandomState(2)
        c.update(np.rint(rng.rand(40)), (rng.rand(40) > 0.3).astype("int64"))
        out.append(c.eval())
    assert out[0] == out[1]


def test_weighted_average_equals_jax():
    vals = [(1.0, 2), (np.array([3.0]), 1), (np.array([0.5, 1.5]), 4)]
    t, j = taverage.WeightedAverage(), javerage.WeightedAverage()
    for v, w in vals:
        t.add(v, w)
        j.add(v, w)
    assert t.eval() == j.eval()
    with pytest.raises(ValueError):
        t.add("x", 1)
    with pytest.raises(ValueError):
        t.add(1.0, np.array([1, 2]))
    t.reset()
    with pytest.raises(ValueError, match="empty"):
        t.eval()


# -- fs -----------------------------------------------------------------------


def test_local_fs_shell_helpers(tmp_path):
    fs = LocalFS()
    d = str(tmp_path / "a")
    fs.mkdirs(d)
    f = os.path.join(d, "f.txt")
    fs.touch(f)
    assert fs.is_file(f) and fs.is_dir(d) and not fs.is_dir(f)
    with pytest.raises(FSFileExistsError):
        fs.touch(f, exist_ok=False)
    with open(f, "w") as h:
        h.write("hello")
    assert fs.cat(f) == "hello"
    fs.mkdirs(os.path.join(d, "sub"))
    assert fs.ls_dir(d) == (["sub"], ["f.txt"])
    assert fs.list_dirs(d) == ["sub"]
    g = os.path.join(d, "g.txt")
    fs.mv(f, g)
    assert fs.is_file(g) and not fs.is_exist(f)
    fs.touch(f)
    with pytest.raises(FSFileExistsError):
        fs.mv(g, f)
    fs.mv(g, f, overwrite=True)
    with pytest.raises(FSFileNotExistsError):
        fs.rename(g, f)
    assert fs.need_upload_download() is False
    fs.delete(d)
    assert not fs.is_exist(d)


def test_hdfs_client_is_refused_by_name(tmp_path):
    """Ported (A11j): with no hadoop binary the client refuses each
    operation, naming the binary it lacks."""
    with pytest.raises(ExecuteError, match="hadoop binary not found"):
        HDFSClient(hadoop_home=str(tmp_path)).is_exist("/x")
