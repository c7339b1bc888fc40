"""The port's reader and overlapped step (``paddle_tpu_torch.reader``,
``Executor.run_pipelined``, ``data_feeder``, ``layers.py_reader``) held
to the JAX package's on the CPU: twins of ``tests/test_async_reader.py``
and ``tests/test_overlap.py``.

What the two packages share by construction is compared directly: the
batches a loader yields (values; the port keeps the dtypes its own
``Executor.run`` makes of a numpy feed, JAX casts int64 to int32 for
its device), rank sharding with the equalising wrap-around, the resume
position, the DataFeeder's arrays. Trajectories are held bit for bit
within the port (``run_pipelined`` against ``run``, a resumed
Supervisor against an uninterrupted one) and within 1e-5 (rtol) of the
JAX package's losses on the same seeded parameters: the two run
different float32 kernels (XLA:CPU against torch's), so their last bits
differ.
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.reader import GeneratorLoader as JLoader
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import observability, resilience
from paddle_tpu_torch.reader import DataLoader, GeneratorLoader

CPU = [tfluid.CPUPlace()]
FEEDER = "pt-dispatch-feeder"
PREFETCH = "pt-reader-prefetch"
# JAX's losses against the port's on the same parameters and feeds
LOSS_RTOL = 1e-5


def _threads(name):
    return [t for t in threading.enumerate() if t.name == name]


def _assert_no_thread_left(name, timeout=2.0):
    deadline = time.time() + timeout
    while _threads(name) and time.time() < deadline:
        time.sleep(0.01)
    assert not _threads(name), f"orphan {name} thread survived shutdown"


def _mlp(fluid, seed=7):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8])
        y = fluid.layers.data("y", [1], dtype="int64")
        h = fluid.layers.fc(x, 16, act="relu")
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(
                fluid.layers.fc(h, 4), y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss, x, y


def _batches(sizes, dtype="float32"):
    for i, b in enumerate(sizes):
        rng = np.random.RandomState(100 + i)
        yield {"x": rng.rand(b, 8).astype(dtype),
               "y": (rng.rand(b, 1) > 0.5).astype("int64")}


CHURN = [4, 4, 4, 6, 6, 4, 4, 8, 8, 8, 4, 6]


def _port_trainer(seed=7):
    main, startup, loss, x, y = _mlp(tfluid, seed)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    return main, loss, exe, scope, (x, y)


def _jax_params_into(scope, jscope, main):
    """The JAX scope's parameters into the port's scope (same names: both
    programs were built under one unique_name guard)."""
    for p in main.all_parameters():
        scope.set_var(p.name, torch.from_numpy(
            np.array(jscope.find_var(p.name))))


# -- the loader's batches against JAX's --------------------------------------


def _feed_vars(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", [2, 3])
        lbl = fluid.layers.data("lbl", [1], dtype="int64")
    return img, lbl


def _samples(n=10):
    def reader():
        for i in range(n):
            rng = np.random.RandomState(i)
            yield rng.rand(6).astype("float64"), i % 3
    return reader


def _as_np(batch):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


@pytest.mark.parametrize("mode", ["sample", "sample_list", "batch"])
@pytest.mark.parametrize("double_buffer", [True, False])
def test_loader_batches_equal_jax(mode, double_buffer):
    got = {}
    for name, fluid, Loader in (("jax", jfluid, JLoader),
                                ("port", tfluid, GeneratorLoader)):
        img, lbl = _feed_vars(fluid)
        loader = Loader([img, lbl], capacity=4,
                        use_double_buffer=double_buffer)
        places = CPU if name == "port" else None
        if mode == "sample":
            loader.set_sample_generator(_samples(), batch_size=4,
                                        drop_last=False, places=places)
        elif mode == "sample_list":
            loader.set_sample_list_generator(
                fluid.io.batch(_samples(), 3), places=places)
        else:
            def gen():
                for i in range(3):
                    yield [np.full((2, 2, 3), i, "float32"),
                           np.full((2, 1), i, "int64")]
            loader.set_batch_generator(gen, places=places)
        got[name] = [_as_np(b) for b in loader]
    assert len(got["jax"]) == len(got["port"]) > 0
    for j, p in zip(got["jax"], got["port"]):
        assert sorted(j) == sorted(p)
        for k in j:
            np.testing.assert_array_equal(p[k], j[k].astype(p[k].dtype))


def test_prefetched_batch_dtypes_are_what_run_makes():
    """float64 rows of a float32 variable arrive as float32, int64 labels
    stay int64, and a name no variable declares keeps its dtype unless
    it is float64: the tensors the port's exe.run makes of the same
    numpy feed."""
    img, lbl = _feed_vars(tfluid)
    loader = GeneratorLoader([img, lbl], capacity=2)
    loader.set_sample_generator(_samples(4), batch_size=2, places=CPU)
    b = next(iter(loader))
    assert b["img"].dtype == torch.float32 and b["img"].shape == (2, 2, 3)
    assert b["lbl"].dtype == torch.int64 and b["lbl"].shape == (2, 1)
    loose = GeneratorLoader([], capacity=2)
    loose.set_batch_generator(lambda: iter([{"a": np.zeros(2),
                                             "b": np.zeros(2, "int32")}]),
                              places=CPU)
    b = next(iter(loose))
    assert b["a"].dtype == torch.float32 and b["b"].dtype == torch.int32


def test_loader_without_places_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loader = DataLoader.from_generator(capacity=2)
    loader.set_batch_generator(lambda: iter([{"x": np.zeros(2)}]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(iter(loader))


def test_no_generator_set_raises():
    with pytest.raises(RuntimeError, match="no generator set"):
        next(iter(GeneratorLoader([])))


@pytest.mark.parametrize("n,world,batch,drop_last",
                         [(8, 2, 2, True), (7, 2, 2, True), (7, 2, 2, False),
                          (11, 3, 2, False), (5, 4, 1, True), (9, 1, 4, False)])
def test_rank_sharding_and_equalisation_equal_jax(n, world, batch, drop_last):
    def samples():
        for i in range(n):
            yield (np.array([i], "float32"),)

    got = {}
    for name, fluid, Loader in (("jax", jfluid, JLoader),
                                ("port", tfluid, GeneratorLoader)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", [1])
        got[name] = []
        for rank in range(world):
            loader = Loader([x], use_double_buffer=False, trainer_id=rank,
                            num_trainers=world)
            loader.set_sample_generator(samples, batch_size=batch,
                                        drop_last=drop_last)
            got[name].append([list(np.asarray(b["x"]).reshape(-1))
                              for b in loader])
    assert got["port"] == got["jax"]
    counts = {len(r) for r in got["port"]}
    if world > 1 and drop_last:
        assert len(counts) == 1, counts


def test_rank_defaults_from_the_launcher_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
    loader = GeneratorLoader([])
    assert loader.shard_info() == {"trainer_id": 2, "num_trainers": 3}
    assert JLoader([]).shard_info() == loader.shard_info()


@pytest.mark.parametrize("skip", [0, 1, 3, 5, 9])
@pytest.mark.parametrize("double_buffer", [True, False])
def test_resume_position_equals_jax(skip, double_buffer):
    def gen():
        for i in range(6):
            yield {"x": np.full((2, 3), i, "float32")}

    got, pos = {}, {}
    for name, Loader in (("jax", JLoader), ("port", GeneratorLoader)):
        loader = Loader([], use_double_buffer=double_buffer)
        loader.set_batch_generator(gen, places=CPU if name == "port"
                                   else None)
        loader.set_resume_position(skip)
        seen, positions = [], []
        for b in loader:
            seen.append(float(np.asarray(b["x"])[0, 0]))
            positions.append(loader.position())
        got[name], pos[name] = seen, positions
        assert loader.state_dict() == {"position": max(6, skip)}
    assert got["port"] == got["jax"] == [float(i) for i in range(skip, 6)]
    assert pos["port"] == pos["jax"]


def test_set_state_round_trip():
    loader = GeneratorLoader([], use_double_buffer=False)
    loader.set_batch_generator(lambda: ({"x": np.full(1, i)}
                                        for i in range(5)))
    it = iter(loader)
    next(it), next(it)
    state = loader.state_dict()
    assert state == {"position": 2}
    fresh = GeneratorLoader([], use_double_buffer=False)
    fresh.set_batch_generator(lambda: ({"x": np.full(1, i)}
                                       for i in range(5)))
    fresh.set_state(state)
    assert [int(b["x"][0]) for b in fresh] == [2, 3, 4]


def test_double_buffer_overlaps_producer_and_consumer():
    """With prefetch, an epoch takes about max(produce, consume) a batch,
    not the sum: compared with the serial run of the same workload in
    the same process (absolute bounds flake on a loaded box)."""
    n, delay = 6, 0.05

    def slow():
        for i in range(n):
            time.sleep(delay)
            yield {"x": np.full((2, 3), i, "float32")}

    def timed(double_buffer):
        loader = DataLoader.from_generator(capacity=4,
                                           use_double_buffer=double_buffer)
        loader.set_batch_generator(slow, places=CPU)
        t0 = time.perf_counter()
        seen = []
        for batch in loader:
            time.sleep(delay)
            seen.append(float(np.asarray(batch["x"])[0, 0]))
        assert seen == list(range(n))
        return time.perf_counter() - t0

    for _ in range(3):
        serial, overlapped = timed(False), timed(True)
        if overlapped < serial * 0.8:
            return
    assert overlapped < serial * 0.8, (overlapped, serial)


# -- error order and shutdown (twins of test_async_reader.py) ----------------


def test_worker_exception_propagates():
    def bad():
        yield {"x": np.zeros((1,), "float32")}
        raise RuntimeError("reader exploded")

    loader = DataLoader.from_generator(capacity=2)
    loader.set_batch_generator(bad, places=CPU)
    with pytest.raises(RuntimeError, match="reader exploded"):
        list(loader)
    _assert_no_thread_left(PREFETCH)


def test_worker_exception_before_first_batch():
    def bad():
        raise RuntimeError("boom at start")
        yield  # pragma: no cover — makes it a generator

    loader = DataLoader.from_generator(capacity=2)
    loader.set_batch_generator(bad, places=CPU)
    with pytest.raises(RuntimeError, match="boom at start"):
        next(iter(loader))


def test_worker_exception_fails_fast_over_buffered_batches():
    def bad():
        yield {"x": np.zeros((1,), "float32")}
        yield {"x": np.ones((1,), "float32")}
        raise RuntimeError("mid-epoch explosion")

    loader = DataLoader.from_generator(capacity=4)
    loader.set_batch_generator(bad, places=CPU)
    seen = []
    with pytest.raises(RuntimeError, match="mid-epoch explosion"):
        for b in loader:
            seen.append(float(np.asarray(b["x"])[0]))
            time.sleep(0.2)
    assert len(seen) <= 1, seen
    _assert_no_thread_left(PREFETCH)


def test_abandoned_epoch_stops_its_worker():
    """A consumer that stops mid-epoch (the generator closed) stops the
    prefetch thread and drops the staged batches: none stays parked on
    a full queue."""
    def endless():
        i = 0
        while True:
            yield {"x": np.full((2,), i, "float32")}
            i += 1

    loader = GeneratorLoader([], prefetch_depth=2)
    loader.set_batch_generator(endless, places=CPU)
    it = iter(loader)
    assert [float(next(it)["x"][0]) for _ in range(3)] == [0.0, 1.0, 2.0]
    it.close()
    _assert_no_thread_left(PREFETCH)
    assert loader._obs_queue.qsize() == 0


def test_reader_prefetch_depth_flag_and_explicit_arg():
    saved = {"reader_prefetch_depth":
             tfluid.flags.flag("reader_prefetch_depth")}

    def make(depth_arg=None):
        loader = GeneratorLoader(feed_list=[], prefetch_depth=depth_arg)
        loader.set_batch_generator(
            lambda: ({"x": np.zeros((2, 4), "float32")} for _ in range(6)),
            places=CPU)
        return loader

    try:
        tfluid.set_flags({"reader_prefetch_depth": 4})
        loader = make()
        assert sum(1 for _ in loader) == 6
        assert loader._active_depth == 4
        loader = make(depth_arg=1)
        assert sum(1 for _ in loader) == 6
        assert loader._active_depth == 1
        tfluid.set_flags({"reader_prefetch_depth": 0})
        loader = make()
        assert sum(1 for _ in loader) == 6
        assert loader._active_depth == 1
    finally:
        tfluid.set_flags(saved)


def test_reader_stall_counters_and_scrape():
    def make(producer_delay=0.0, n=8):
        def gen():
            for _ in range(n):
                if producer_delay:
                    time.sleep(producer_delay)
                yield {"x": np.zeros((2, 4), "float32")}

        loader = GeneratorLoader(feed_list=[], prefetch_depth=2)
        loader.set_batch_generator(gen, places=CPU)
        return loader

    loader = make()
    for _ in loader:
        time.sleep(0.02)
    assert loader._stall_full > 0
    loader2 = make(producer_delay=0.02)
    for _ in loader2:
        pass
    assert loader2._stall_empty > 0
    flat = " ".join(observability.snapshot()["collected"].keys())
    assert "paddle_reader_buffer_full_stall_total" in flat
    assert "paddle_reader_buffer_empty_stall_total" in flat


# -- the overlapped step (twins of test_overlap.py) --------------------------


def test_pipelined_bit_exact_and_ordered_vs_churny_sync():
    main, loss, exe, scope, _ = _port_trainer()
    sync = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
            for f in _batches(CHURN)]
    main2, loss2, exe2, scope2, _ = _port_trainer()
    piped = [o[0] for o in exe2.run_pipelined(main2, _batches(CHURN),
                                              [loss2], scope=scope2)]
    assert len(piped) == len(CHURN)
    for i, (a, b) in enumerate(zip(sync, piped)):
        assert a.tobytes() == b.tobytes(), f"step {i} diverged"
    for p in main.all_parameters():
        assert torch.equal(scope.find_var(p.name), scope2.find_var(p.name))
    _assert_no_thread_left(FEEDER)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipelined_over_a_loader_equals_run(depth):
    """A loader's prefetched tensors through run_pipelined give the
    losses and parameters of exe.run over the same numpy feeds, bit for
    bit, and reach the step as the tensors exe.run would make."""
    main, loss, exe, scope, (x, y) = _port_trainer()
    feeds = list(_batches([4] * 7, dtype="float64"))
    sync = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
            for f in feeds]
    main2, loss2, exe2, scope2, (x2, y2) = _port_trainer()
    loader = DataLoader.from_generator([x2, y2], capacity=4)
    loader.set_batch_generator(lambda: iter(feeds), places=CPU)
    piped = [o[0] for o in exe2.run_pipelined(main2, loader, [loss2],
                                              scope=scope2, depth=depth)]
    assert [a.tobytes() for a in sync] == [b.tobytes() for b in piped]
    for p in main.all_parameters():
        assert torch.equal(scope.find_var(p.name), scope2.find_var(p.name))


def test_pipelined_losses_match_jax():
    """The same MLP from JAX's initial parameters, the same feeds through
    JAX's run_pipelined and the port's: losses within LOSS_RTOL."""
    main, loss, exe, scope, _ = _port_trainer()
    jmain, jstartup, jloss, _, _ = _mlp(jfluid)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstartup)
        _jax_params_into(scope, jscope, main)
        jl = [float(np.asarray(o[0]).reshape(-1)[0])
              for o in jexe.run_pipelined(jmain, _batches(CHURN), [jloss])]
    tl = [float(o[0].reshape(-1)[0])
          for o in exe.run_pipelined(main, _batches(CHURN), [loss],
                                     scope=scope)]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]


def test_pipelined_matches_interleaved_plain_run():
    main, loss, exe, scope, _ = _port_trainer()
    ref = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
           for f in _batches([4] * 8)]
    main2, loss2, exe2, scope2, _ = _port_trainer()
    got = [o[0] for o in exe2.run_pipelined(main2, _batches([4] * 4),
                                            [loss2], scope=scope2)]
    for f in list(_batches([4] * 8))[4:]:
        got.append(exe2.run(main2, feed=f, fetch_list=[loss2],
                            scope=scope2)[0])
    assert [a.tobytes() for a in ref] == [a.tobytes() for a in got]


@pytest.mark.parametrize("where", ["iterable", "normalize"])
def test_feed_exception_propagates_in_order(where):
    """An error of the feed iterable, or of normalizing feed 3, surfaces
    after every earlier step's result; the feeder is reaped."""
    main, loss, exe, scope, _ = _port_trainer()

    def bad_feeds():
        yield from _batches([4, 4, 4])
        if where == "iterable":
            raise ValueError("boom at feed 3")
        yield {"x": np.zeros((4, 8), "float32"), "y": object()}

    got = []
    with pytest.raises((ValueError, TypeError)) as info:
        for outs in exe.run_pipelined(main, bad_feeds(), [loss],
                                      scope=scope):
            got.append(outs)
    if where == "iterable":
        assert "boom at feed 3" in str(info.value)
    assert len(got) == 3
    _assert_no_thread_left(FEEDER)


def test_clean_shutdown_mid_overlap():
    main, loss, exe, scope, _ = _port_trainer()

    def endless():
        i = 0
        while True:
            rng = np.random.RandomState(i)
            yield {"x": rng.rand(4, 8).astype("float32"),
                   "y": np.zeros((4, 1), "int64")}
            i += 1

    gen = exe.run_pipelined(main, endless(), [loss], scope=scope, depth=2)
    for n, _ in enumerate(gen):
        if n == 2:
            break
    gen.close()
    _assert_no_thread_left(FEEDER)
    assert sum(1 for _ in exe.run_pipelined(main, _batches([4] * 3), [loss],
                                            scope=scope)) == 3
    _assert_no_thread_left(FEEDER)


def test_overlap_telemetry_exported():
    from paddle_tpu_torch.observability.registry import overlap_telemetry

    before = overlap_telemetry().snapshot()
    main, loss, exe, scope, _ = _port_trainer()
    for _ in exe.run_pipelined(main, _batches([4] * 5), [loss],
                               scope=scope):
        pass
    after = overlap_telemetry().snapshot()
    assert after["steps"] >= before["steps"] + 5
    assert after["feed_ms_sum"] > before["feed_ms_sum"]
    assert 0.0 <= after["hidden_fraction"] <= 1.0
    flat = " ".join(observability.snapshot()["collected"].keys())
    assert "paddle_step_overlap_steps_total" in flat
    assert "paddle_step_overlap_hidden_fraction" in flat


def test_pipeline_depth_comes_from_the_flag():
    main, loss, exe, scope, _ = _port_trainer()
    saved = tfluid.get_flags(["dispatch_pipeline_depth"])
    try:
        tfluid.set_flags({"dispatch_pipeline_depth": 1})
        assert sum(1 for _ in exe.run_pipelined(
            main, _batches([4] * 3), [loss], scope=scope)) == 3
    finally:
        tfluid.set_flags(saved)


def test_set_flags_forces_a_rebind():
    main, loss, exe, scope, _ = _port_trainer()
    feed = next(_batches([4]))
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    misses = exe.cache_stats()["bound_misses"]
    g = tfluid.flags.generation()
    tfluid.set_flags({"reader_queue_speed_test_mode": False})
    assert tfluid.flags.generation() == g + 1
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert exe.cache_stats()["bound_misses"] == misses + 1
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert exe.cache_stats()["bound_misses"] == misses + 1


def test_run_accepts_a_resident_tensor_without_a_copy(monkeypatch):
    from paddle_tpu_torch.runtime.dispatch import BoundStep

    main, loss, exe, scope, _ = _port_trainer()
    seen = {}
    real = BoundStep._run_ordered

    def spy(self, ordered, *a):
        seen["x"] = ordered[0]
        return real(self, ordered, *a)

    monkeypatch.setattr(BoundStep, "_run_ordered", spy)
    t = torch.from_numpy(next(_batches([4]))["x"])
    exe.run(main, feed={"x": t, "y": np.zeros((4, 1), "int64")},
            fetch_list=[loss], scope=scope)
    assert seen["x"].data_ptr() == t.data_ptr()


def test_pipelined_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.Executor()


# -- the Supervisor over a loader ---------------------------------------------


def _sup_model(seed=41):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = seed
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [12])
        y = tfluid.layers.data("y", [1], dtype="int64")
        h = tfluid.layers.dropout(tfluid.layers.fc(x, 32, act="relu"),
                                  dropout_prob=0.1)
        loss = tfluid.layers.mean(tfluid.layers.softmax_with_cross_entropy(
            tfluid.layers.fc(h, 4), y))
        tfluid.optimizer.Adam(5e-3).minimize(loss)
    return main, startup, loss, x, y


def _sup_feed(step):
    rng = np.random.RandomState(10_000 + step)
    x = rng.randn(8, 12).astype("float32")
    return {"x": x, "y": (x[:, :1] > 0).astype("int64")}


def _sup_run(steps, ck, prefetch_depth=4):
    main, startup, loss, x, y = _sup_model()
    losses = {}
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    loader = GeneratorLoader([x, y], prefetch_depth=prefetch_depth)
    loader.set_batch_generator(lambda: (_sup_feed(s) for s in range(64)),
                               places=CPU)
    sup = resilience.Supervisor(
        exe, main, checkpoint_dir=ck, data=loader, fetch_list=[loss],
        scope=scope,
        policy=resilience.CheckpointPolicy(ck, every_steps=3, keep_last=3),
        on_step=lambda s, f: losses.__setitem__(
            s, np.asarray(f[0]).tobytes()))
    stats = sup.run_loop(steps, final_checkpoint=False)
    return losses, stats


def test_supervisor_resumes_a_loader_bitwise(tmp_path):
    """The loader prefetches past the step counter; the commit marker
    records the step counter, and a resumed run (the loader
    fast-forwarded by set_resume_position) equals the uninterrupted one
    bit for bit."""
    ref, _ = _sup_run(10, str(tmp_path / "ref"))
    ck = str(tmp_path / "ck")
    _, stats = _sup_run(7, ck)
    marker = tio.read_commit_marker(str(tmp_path / "ck" / "6"))
    assert marker["extra"]["reader_position"] == 6
    losses2, stats2 = _sup_run(10, ck)
    assert stats2["resumed_from"] == 6
    assert stats2["steps_completed"] == 4
    assert {s: ref[s] for s in losses2} == losses2
    _assert_no_thread_left(PREFETCH, timeout=5.0)


# -- DataFeeder and the py_reader layers -------------------------------------


def test_data_feeder_equals_jax():
    rows = [(np.arange(6, dtype="float64") + i, i % 3) for i in range(5)]
    out = {}
    for name, fluid in (("jax", jfluid), ("port", tfluid)):
        img, lbl = _feed_vars(fluid)
        feeder = fluid.DataFeeder([img, lbl], fluid.CPUPlace())
        out[name] = (feeder.feed(rows), feeder.feed_parallel(rows))
    for jd, pd in zip(out["jax"], out["port"]):
        assert sorted(jd) == sorted(pd)
        for k in jd:
            assert jd[k].dtype == pd[k].dtype and jd[k].shape == pd[k].shape
            np.testing.assert_array_equal(jd[k], pd[k])


def test_py_reader_and_read_file():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        reader = tfluid.layers.py_reader(
            capacity=4, shapes=[[-1, 3], [-1, 1]],
            dtypes=["float32", "int64"], name="r")
        a, b = tfluid.layers.read_file(reader)
        out = tfluid.layers.scale(a, scale=2.0)
        assert tfluid.layers.double_buffer(reader) is reader
        same = tfluid.layers.create_py_reader_by_data(4, [a, b])
    assert isinstance(reader, GeneratorLoader) and a.shape == (-1, 3)
    assert [v.name for v in same.feed_list] == [a.name, b.name]
    reader.set_sample_list_generator(
        lambda: iter([[(np.ones(3), 1), (np.zeros(3), 2)]]), places=CPU)
    exe = tfluid.Executor(tfluid.CPUPlace())
    (r,) = [o for o in exe.run_pipelined(main, reader, [out])][0]
    np.testing.assert_array_equal(r, [[2, 2, 2], [0, 0, 0]])
    with pytest.raises(TypeError):
        tfluid.layers.read_file(object())
