"""The attention seq2seq (``models/seq2seq.py``), the beam ops, the
contrib ``BeamSearchDecoder`` and the book's sequence models in the
port against the JAX package, on the CPU.

* seq2seq (the copy task of tests/test_models_gpt_seq2seq.py) trained 4
  Adam steps from JAX's startup values: losses and every parameter at
  rtol 1e-4 / atol 1e-5; then ``beam_search_infer`` from the same
  trained parameters gives JAX's sentences exactly and JAX's scores at
  rtol 1e-5.
* ``beam_search`` keeps ``jax.lax.top_k``'s order among ties (the lower
  flat index first), with finished beams, whose ``NEG_INF`` rows tie;
  ``beam_search_decode`` backtracks as JAX does.
* ``BeamSearchDecoder`` (twin of tests/test_convenience_surface.py::
  test_beam_search_decoder_produces_translations) from JAX's startup
  values gives JAX's translations.
* Twins of tests/test_book.py::test_book_understand_sentiment_lstm and
  ::test_book_label_semantic_roles_crf: 5 steps from JAX's startup
  values against JAX, then the book's own training run and gates in
  the port.
* A JAX-saved inference directory holding the seq2seq encoder (its
  ``recurrent`` op with the step sub-block) served by the port's
  ``create_predictor`` gives JAX's encoder states; one the port saves
  serves back its own states bit for bit.
"""

import numpy as np

import paddle_tpu as jfluid
from paddle_tpu.core.framework import unique_name as jax_unique_name

import paddle_tpu_torch as fluid
from paddle_tpu_torch.io import load_scope_arrays
from test_torch_activations import both
from test_torch_rnn import assert_trained_alike, check_split, train_both

V, S, H, E = 12, 6, 16, 8
BOS, EOS = 0, 1


def _names(pkg):
    return jax_unique_name if pkg is jfluid else fluid.unique_name


def _s2s(pkg):
    from importlib import import_module

    return import_module(pkg.__name__ + ".models.seq2seq")


def copy_batch(rng, n):
    src = rng.randint(2, V, (n, S)).astype(np.int64)
    tgt_in = np.concatenate([np.full((n, 1), BOS, np.int64), src[:, :-1]], 1)
    return {"src": src, "tgt_in": tgt_in, "tgt_out": src}


def test_seq2seq_trains_like_jax_and_beam_decodes_to_jax_sentences():
    rng = np.random.RandomState(1)
    batches = [copy_batch(rng, 8) for _ in range(4)]

    def build(pkg):
        main, startup, _, fetches = _s2s(pkg).build_seq2seq(
            V, V, S, emb_dim=E, hidden=H,
            optimizer=pkg.optimizer.Adam(5e-3))
        return fetches["loss"], [], main, startup

    res = train_both(build, batches)
    assert_trained_alike(res)
    trained = res["jax"][1]
    src = copy_batch(rng, 3)

    sents = {}
    for pkg in (jfluid, fluid):
        with _names(pkg).guard():
            main, startup, _, fetches = _s2s(pkg).build_seq2seq(
                V, V, S, emb_dim=E, hidden=H)
        with _names(pkg).guard():
            step, _, _, step_fetches = _s2s(pkg).build_decoder_step(
                V, V, S, emb_dim=E, hidden=H)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        if pkg is jfluid:
            with jfluid.scope_guard(scope):
                exe.run(startup)
                for n, v in trained.items():
                    if main.global_block().has_var(n):
                        scope.set_var(n, v)
                enc, = exe.run(main, feed=src, fetch_list=[fetches["encoder"]])
        else:
            exe.run(startup, scope=scope)
            load_scope_arrays(scope, {n: v for n, v in trained.items()
                                      if main.global_block().has_var(n)},
                              main, "cpu")
            enc, = exe.run(main, feed=src, fetch_list=[fetches["encoder"]],
                           scope=scope)
        sents[pkg] = _s2s(pkg).beam_search_infer(
            exe, scope, np.asarray(enc), step, step_fetches, beam_size=3,
            bos_id=BOS, eos_id=EOS, max_len=S, hidden=H)
    (js, jsc), (ts, tsc) = sents[jfluid], sents[fluid]
    np.testing.assert_array_equal(np.asarray(ts), np.asarray(js))
    np.testing.assert_allclose(np.asarray(tsc), np.asarray(jsc), rtol=1e-5,
                               atol=1e-5)


def _beam_ins():
    """Two rows, beam 3, V 4: row 0 has a finished beam (end_id 1) and
    equal candidate scores; row 1 is all ties."""
    pre_ids = np.array([[1, 2, 3], [0, 0, 0]], np.int64)
    pre_scores = np.array([[-0.5, -1.0, -1.0], [0.0, 0.0, 0.0]], np.float32)
    scores = np.array([
        [[-2.0, -0.5, -1.0, -3.0], [-1.5, -1.5, -1.0, -1.5],
         [-1.5, -1.0, -1.5, -1.0]],
        [[-1.0] * 4, [-1.0] * 4, [-1.0] * 4]], np.float32)
    return {"pre_ids": pre_ids, "pre_scores": pre_scores, "scores": scores}


def test_beam_search_keeps_jax_tie_order():
    j, t = both("beam_search", _beam_ins(),
                {"beam_size": 3, "end_id": 1, "is_accumulated": True},
                {"selected_ids": 1, "selected_scores": 1, "parent_idx": 1})
    check_split(j, t)
    # row 1 is all ties: the lowest flat indices win, in order
    np.testing.assert_array_equal(t["o_parent_idx_0"][1], [0, 0, 0])
    np.testing.assert_array_equal(t["o_selected_ids_0"][1], [0, 1, 2])


def test_top_k_tie_rule_equals_lax_top_k():
    import jax

    from paddle_tpu_torch.ops.beam import top_k_lower_index_first

    import torch

    rng = np.random.RandomState(3)
    x = rng.randint(-3, 3, (6, 40)).astype(np.float32)
    x[:, ::7] = -1e9
    jv, ji = jax.lax.top_k(x, 9)
    tv, ti = top_k_lower_index_first(torch.from_numpy(x), 9)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_beam_search_not_accumulated_and_decode():
    ins = _beam_ins()
    j, t = both("beam_search", ins,
                {"beam_size": 2, "end_id": 1, "is_accumulated": False},
                {"selected_ids": 1, "selected_scores": 1, "parent_idx": 1})
    check_split(j, t)
    rng = np.random.RandomState(4)
    dec = {"Ids": rng.randint(0, 5, (4, 2, 3)).astype(np.int64),
           "Parents": rng.randint(0, 3, (4, 2, 3)).astype(np.int32),
           "Scores": rng.randn(2, 3).astype(np.float32)}
    j, t = both("beam_search_decode", dec, {"beam_size": 3, "end_id": 1},
                {"SentenceIds": 1, "SentenceScores": 1})
    check_split(j, t)


def _decoder(pkg, beam=3, max_len=4, Vd=12, Ed=6, Hd=8):
    from importlib import import_module

    d = import_module(pkg.__name__ + ".contrib.decoder")
    L = pkg.layers
    init_ids = L.data("init_ids", [beam], dtype="int64")
    init_scores = L.data("init_scores", [beam])
    boot = L.data("boot_h", [Hd])
    big = L.reshape(L.expand(L.unsqueeze(boot, [1]), [1, beam, 1]), [-1, Hd])
    cell = d.StateCell(inputs={"x": None},
                       states={"h": d.InitState(init=big)}, out_state="h")

    @cell.state_updater
    def updater(cell):
        nh = L.fc(L.concat([cell.get_input("x"), cell.get_state("h")],
                           axis=1), Hd, act="tanh",
                  param_attr=pkg.ParamAttr(name="bsd_cell.w"),
                  bias_attr=pkg.ParamAttr(name="bsd_cell.b"))
        cell.set_state("h", nh)

    decoder = d.BeamSearchDecoder(
        cell, init_ids, init_scores, target_dict_dim=Vd, word_dim=Ed,
        max_len=max_len, beam_size=beam, end_id=1,
        word_emb_param_name="bsd_emb")
    decoder.decode()
    return decoder()


def test_beam_search_decoder_gives_jax_translations():
    beam, B = 3, 2
    ids0 = np.zeros((B, beam), np.int64)
    sc0 = np.full((B, beam), -1e9, np.float32)
    sc0[:, 0] = 0.0
    feed = {"init_ids": ids0, "init_scores": sc0,
            "boot_h": np.random.RandomState(0).randn(B, 8).astype(
                np.float32)}

    def build(pkg):
        ids, scores = _decoder(pkg, beam)
        return scores, [ids]

    res = train_both(build, [feed])
    jl, _, je = res["jax"]
    tl, _, te = res["port"]
    np.testing.assert_array_equal(te[0][0], je[0][0])
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)


# -- the book's sequence models --------------------------------------------------


def _sentiment(pkg, vocab=40, T=12, emb_dim=16, Hs=24, lr=5e-3):
    L = pkg.layers
    x = L.data("x", [T, 1], dtype="int64")
    y = L.data("y", [1], dtype="int64")
    emb = L.embedding(x, size=[vocab, emb_dim])
    fc = L.fc(emb, Hs, num_flatten_dims=2)
    hidden, _ = L.dynamic_lstm(fc, Hs)
    pooled = L.sequence_pool(hidden, pool_type="max")
    logits = L.fc(pooled, 2)
    loss = L.mean(L.softmax_with_cross_entropy(logits, y))
    acc = L.accuracy(L.softmax(logits), y)
    pkg.optimizer.Adam(lr).minimize(loss)
    return loss, [acc]


def _sentiment_batch(rng, n=32, vocab=40, T=12):
    t = rng.randint(0, vocab, (n, T, 1)).astype(np.int64)
    lab = np.sum(t[:, :, 0] < vocab // 2, axis=1) > T // 2
    return {"x": t, "y": lab.astype(np.int64)[:, None]}


def test_book_understand_sentiment_lstm_matches_jax_and_learns():
    rng = np.random.RandomState(3)
    res = train_both(_sentiment, [_sentiment_batch(rng) for _ in range(5)])
    assert_trained_alike(res)
    # the book test's own run and gates, in the port
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, (acc,) = _sentiment(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(3)
    first = None
    for _ in range(120):
        l, a = exe.run(main, feed=_sentiment_batch(rng), fetch_list=[loss, acc],
                       scope=scope)
        first = float(l) if first is None else first
    assert float(l) < 0.45 < first, (first, float(l))
    assert float(a) > 0.8, float(a)


def _srl(pkg, vocab=30, T=10, C=6, emb_dim=16):
    L = pkg.layers
    x = L.data("x", [T, 1], dtype="int64")
    lbl = L.data("lbl", [T], dtype="int64")
    emb = L.embedding(x, size=[vocab, emb_dim])
    emission = L.fc(emb, C, num_flatten_dims=2)
    trans = L.create_parameter([C + 2, C], "float32", name="crfw")
    *_, nll = L.linear_chain_crf(emission, lbl, trans)
    path = L.crf_decoding(emission, trans)
    loss = L.mean(nll)
    pkg.optimizer.Adam(1e-2).minimize(loss)
    return loss, [path]


def _srl_batch(rng, n=24, vocab=30, T=10, C=6):
    t = rng.randint(0, vocab, (n, T, 1)).astype(np.int64)
    return {"x": t, "lbl": ((t[:, :, 0] + 1) % C).astype(np.int64)}


def test_book_label_semantic_roles_crf_matches_jax_and_learns():
    rng = np.random.RandomState(4)
    res = train_both(_srl, [_srl_batch(rng) for _ in range(5)])
    assert_trained_alike(res)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, (path,) = _srl(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(4)
    first = None
    for _ in range(150):
        l, = exe.run(main, feed=_srl_batch(rng), fetch_list=[loss],
                     scope=scope)
        first = float(l) if first is None else first
    assert float(l) < first * 0.3, (first, float(l))
    fd = _srl_batch(rng, 32)
    # decode with the trained weights, without a training step
    infer = main.clone(for_test=True)
    got, = exe.run(infer, feed=fd, fetch_list=[path.name], scope=scope)
    assert float(np.mean(np.asarray(got) == fd["lbl"])) > 0.9


def test_jax_saved_seq2seq_encoder_serves_through_create_predictor(tmp_path):
    from paddle_tpu_torch.inference.predictor import Config, create_predictor

    with jax_unique_name.guard():
        main, startup, feeds, fetches = _s2s(jfluid).build_seq2seq(
            V, V, S, emb_dim=E, hidden=H)
    src = copy_batch(np.random.RandomState(5), 4)["src"]
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        want, = exe.run(main, feed={"src": src, "tgt_in": src,
                                    "tgt_out": src},
                        fetch_list=[fetches["encoder"]])
        jfluid.io.save_inference_model(str(tmp_path / "enc"), ["src"],
                                       [fetches["encoder"]], exe, main)
    pred = create_predictor(Config(str(tmp_path / "enc")), device="cpu")
    got = pred.run([src])[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_port_saved_seq2seq_encoder_round_trips(tmp_path):
    """The port writes the ``recurrent`` op with its step sub-block into
    an inference directory and serves it back with the same states."""
    from paddle_tpu_torch.inference.predictor import Config, create_predictor

    with fluid.unique_name.guard():
        main, startup, _, fetches = _s2s(fluid).build_seq2seq(
            V, V, S, emb_dim=E, hidden=H)
    src = copy_batch(np.random.RandomState(6), 3)["src"]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    want, = exe.run(main, feed={"src": src, "tgt_in": src, "tgt_out": src},
                    fetch_list=[fetches["encoder"]], scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(str(tmp_path / "enc"), ["src"],
                                      [fetches["encoder"]], exe, main)
    got = create_predictor(Config(str(tmp_path / "enc")),
                           device="cpu").run([src])[0]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
