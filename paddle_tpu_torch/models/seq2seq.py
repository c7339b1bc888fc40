"""Attention seq2seq (the Fluid book's machine-translation model): the
port's copy of ``paddle_tpu/models/seq2seq.py``.

Reference: python/paddle/fluid/tests/book/test_machine_translation.py —
GRU encoder, attention decoder, trained with teacher forcing and
decoded with beam search (beam_search / beam_search_decode ops). The
training graph runs the encoder and the decoder as StaticRNNs (the
``recurrent`` op, ops/rnn.py); the inference path drives the same
decoder-step program through the beam ops, one Executor.run a step
(the reference's While-block decode, unrolled on the host)."""

from __future__ import annotations

import numpy as np

from .. import layers
from ..core.framework import Program, program_guard
from ..param_attr import ParamAttr


def _gru_step(x_and_prev, hidden_size, prefix):
    """One GRU cell step out of fc ops (shared by the training loop and the
    inference step program via identical param names). Inputs are
    pre-concatenated so one named weight serves the whole cell."""
    x, prev = x_and_prev
    xp = layers.concat([x, prev], axis=1)
    gates = layers.fc(
        xp, 2 * hidden_size, act="sigmoid",
        param_attr=ParamAttr(name=f"{prefix}_gates.w"),
        bias_attr=ParamAttr(name=f"{prefix}_gates.b"),
    )
    r, z = layers.split(gates, 2, dim=1)
    cand = layers.fc(
        layers.concat([x, layers.elementwise_mul(r, prev)], axis=1),
        hidden_size, act="tanh",
        param_attr=ParamAttr(name=f"{prefix}_cand.w"),
        bias_attr=ParamAttr(name=f"{prefix}_cand.b"),
    )
    one_minus_z = layers.scale(z, scale=-1.0, bias=1.0)
    return layers.elementwise_add(
        layers.elementwise_mul(one_minus_z, prev),
        layers.elementwise_mul(z, cand),
    )


def build_seq2seq(src_vocab: int, tgt_vocab: int, seq_len: int,
                  emb_dim: int = 32, hidden: int = 64, optimizer=None):
    """Teacher-forced training graph. Returns (main, startup, feeds,
    fetches)."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        src = layers.data("src", [seq_len], dtype="int64")
        tgt_in = layers.data("tgt_in", [seq_len], dtype="int64")
        tgt_out = layers.data("tgt_out", [seq_len], dtype="int64")

        src_emb = layers.embedding(
            src, size=[src_vocab, emb_dim],
            param_attr=ParamAttr(name="s2s_src_emb"),
        )  # [B, S, E]
        # encoder: a StaticRNN of the GRU cell, as the JAX build takes
        # (the JAX package has no dense dynamic_gru layer for it)
        from ..layers.control_flow import StaticRNN

        src_t = layers.transpose(src_emb, [1, 0, 2])  # [S, B, E]
        rnn = StaticRNN()
        with rnn.step():
            word = rnn.step_input(src_t)
            prev = rnn.memory(shape=[-1, hidden], batch_ref=word,
                              ref_batch_dim_idx=0)
            h = _gru_step((word, prev), hidden, "s2s_enc")
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        enc_states = rnn()  # [S, B, H]
        enc = layers.transpose(enc_states, [1, 0, 2])  # [B, S, H]

        tgt_emb = layers.embedding(
            tgt_in, size=[tgt_vocab, emb_dim],
            param_attr=ParamAttr(name="s2s_tgt_emb"),
        )
        from ..layers.control_flow import StaticRNN

        tgt_t = layers.transpose(tgt_emb, [1, 0, 2])
        dec = StaticRNN()
        with dec.step():
            word = dec.step_input(tgt_t)
            prev = dec.memory(shape=[-1, hidden], batch_ref=word,
                              ref_batch_dim_idx=0)
            ctx = _attention(prev, enc, hidden)
            inp = layers.concat([word, ctx], axis=1)
            h = _gru_step((inp, prev), hidden, "s2s_dec")
            dec.update_memory(prev, h)
            dec.step_output(h)
        dec_states = layers.transpose(dec(), [1, 0, 2])  # [B, S, H]
        logits = layers.fc(
            dec_states, tgt_vocab, num_flatten_dims=2,
            param_attr=ParamAttr(name="s2s_head.w"),
            bias_attr=ParamAttr(name="s2s_head.b"),
        )
        loss = layers.mean(
            layers.softmax_with_cross_entropy(
                logits, layers.unsqueeze(tgt_out, [2])
            )
        )
        if optimizer is not None:
            optimizer.minimize(loss)
    return main, startup, {"src": src, "tgt_in": tgt_in, "tgt_out": tgt_out}, {
        "loss": loss, "logits": logits, "encoder": enc,
    }


def _attention(query, enc, hidden):
    """Additive attention: scores = v' tanh(W [h; enc_t])."""
    q_proj = layers.fc(
        query, hidden, bias_attr=False,
        param_attr=ParamAttr(name="s2s_att_q.w"),
    )  # [B, H]
    e_proj = layers.fc(
        enc, hidden, num_flatten_dims=2, bias_attr=False,
        param_attr=ParamAttr(name="s2s_att_e.w"),
    )  # [B, S, H]
    mix = layers.tanh(
        layers.elementwise_add(e_proj, layers.unsqueeze(q_proj, [1]))
    )
    scores = layers.fc(
        mix, 1, num_flatten_dims=2, bias_attr=False,
        param_attr=ParamAttr(name="s2s_att_v.w"),
    )  # [B, S, 1]
    w = layers.softmax(layers.squeeze(scores, [2]))  # [B, S]
    return layers.squeeze(
        layers.matmul(layers.unsqueeze(w, [1]), enc), [1]
    )  # [B, H]


def build_decoder_step(src_vocab: int, tgt_vocab: int, seq_len: int,
                       emb_dim: int = 32, hidden: int = 64):
    """One decoder step + beam expansion as its own program (the
    reference's While-block body). Feeds: enc [B, S, H] (from the
    training/encoder program), prev_hidden [B*beam, H], pre_ids,
    pre_scores [B, beam]. Startup shares param NAMES with the training
    program, so load the trained scope."""
    main = Program()
    startup = Program()
    with program_guard(main, startup):
        enc = layers.data("enc", [seq_len, hidden], dtype="float32")
        prev_h = layers.data("prev_h", [hidden], dtype="float32")
        cur_ids = layers.data("cur_ids", [1], dtype="int64")
        # embedding over [B*beam, 1] ids flattens to [B*beam, E]
        word = layers.embedding(
            cur_ids, size=[tgt_vocab, emb_dim],
            param_attr=ParamAttr(name="s2s_tgt_emb"),
        )
        ctx = _attention(prev_h, enc, hidden)
        inp = layers.concat([word, ctx], axis=1)
        h = _gru_step((inp, prev_h), hidden, "s2s_dec")
        logits = layers.fc(
            h, tgt_vocab,
            param_attr=ParamAttr(name="s2s_head.w"),
            bias_attr=ParamAttr(name="s2s_head.b"),
        )
        logp = layers.log_softmax(logits)
    return main, startup, {
        "enc": enc, "prev_h": prev_h, "cur_ids": cur_ids,
    }, {"logp": logp, "h": h}


def beam_search_infer(exe, scope, enc_value, step_prog,
                      step_fetches, beam_size, bos_id, eos_id, max_len,
                      hidden, on_step=None):
    """Host-driven beam decode over the step program (reference's
    While + beam_search ops): each iteration runs the decoder step for
    all B*beam hypotheses, expands with the beam_search op, reorders
    hidden states by parent_idx, and finally backtracks with
    beam_search_decode. ``on_step(t, logp, acc, sel_ids, parents)``,
    when given, sees each step's log-probabilities [B·beam, V], the
    accumulated candidate scores [B, beam, V] and the selection."""
    B = enc_value.shape[0]
    cur = np.full((B, beam_size), bos_id, "int64")
    scores = np.zeros((B, beam_size), "float32")
    scores[:, 1:] = -1e9  # first step: one live hypothesis
    h = np.zeros((B * beam_size, hidden), "float32")
    enc_tiled = np.repeat(enc_value, beam_size, axis=0)
    all_ids, all_parents = [], []
    for _ in range(max_len):
        logp, h_new = exe.run(
            step_prog,
            feed={"enc": enc_tiled, "prev_h": h,
                  "cur_ids": cur.reshape(-1, 1)},
            fetch_list=[step_fetches["logp"], step_fetches["h"]],
            scope=scope,
        )
        V = logp.shape[-1]
        acc = scores[..., None] + logp.reshape(B, beam_size, V)
        sel_ids, sel_scores, parents = _beam_step(
            exe, cur, scores, acc, beam_size, eos_id
        )
        if on_step is not None:
            on_step(len(all_ids), logp, acc, sel_ids, parents)
        all_ids.append(sel_ids)
        all_parents.append(parents)
        # reorder hidden by parent beam
        h = h_new.reshape(B, beam_size, hidden)[
            np.arange(B)[:, None], parents
        ].reshape(B * beam_size, hidden)
        cur, scores = sel_ids.astype("int64"), sel_scores
    return _beam_decode(exe, np.stack(all_ids).astype("int32"),
                        np.stack(all_parents).astype("int32"),
                        scores, beam_size, eos_id)


_BEAM_PROG_CACHE = {}


def _beam_step(exe, pre_ids, pre_scores, acc, beam_size, eos_id):
    # one program per (shape, beam, eos): rebuilt programs would force a
    # fresh lowering every decode step
    ck = ("step", pre_ids.shape, acc.shape, beam_size, eos_id)
    if ck in _BEAM_PROG_CACHE:
        main, outs = _BEAM_PROG_CACHE[ck]
        return tuple(exe.run(main, feed={
            "bs_pre_ids": pre_ids.astype("int32"),
            "bs_pre_scores": pre_scores, "bs_scores": acc,
        }, fetch_list=outs))
    main, startup = Program(), Program()
    with program_guard(main, startup):
        blk = main.global_block()
        mk = lambda n, a: (blk.create_var(name=n, shape=a.shape,
                                          dtype=str(a.dtype), is_data=True))
        pi = mk("bs_pre_ids", pre_ids.astype("int32"))
        ps = mk("bs_pre_scores", pre_scores)
        sc = mk("bs_scores", acc)
        outs = [blk.create_var(name=f"bs_o{i}") for i in range(3)]
        blk.append_op(
            type="beam_search",
            inputs={"pre_ids": [pi], "pre_scores": [ps], "scores": [sc]},
            outputs={"selected_ids": [outs[0]], "selected_scores": [outs[1]],
                     "parent_idx": [outs[2]]},
            attrs={"beam_size": beam_size, "end_id": eos_id,
                   "is_accumulated": True},
        )
    _BEAM_PROG_CACHE[ck] = (main, outs)
    return tuple(exe.run(main, feed={
        "bs_pre_ids": pre_ids.astype("int32"),
        "bs_pre_scores": pre_scores, "bs_scores": acc,
    }, fetch_list=outs))


def _beam_decode(exe, ids, parents, final_scores, beam_size, eos_id):
    main, startup = Program(), Program()
    with program_guard(main, startup):
        blk = main.global_block()
        mk = lambda n, a: blk.create_var(name=n, shape=a.shape,
                                         dtype=str(a.dtype), is_data=True)
        iv = mk("bd_ids", ids)
        pv = mk("bd_parents", parents)
        sv = mk("bd_scores", final_scores)
        s_out = blk.create_var(name="bd_sent")
        sc_out = blk.create_var(name="bd_sent_scores")
        blk.append_op(
            type="beam_search_decode",
            inputs={"Ids": [iv], "Parents": [pv], "Scores": [sv]},
            outputs={"SentenceIds": [s_out], "SentenceScores": [sc_out]},
            attrs={"beam_size": beam_size, "end_id": eos_id},
        )
    return tuple(exe.run(main, feed={
        "bd_ids": ids, "bd_parents": parents, "bd_scores": final_scores,
    }, fetch_list=[s_out, sc_out]))
