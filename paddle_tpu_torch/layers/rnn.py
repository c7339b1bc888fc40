"""RNN layers over dense padded batches: the port's copy of
``paddle_tpu/layers/rnn.py`` (reference layers/nn.py dynamic_lstm /
dynamic_gru, LoD-driven, and the beam layers). A dense [batch, time, d]
tensor with an optional length tensor replaces LoD raggedness (see
ops/rnn.py).
"""

from __future__ import annotations

from ..initializer import XavierInitializer
from ..layer_helper import LayerHelper
from .nn import _out

__all__ = ["dynamic_lstm", "dynamic_gru", "lstm_unit", "gru_unit",
           "beam_search", "beam_search_decode"]


def dynamic_lstm(
    input,
    size,
    h_0=None,
    c_0=None,
    param_attr=None,
    bias_attr=None,
    is_reverse=False,
    length=None,
    name=None,
):
    """input: [B, T, D]; size = hidden width H (reference dynamic_lstm's
    `size` is 4H for LoD input proj; here H directly, documented
    divergence for the dense API)."""
    helper = LayerHelper("fused_lstm", param_attr=param_attr, bias_attr=bias_attr, name=name)
    B, T, D = input.shape
    H = size
    wx = helper.create_parameter(helper.param_attr, [D, 4 * H], input.dtype,
                                 default_initializer=XavierInitializer())
    wh = helper.create_parameter(helper.param_attr, [H, 4 * H], input.dtype,
                                 default_initializer=XavierInitializer())
    bias = helper.create_parameter(helper.bias_attr, [4 * H], input.dtype, is_bias=True)
    hidden = _out(helper, input, shape=(B, T, H))
    cell = _out(helper, input, shape=(B, T, H))
    last_h = _out(helper, input, shape=(B, H))
    last_c = _out(helper, input, shape=(B, H))
    inputs = {"X": [input], "WeightX": [wx], "WeightH": [wh], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="fused_lstm",
        inputs=inputs,
        outputs={"Hidden": [hidden], "Cell": [cell], "LastH": [last_h], "LastC": [last_c]},
        attrs={"is_reverse": is_reverse},
    )
    return hidden, cell


def dynamic_gru(
    input,
    size,
    h_0=None,
    param_attr=None,
    bias_attr=None,
    is_reverse=False,
    length=None,
    name=None,
):
    helper = LayerHelper("fused_gru", param_attr=param_attr, bias_attr=bias_attr, name=name)
    B, T, D = input.shape
    H = size
    wx = helper.create_parameter(helper.param_attr, [D, 3 * H], input.dtype,
                                 default_initializer=XavierInitializer())
    wh = helper.create_parameter(helper.param_attr, [H, 3 * H], input.dtype,
                                 default_initializer=XavierInitializer())
    bias = helper.create_parameter(helper.bias_attr, [3 * H], input.dtype, is_bias=True)
    hidden = _out(helper, input, shape=(B, T, H))
    last_h = _out(helper, input, shape=(B, H))
    inputs = {"X": [input], "WeightX": [wx], "WeightH": [wh], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="fused_gru",
        inputs=inputs,
        outputs={"Hidden": [hidden], "LastH": [last_h]},
        attrs={"is_reverse": is_reverse},
    )
    return hidden


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0, param_attr=None,
              bias_attr=None, name=None):
    """Single step (reference layers/nn.py lstm_unit): x_t [B,D],
    states [B,H]."""
    from .nn import concat, fc

    helper = LayerHelper("lstm_unit_layer", name=name)
    H = hidden_t_prev.shape[-1]
    gates = fc(
        concat([x_t, hidden_t_prev], axis=1), 4 * H,
        param_attr=param_attr, bias_attr=bias_attr,
    )
    c = _out(helper, cell_t_prev, shape=cell_t_prev.shape)
    h = _out(helper, hidden_t_prev, shape=hidden_t_prev.shape)
    helper.append_op(
        type="lstm_unit",
        inputs={"X": [gates], "C_prev": [cell_t_prev]},
        outputs={"C": [c], "H": [h]},
        attrs={"forget_bias": forget_bias},
    )
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None, name=None):
    """Single step (reference layers/nn.py gru_unit): size = 3H."""
    helper = LayerHelper("gru_unit_layer", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    H = size // 3
    w = helper.create_parameter(helper.param_attr, [H, 3 * H], input.dtype)
    b = helper.create_parameter(helper.bias_attr, [3 * H], input.dtype, is_bias=True)
    gate = _out(helper, input, shape=(input.shape[0], 3 * H))
    rhp = _out(helper, hidden, shape=hidden.shape)
    h = _out(helper, hidden, shape=hidden.shape)
    helper.append_op(
        type="gru_unit",
        inputs={"Input": [input], "HiddenPrev": [hidden], "Weight": [w], "Bias": [b]},
        outputs={"Gate": [gate], "ResetHiddenPrev": [rhp], "Hidden": [h]},
    )
    return h, rhp, gate


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None, return_parent_idx=False):
    """One beam expansion step (reference layers API over
    beam_search_op.cc; see ops/beam.py for the dense [batch, beam]
    redesign). `ids` is accepted for API parity and unused — candidate
    ids are implicit [0, V)."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = _out(helper, pre_ids, shape=pre_ids.shape, dtype=pre_ids.dtype,
                   stop_gradient=True)
    sel_scores = _out(helper, pre_scores, shape=pre_scores.shape,
                      stop_gradient=True)
    parent = _out(helper, pre_ids, shape=pre_ids.shape, dtype="int32",
                  stop_gradient=True)
    inputs = {"pre_ids": [pre_ids], "pre_scores": [pre_scores], "scores": [scores]}
    if ids is not None:
        inputs["ids"] = [ids]
    helper.append_op(
        type="beam_search",
        inputs=inputs,
        outputs={"selected_ids": [sel_ids], "selected_scores": [sel_scores],
                 "parent_idx": [parent]},
        attrs={"beam_size": beam_size, "end_id": end_id, "level": level,
               "is_accumulated": is_accumulated},
    )
    if return_parent_idx:
        return sel_ids, sel_scores, parent
    return sel_ids, sel_scores


def beam_search_decode(ids, scores, beam_size, end_id, name=None,
                       parents=None, final_scores=None):
    """Backtrack stacked beam steps into sentences (reference
    beam_search_decode_op.cc). Dense form: `ids`/`parents` are the
    [T, B, beam] stacks of per-step beam_search outputs; `final_scores`
    the last step's [B, beam] scores (defaults to `scores`)."""
    helper = LayerHelper("beam_search_decode", name=name)
    if parents is None:
        raise ValueError(
            "beam_search_decode needs the stacked parent_idx steps: pass "
            "parents=<[T, B, beam] stack of beam_search parent_idx outputs> "
            "(the dense replacement for the reference's LoD parent levels)"
        )
    sent = _out(helper, ids, shape=None, dtype=ids.dtype, stop_gradient=True)
    sent_scores = _out(helper, scores, shape=None, stop_gradient=True)
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "Parents": [parents],
                "Scores": [final_scores if final_scores is not None else scores]},
        outputs={"SentenceIds": [sent], "SentenceScores": [sent_scores]},
        attrs={"beam_size": beam_size, "end_id": end_id},
    )
    return sent, sent_scores
