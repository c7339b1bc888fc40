"""Contrib RNN stacks and cells: the port's copy of
``paddle_tpu/contrib/layers/rnn_impl.py`` (reference
python/paddle/fluid/contrib/layers/rnn_impl.py: BasicGRUUnit:25,
basic_gru:164, basic_lstm:405, BasicLSTMUnit:699).

Each (layer, direction) of ``basic_gru`` / ``basic_lstm`` is one
``fused_gru`` / ``fused_lstm`` op over the precomputed input
projections, as in the JAX package. ``BasicGRUUnit`` and
``BasicLSTMUnit`` are the JAX package's dygraph cells; the port has no
dygraph, so they are ``torch.nn.Module``s over tensors, their
parameters made at the first call (Xavier-uniform weights, zero
biases) as the JAX cells make theirs.
"""

from __future__ import annotations

import numpy as np
import torch

from ...layer_helper import LayerHelper
from ...layers.nn import _out
from ...layers import concat, dropout as _dropout, reshape, stack
from ...initializer import XavierInitializer, NumpyArrayInitializer

__all__ = ["BasicGRUUnit", "basic_gru", "basic_lstm", "BasicLSTMUnit"]


def _lstm_pass(x, hidden_size, h0, c0, is_reverse, length, forget_bias,
               dtype, name):
    helper = LayerHelper(name or "basic_lstm")
    B, T, D = x.shape
    H = hidden_size
    wx = helper.create_parameter(None, [D, 4 * H], dtype,
                                 default_initializer=XavierInitializer())
    wh = helper.create_parameter(None, [H, 4 * H], dtype,
                                 default_initializer=XavierInitializer())
    # fused_lstm has no forget_bias attr: fold it into the f-gate slice
    # of the bias (gate order i, f, g, o — ops/rnn.py fused_lstm)
    binit = np.zeros(4 * H, dtype)
    binit[H:2 * H] = forget_bias
    bias = helper.create_parameter(
        None, [4 * H], dtype, is_bias=True,
        default_initializer=NumpyArrayInitializer(binit))
    hidden = _out(helper, x, shape=(B, T, H))
    cell = _out(helper, x, shape=(B, T, H))
    last_h = _out(helper, x, shape=(B, H))
    last_c = _out(helper, x, shape=(B, H))
    inputs = {"X": [x], "WeightX": [wx], "WeightH": [wh], "Bias": [bias]}
    if h0 is not None:
        inputs["H0"] = [h0]
    if c0 is not None:
        inputs["C0"] = [c0]
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="fused_lstm", inputs=inputs,
        outputs={"Hidden": [hidden], "Cell": [cell], "LastH": [last_h],
                 "LastC": [last_c]},
        attrs={"is_reverse": is_reverse},
    )
    return hidden, last_h, last_c


def _gru_pass(x, hidden_size, h0, is_reverse, length, dtype, name):
    helper = LayerHelper(name or "basic_gru")
    B, T, D = x.shape
    H = hidden_size
    wx = helper.create_parameter(None, [D, 3 * H], dtype,
                                 default_initializer=XavierInitializer())
    wh = helper.create_parameter(None, [H, 3 * H], dtype,
                                 default_initializer=XavierInitializer())
    bias = helper.create_parameter(
        None, [3 * H], dtype, is_bias=True,
        default_initializer=NumpyArrayInitializer(np.zeros(3 * H, dtype)))
    hidden = _out(helper, x, shape=(B, T, H))
    last_h = _out(helper, x, shape=(B, H))
    inputs = {"X": [x], "WeightX": [wx], "WeightH": [wh], "Bias": [bias]}
    if h0 is not None:
        inputs["H0"] = [h0]
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="fused_gru", inputs=inputs,
        outputs={"Hidden": [hidden], "LastH": [last_h]},
        # origin_mode: h = u*h_prev + (1-u)*c — the convention the
        # reference contrib BasicGRUUnit (rnn_impl.py:25) uses, unlike
        # the C++ gru ops' default
        attrs={"is_reverse": is_reverse, "origin_mode": True},
    )
    return hidden, last_h


def _layer_init(init, layer, direction, num_dirs, B, H):
    """Slice [num_layers*dirs, B, H] init state for one pass."""
    if init is None:
        return None
    from ...layers import slice as _slice

    i = layer * num_dirs + direction
    return reshape(_slice(init, axes=[0], starts=[i], ends=[i + 1]),
                   [B, H])


def basic_gru(input, init_hidden, hidden_size, num_layers=1,
              sequence_length=None, dropout_prob=0.0, bidirectional=False,
              batch_first=True, param_attr=None, bias_attr=None,
              gate_activation=None, activation=None, dtype="float32",
              name="basic_gru"):
    """Reference contrib/layers/rnn_impl.py:164. Returns
    (rnn_out [B,T,H*dirs], last_hidden [num_layers*dirs, B, H])."""
    if gate_activation not in (None, "sigmoid") or activation not in (
            None, "tanh"):
        raise NotImplementedError(
            "basic_gru: only sigmoid/tanh activations are lowered")
    if not batch_first:
        from ...layers import transpose

        input = transpose(input, [1, 0, 2])
    B = input.shape[0]
    dirs = 2 if bidirectional else 1
    x = input
    lasts = []
    for layer in range(num_layers):
        fwd, fwd_last = _gru_pass(
            x, hidden_size, _layer_init(init_hidden, layer, 0, dirs, B,
                                        hidden_size),
            False, sequence_length, dtype, f"{name}_l{layer}_fw")
        if bidirectional:
            bwd, bwd_last = _gru_pass(
                x, hidden_size, _layer_init(init_hidden, layer, 1, dirs, B,
                                            hidden_size),
                True, sequence_length, dtype, f"{name}_l{layer}_bw")
            x = concat([fwd, bwd], axis=2)
            lasts.extend([fwd_last, bwd_last])
        else:
            x = fwd
            lasts.append(fwd_last)
        if dropout_prob and layer < num_layers - 1:
            x = _dropout(x, dropout_prob,
                         dropout_implementation="upscale_in_train")
    last_hidden = stack(lasts, axis=0)
    if not batch_first:
        from ...layers import transpose

        x = transpose(x, [1, 0, 2])
    return x, last_hidden


def basic_lstm(input, init_hidden, init_cell, hidden_size, num_layers=1,
               sequence_length=None, dropout_prob=0.0, bidirectional=False,
               batch_first=True, param_attr=None, bias_attr=None,
               gate_activation=None, activation=None, forget_bias=1.0,
               dtype="float32", name="basic_lstm"):
    """Reference contrib/layers/rnn_impl.py:405. Returns
    (rnn_out [B,T,H*dirs], last_hidden, last_cell) with the state
    tensors shaped [num_layers*dirs, B, H]."""
    if gate_activation not in (None, "sigmoid") or activation not in (
            None, "tanh"):
        raise NotImplementedError(
            "basic_lstm: only sigmoid/tanh activations are lowered")
    if not batch_first:
        from ...layers import transpose

        input = transpose(input, [1, 0, 2])
    B = input.shape[0]
    dirs = 2 if bidirectional else 1
    x = input
    last_hs, last_cs = [], []
    for layer in range(num_layers):
        fwd, fh, fc = _lstm_pass(
            x, hidden_size,
            _layer_init(init_hidden, layer, 0, dirs, B, hidden_size),
            _layer_init(init_cell, layer, 0, dirs, B, hidden_size),
            False, sequence_length, forget_bias, dtype,
            f"{name}_l{layer}_fw")
        if bidirectional:
            bwd, bh, bc = _lstm_pass(
                x, hidden_size,
                _layer_init(init_hidden, layer, 1, dirs, B, hidden_size),
                _layer_init(init_cell, layer, 1, dirs, B, hidden_size),
                True, sequence_length, forget_bias, dtype,
                f"{name}_l{layer}_bw")
            x = concat([fwd, bwd], axis=2)
            last_hs.extend([fh, bh])
            last_cs.extend([fc, bc])
        else:
            x = fwd
            last_hs.append(fh)
            last_cs.append(fc)
        if dropout_prob and layer < num_layers - 1:
            x = _dropout(x, dropout_prob,
                         dropout_implementation="upscale_in_train")
    last_hidden = stack(last_hs, axis=0)
    last_cell = stack(last_cs, axis=0)
    if not batch_first:
        from ...layers import transpose

        x = transpose(x, [1, 0, 2])
    return x, last_hidden, last_cell


class _Cell(torch.nn.Module):
    def __init__(self, name_scope, hidden_size, dtype):
        super().__init__()
        self._name_scope = name_scope
        self._hidden_size = hidden_size
        self._dtype = getattr(torch, dtype)

    def _param(self, shape, like, is_bias=False):
        t = torch.empty(shape, dtype=self._dtype, device=like.device)
        if is_bias:
            torch.nn.init.zeros_(t)
        else:
            torch.nn.init.xavier_uniform_(t)
        return torch.nn.Parameter(t)


class BasicGRUUnit(_Cell):
    """One GRU step (reference rnn_impl.py:25): gates from [x, h],
    h' = u·h + (1 − u)·c."""

    def __init__(self, name_scope, hidden_size, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 dtype="float32"):
        super().__init__(name_scope, hidden_size, dtype)
        self._gate_w = None

    def _build_once(self, input):
        D, H = int(input.shape[-1]), self._hidden_size
        self._gate_w = self._param((D + H, 2 * H), input)
        self._gate_b = self._param((2 * H,), input, is_bias=True)
        self._cand_w = self._param((D + H, H), input)
        self._cand_b = self._param((H,), input, is_bias=True)

    def forward(self, input, pre_hidden):
        if self._gate_w is None:
            self._build_once(input)
        h = pre_hidden
        gates = torch.sigmoid(torch.cat([input, h], -1) @ self._gate_w
                              + self._gate_b)
        r, u = gates.chunk(2, -1)
        cand = torch.tanh(torch.cat([input, r * h], -1) @ self._cand_w
                          + self._cand_b)
        return u * h + (1 - u) * cand


class BasicLSTMUnit(_Cell):
    """One LSTM step (reference rnn_impl.py:699), the reference's own
    gate order i, j (cell), f, o with ``forget_bias`` on f."""

    def __init__(self, name_scope, hidden_size, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 forget_bias=1.0, dtype="float32"):
        super().__init__(name_scope, hidden_size, dtype)
        self._forget_bias = forget_bias
        self._weight = None

    def _build_once(self, input):
        D, H = int(input.shape[-1]), self._hidden_size
        self._weight = self._param((D + H, 4 * H), input)
        self._bias = self._param((4 * H,), input, is_bias=True)

    def forward(self, input, pre_hidden, pre_cell):
        if self._weight is None:
            self._build_once(input)
        gates = torch.cat([input, pre_hidden], -1) @ self._weight + self._bias
        i, j, f, o = gates.chunk(4, -1)
        new_c = (pre_cell * torch.sigmoid(f + self._forget_bias)
                 + torch.sigmoid(i) * torch.tanh(j))
        return torch.tanh(new_c) * torch.sigmoid(o), new_c
