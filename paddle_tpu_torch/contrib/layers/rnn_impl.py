"""Contrib RNN stacks and cells: the port's copy of
``paddle_tpu/contrib/layers/rnn_impl.py`` (reference
python/paddle/fluid/contrib/layers/rnn_impl.py: BasicGRUUnit:25,
basic_gru:164, basic_lstm:405, BasicLSTMUnit:699).

Each (layer, direction) of ``basic_gru`` / ``basic_lstm`` is one
``fused_gru`` / ``fused_lstm`` op over the precomputed input
projections, as in the JAX package. ``BasicGRUUnit`` and
``BasicLSTMUnit`` are dygraph ``Layer``s, as in the JAX package
(:199, :241): their parameters are made at the first call (Xavier
weights, zero biases) and the step is computed on the VarBases'
tensors, so ``backward()`` reaches the parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from ...layer_helper import LayerHelper
from ...layers.nn import _out
from ...layers import concat, dropout as _dropout, reshape, stack
from ...initializer import XavierInitializer, NumpyArrayInitializer
from ...dygraph.base import VarBase
from ...dygraph.layers import Layer

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


def _wrap(t):
    return VarBase(t, stop_gradient=not t.requires_grad)


class BasicGRUUnit(Layer):
    """One GRU step (reference rnn_impl.py:25): gates from [x, h],
    h' = u·h + (1 − u)·c."""

    def __init__(self, name_scope, hidden_size, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 dtype="float32"):
        super().__init__(name_scope)
        self._hidden_size = hidden_size
        self._dtype = dtype
        self._built = False

    def _build_once(self, input):
        D, H = int(input.shape[-1]), self._hidden_size
        self._gate_w = self.create_parameter([D + H, 2 * H],
                                             dtype=self._dtype)
        self._gate_b = self.create_parameter([2 * H], dtype=self._dtype,
                                             is_bias=True)
        self._cand_w = self.create_parameter([D + H, H], dtype=self._dtype)
        self._cand_b = self.create_parameter([H], dtype=self._dtype,
                                             is_bias=True)
        self._built = True

    def forward(self, input, pre_hidden):
        if not self._built:
            self._build_once(input)
        x, h = input.value, pre_hidden.value
        gates = torch.sigmoid(torch.cat([x, h], -1) @ self._gate_w.value
                              + self._gate_b.value)
        r, u = gates.chunk(2, -1)
        cand = torch.tanh(torch.cat([x, r * h], -1) @ self._cand_w.value
                          + self._cand_b.value)
        return _wrap(u * h + (1 - u) * cand)


class BasicLSTMUnit(Layer):
    """One LSTM step (reference rnn_impl.py:699), the reference's own
    gate order i, j (cell), f, o with ``forget_bias`` on f."""

    def __init__(self, name_scope, hidden_size, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 forget_bias=1.0, dtype="float32"):
        super().__init__(name_scope)
        self._hidden_size = hidden_size
        self._forget_bias = forget_bias
        self._dtype = dtype
        self._built = False

    def _build_once(self, input):
        D, H = int(input.shape[-1]), self._hidden_size
        self._weight = self.create_parameter([D + H, 4 * H],
                                             dtype=self._dtype)
        self._bias = self.create_parameter([4 * H], dtype=self._dtype,
                                           is_bias=True)
        self._built = True

    def forward(self, input, pre_hidden, pre_cell):
        if not self._built:
            self._build_once(input)
        gates = (torch.cat([input.value, pre_hidden.value], -1)
                 @ self._weight.value + self._bias.value)
        i, j, f, o = gates.chunk(4, -1)
        new_c = (pre_cell.value * torch.sigmoid(f + self._forget_bias)
                 + torch.sigmoid(i) * torch.tanh(j))
        return _wrap(torch.tanh(new_c) * torch.sigmoid(o)), _wrap(new_c)
