"""Quantization ops.

The quantized matmul ops that ``quantize.rewrite_for_inference`` puts in
a Program (``paddle_tpu/kernels/quant_matmul.py`` ``quantized_matmul``
:335, ``quantized_fc`` :351): ``X`` times the dequantized ``QWeight``
with its ``Scale`` plane, in the mode and block of the op's
``quant_mode`` / ``quant_block`` attrs, through
``kernels.quant_matmul.quantized_matmul`` (K11 on CUDA tensors, its
plain version on CPU tensors).

The fake-quantize family of ``paddle_tpu/ops/quant.py`` (Fluid's
fake_quantize_op.cc / fake_dequantize_op.cc): quantize to the int range
and dequantize at once, with a straight-through round, so training sees
the quantization error (``contrib.slim.quantization``); the scale
observer ``moving_average_abs_max_scale`` behind ``quantize.calibrate``;
and the real int8 / uint8 conversions. The JAX package computes them
outside any Pallas kernel, and so do these lowerings. A scale is not
stop-gradiented: X's gradient also flows through the abs-max that made
it, as in JAX. Divisions by a constant take a device tensor, so CUDA
does not turn them into products with a reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register_op
from ..kernels.quant_matmul import DEFAULT_BLOCK, quantized_matmul
from .math import _Abs, _bounded, _maximum


def _mode_block(op):
    return (str(op.attrs.get("quant_mode", "int8")),
            int(op.attrs.get("quant_block", DEFAULT_BLOCK)))


@register_op("quantized_matmul", inputs=("X", "QWeight", "Scale"),
             outputs=("Out",), no_grad=("QWeight", "Scale"),
             stop_gradient=True)
def _quantized_matmul_op(ctx, op, ins):
    x, qw, s = ins["X"][0], ins["QWeight"][0], ins["Scale"][0]
    if op.attrs.get("transpose_X", False) or op.attrs.get("trans_x", False):
        x = x.transpose(-1, -2)
    mode, block = _mode_block(op)
    out = quantized_matmul(x.contiguous(), qw, s, mode=mode, block=block)
    alpha = float(op.attrs.get("alpha", 1.0))
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register_op("quantized_fc", inputs=("X", "QWeight", "Scale"),
             outputs=("Out",), no_grad=("QWeight", "Scale"),
             stop_gradient=True)
def _quantized_fc_op(ctx, op, ins):
    """The ``mul`` twin (fc's inner op): X flattened at
    ``x_num_col_dims``, one 2-D quantized product, the leading dims
    restored."""
    x, qw, s = ins["X"][0], ins["QWeight"][0], ins["Scale"][0]
    xnc = int(op.attrs.get("x_num_col_dims", 1))
    lead = tuple(x.shape[:xnc])
    x2 = x.reshape(int(np.prod(lead or (1,))), -1).contiguous()
    mode, block = _mode_block(op)
    out = quantized_matmul(x2, qw, s, mode=mode, block=block)
    return {"Out": [out.reshape(lead + (qw.shape[1],))]}


# -- the fake-quantize family (``paddle_tpu/ops/quant.py``) -----------------


def _const(x, v):
    return torch.full((), float(v), dtype=x.dtype, device=x.device)


def _ste_round(x):
    """Round half to even forward, identity backward (:28-30)."""
    return x + (torch.round(x) - x).detach()


def _abs_max(x, dim=None):
    """``max(|x|)``: ``jnp.abs``'s gradient (1 at 0) and ``jnp.max``'s
    (split evenly over ties)."""
    a = _Abs.apply(x)
    return torch.amax(a) if dim is None else torch.amax(a, dim=dim)


def _quant_dequant(x, scale, bits):
    """:33-37: the scale clamped at 1e-8 (an all-zero X gives zeros),
    x / s * qmax rounded and clipped to [-qmax, qmax] (``jnp.clip``'s
    0.5 gradient at the bounds), times s / qmax."""
    qmax = float(2 ** (bits - 1) - 1)
    s = _maximum(scale, _const(scale, 1e-8))
    q = _bounded(_ste_round(x / s * qmax), -qmax, qmax)
    return q * s / _const(q, qmax)


def _bits(op):
    return int(op.attrs.get("bit_length", 8))


@register_op("fake_quantize_abs_max", inputs=("X",),
             outputs=("Out", "OutScale"))
def _fake_quantize_abs_max(ctx, op, ins):
    """:40: the scale is this batch's abs-max."""
    x = ins["X"][0]
    scale = _abs_max(x)
    return {"Out": [_quant_dequant(x, scale, _bits(op))],
            "OutScale": [scale.reshape(1)]}


@register_op("fake_quantize_dequantize_moving_average_abs_max",
             inputs=("X", "InScale", "InAccum", "InState"),
             outputs=("Out", "OutScale", "OutAccum", "OutState"),
             no_grad=("InScale", "InAccum", "InState"))
def _fake_quant_dequant_moving(ctx, op, ins):
    """:50: training keeps accum = rate * accum + abs-max and state =
    rate * state + 1, and quantizes by accum / state; ``is_test``
    quantizes by InScale and passes the state through."""
    x = ins["X"][0]
    rate = float(op.attrs.get("moving_rate", 0.9))
    in_scale = ins["InScale"][0].reshape(())
    if op.attrs.get("is_test", False):
        scale = in_scale
        accum = ins["InAccum"][0] if ins.get("InAccum") else in_scale.reshape(1)
        state = (ins["InState"][0] if ins.get("InState")
                 else torch.ones((1,), dtype=x.dtype, device=x.device))
    else:
        cur = _abs_max(x)
        accum0 = (ins["InAccum"][0].reshape(()) if ins.get("InAccum")
                  else in_scale)
        state0 = (ins["InState"][0].reshape(()) if ins.get("InState")
                  else _const(x, 1.0))
        accum = (rate * accum0 + cur).reshape(1)
        state = (rate * state0 + 1.0).reshape(1)
        scale = (accum / state).reshape(())
    return {"Out": [_quant_dequant(x, scale, _bits(op))],
            "OutScale": [scale.reshape(1)],
            "OutAccum": [accum.reshape(1)],
            "OutState": [state.reshape(1)]}


@register_op("fake_channel_wise_quantize_abs_max", inputs=("X",),
             outputs=("Out", "OutScale"))
def _fake_channel_wise_quantize_abs_max(ctx, op, ins):
    """:81: one abs-max scale per output channel (dim 0)."""
    x = ins["X"][0]
    scale = _abs_max(x, tuple(range(1, x.dim())))
    bshape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return {"Out": [_quant_dequant(x, scale.reshape(bshape), _bits(op))],
            "OutScale": [scale]}


@register_op("fake_dequantize_max_abs", inputs=("X", "Scale"),
             outputs=("Out",), no_grad=("Scale",))
def _fake_dequantize_max_abs(ctx, op, ins):
    """:97: x * scale / max_range."""
    x, scale = ins["X"][0], ins["Scale"][0]
    return {"Out": [x * scale.reshape(())
                    / _const(x, op.attrs.get("max_range", 127.0))]}


@register_op("fake_quantize_range_abs_max",
             inputs=("X", "InScale", "Iter", "InScales"),
             outputs=("Out", "OutScale", "OutScales"),
             no_grad=("InScale", "Iter", "InScales"))
def _fake_quantize_range_abs_max(ctx, op, ins):
    """:106, Fluid's FindRangeAbsMaxFunctor: a ring of ``window_size``
    batch maxima (InScales, round-tripped through OutScales) written at
    Iter % window. The scale stays InScale unless this batch's max beats
    it, or the evicted slot held it, when it becomes the window's max.
    Without InScales it is the running max(abs-max, InScale);
    ``is_test`` quantizes by InScale."""
    x = ins["X"][0]
    bits = _bits(op)
    in_scale = (ins["InScale"][0].reshape(()) if ins.get("InScale")
                else _const(x, 0.0))
    in_scales = ins["InScales"][0].reshape(-1) if ins.get("InScales") else None
    if op.attrs.get("is_test", False):
        scale = in_scale
        out_scales = in_scales if in_scales is not None else scale.reshape(1)
    elif in_scales is not None:
        cur = _abs_max(x)
        it = (ins["Iter"][0].reshape(()).to(torch.int32) if ins.get("Iter")
              else torch.zeros((), dtype=torch.int32, device=x.device))
        idx = torch.remainder(it, in_scales.shape[0])
        removed = in_scales[idx.long()]
        slot = torch.arange(in_scales.shape[0], device=x.device) == idx
        arr = torch.where(slot, cur, in_scales)
        scale = torch.where(
            cur > in_scale, cur,
            torch.where(torch.abs(removed - in_scale) < 1e-6,
                        torch.amax(arr), in_scale))
        out_scales = arr
    else:
        scale = _maximum(_abs_max(x), in_scale)
        out_scales = scale.reshape(1)
    return {"Out": [_quant_dequant(x, scale, bits)],
            "OutScale": [scale.reshape(1)],
            "OutScales": [out_scales]}


@register_op("fake_quantize_moving_average_abs_max",
             inputs=("X", "InScale", "InAccum", "InState"),
             outputs=("Out", "OutScale", "OutAccum", "OutState"),
             no_grad=("InScale", "InAccum", "InState"))
def _fake_quantize_moving_average_abs_max(ctx, op, ins):
    """:157: the same running scale as the quant-dequant variant."""
    return _fake_quant_dequant_moving(ctx, op, ins)


@register_op("moving_average_abs_max_scale",
             inputs=("X", "InAccum", "InState"),
             outputs=("Out", "OutScale", "OutAccum", "OutState"),
             no_grad=("InAccum", "InState"))
def _moving_average_abs_max_scale(ctx, op, ins):
    """:166: the scale observer. Out is X unchanged; accum = rate *
    accum + abs-max, state = rate * state + 1 (both from 0 when not
    given) and OutScale = accum / state."""
    x = ins["X"][0]
    rate = float(op.attrs.get("moving_rate", 0.9))
    cur = _abs_max(x)
    accum0 = (ins["InAccum"][0].reshape(()) if ins.get("InAccum")
              else _const(x, 0.0))
    state0 = (ins["InState"][0].reshape(()) if ins.get("InState")
              else _const(x, 0.0))
    accum = rate * accum0 + cur
    state = rate * state0 + 1.0
    return {"Out": [x], "OutScale": [(accum / state).reshape(1)],
            "OutAccum": [accum.reshape(1)], "OutState": [state.reshape(1)]}


@register_op("fake_channel_wise_dequantize_max_abs", inputs=("X", "Scales"),
             outputs=("Out",), no_grad=("Scales",))
def _fake_channel_wise_dequantize_max_abs(ctx, op, ins):
    """:189: x * channel scale / qmax of ``quant_bits[0]``, then, with a
    second scale and a second width, * scale / its qmax."""
    x, scales = ins["X"][0], ins["Scales"]
    bits = [int(b) for b in op.attrs.get("quant_bits", [8])]
    ch = scales[0]
    out = (x * ch.reshape((ch.shape[0],) + (1,) * (x.dim() - 1))
           / _const(x, 2 ** (bits[0] - 1) - 1))
    if len(scales) > 1 and len(bits) > 1:
        out = out * scales[1].reshape(()) / _const(out, 2 ** (bits[1] - 1) - 1)
    return {"Out": [out]}


@register_op("dequantize_abs_max", inputs=("X", "Scale"), outputs=("Out",),
             no_grad=("Scale",), stop_gradient=True)
def _dequantize_abs_max(ctx, op, ins):
    """:208: int8 to float32, x * scale / max_range."""
    x = ins["X"][0].to(torch.float32)
    return {"Out": [x * ins["Scale"][0].reshape(())
                    / _const(x, op.attrs.get("max_range", 127.0))]}


@register_op("quantize", inputs=("Input",), outputs=("Output",),
             stop_gradient=True)
def _quantize(ctx, op, ins):
    """:217: round(x * Scale + Shift) to uint8 (the default,
    ``is_negative_input`` false) or int8, saturated."""
    x = ins["Input"][0]
    q = torch.round(x * float(op.attrs.get("Scale", 1.0))
                    + float(op.attrs.get("Shift", 0.0)))
    if not op.attrs.get("is_negative_input", False):
        return {"Output": [torch.clamp(q, 0, 255).to(torch.uint8)]}
    return {"Output": [torch.clamp(q, -128, 127).to(torch.int8)]}


@register_op("dequantize", inputs=("Input",), outputs=("Output",),
             stop_gradient=True)
def _dequantize(ctx, op, ins):
    """:232: (x - Shift) / Scale in float32."""
    x = ins["Input"][0].to(torch.float32)
    return {"Output": [(x - float(op.attrs.get("Shift", 0.0)))
                       / _const(x, op.attrs.get("Scale", 1.0))]}


@register_op("requantize", inputs=("Input",), outputs=("Output",),
             stop_gradient=True)
def _requantize(ctx, op, ins):
    """:241: int8 from one scale to another, rounded and saturated."""
    x = ins["Input"][0].to(torch.float32)
    ratio = float(op.attrs.get("Scale_out", 1.0)) / float(
        op.attrs.get("Scale_in", 1.0))
    q = torch.round(x * ratio)
    return {"Output": [torch.clamp(q, -128, 127).to(torch.int8)]}


@register_op("lookup_table_dequant", inputs=("W", "Ids"), outputs=("Out",),
             no_grad=("Ids",), stop_gradient=True)
def _lookup_table_dequant(ctx, op, ins):
    """:251: rows stored as [min, range, payload...]; out = payload /
    255 * range + min."""
    w, ids = ins["W"][0], ins["Ids"][0]
    rows = w[ids.reshape(-1).long()]
    return {"Out": [rows[:, 2:] / _const(rows, 255.0) * rows[:, 1:2]
                    + rows[:, 0:1]]}
