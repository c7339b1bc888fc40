"""The quantized matmul ops that ``quantize.rewrite_for_inference``
puts in a Program (``paddle_tpu/kernels/quant_matmul.py``
``quantized_matmul`` :335, ``quantized_fc`` :351): ``X`` times the
dequantized ``QWeight`` with its ``Scale`` plane, in the mode and block
of the op's ``quant_mode`` / ``quant_block`` attrs, through
``kernels.quant_matmul.quantized_matmul`` (K11 on CUDA tensors, its
plain version on CPU tensors)."""

from __future__ import annotations

import numpy as np

from ..core.registry import register_op
from ..kernels.quant_matmul import DEFAULT_BLOCK, quantized_matmul


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
