"""Parameter and FLOPs summary table: the port of
``paddle_tpu/contrib/model_stat.py`` (reference
python/paddle/fluid/contrib/model_stat.py:40 summary).

A ``mul`` / ``matmul`` row counts its weight Y's elements as its
parameters and twice that as its FLOPs, as JAX's formula means to. JAX's
reads Y's shape off the op's input, which is a name there, so every such
row of its table reads 1 parameter and 2 FLOPs; the port reads the
shape from the block. Convolution and pooling rows equal JAX's.
"""

from __future__ import annotations

__all__ = ["summary"]


def _numel(shape) -> int:
    k = 1
    for d in shape or ():
        k *= d
    return k


def summary(main_prog):
    """Print a table of parameters and FLOPs of the conv / fc / pool ops
    (reference model_stat.py); returns (total_params, total_flops)."""
    total_params = 0
    total_flops = 0
    rows = []
    block = main_prog.global_block()
    for op in block.ops:
        if op.type not in ("conv2d", "depthwise_conv2d", "mul", "matmul",
                           "matmul_v2", "pool2d"):
            continue
        params = 0
        flops = 0
        if op.type in ("conv2d", "depthwise_conv2d"):
            params = _numel(block.var(op.inputs["Filter"][0]).shape)
            oshape = block.var(op.outputs["Output"][0]).shape
            flops = 2 * params * _numel((oshape or ())[2:])
        elif op.type in ("mul", "matmul", "matmul_v2"):
            params = _numel(block.var(op.inputs["Y"][0]).shape)
            flops = 2 * params
        total_params += params
        total_flops += flops
        rows.append((op.type, params, flops))
    print(f"{'op':24s}{'params':>14s}{'flops':>16s}")
    for t, p, f in rows:
        print(f"{t:24s}{p:14d}{f:16d}")
    print(f"{'TOTAL':24s}{total_params:14d}{total_flops:16d}")
    return total_params, total_flops
