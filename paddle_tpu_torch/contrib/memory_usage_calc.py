"""Estimate a program's activation and parameter memory: the port's
copy of ``paddle_tpu/contrib/memory_usage_calc.py`` (reference
python/paddle/fluid/contrib/memory_usage_calc.py:46 memory_usage)."""

from __future__ import annotations

DTYPE_TO_SIZE = {
    "float16": 2, "bfloat16": 2, "float32": 4, "float64": 8,
    "int8": 1, "uint8": 1, "int16": 2, "int32": 4, "int64": 8, "bool": 1,
}

__all__ = ["memory_usage"]


def memory_usage(program, batch_size):
    """Rough lower/upper memory bound in MB for one executor step
    (reference memory_usage_calc.py: sums var bytes, batch dim filled
    with batch_size; the 70%-of-total lower bound mirrors its
    heuristic)."""
    if batch_size <= 0:
        raise ValueError("The batch size should be positive.")
    total = 0.0
    for var in program.global_block().vars.values():
        shape = var.shape or ()
        count = 1
        for d in shape:
            count *= batch_size if (d is None or d < 0) else d
        total += count * DTYPE_TO_SIZE.get(str(var.dtype), 4)
    mb = total / (1024 ** 2)
    return mb * 0.7, mb
