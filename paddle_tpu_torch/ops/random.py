"""Random ops and dropout: torch lowerings with the semantics of
``paddle_tpu/ops/random.py``. Each op draws from
``ctx.op_generator(op)``, seeded from (run seed, step, op_ident); the
numbers differ from ``jax.random``'s, the distributions do not."""

from __future__ import annotations

import torch

from ..core.executor import torch_dtype
from ..core.registry import register_op


def _shape_dtype(op):
    shape = tuple(int(s) for s in op.attrs.get("shape", []))
    return shape, torch_dtype(op.attrs.get("dtype", "float32"))


@register_op("uniform_random", inputs=(), outputs=("Out",), stop_gradient=True)
def _uniform_random(ctx, op, ins):
    shape, dtype = _shape_dtype(op)
    lo = float(op.attrs.get("min", -1.0))
    hi = float(op.attrs.get("max", 1.0))
    u = torch.rand(shape, generator=ctx.op_generator(op), device=ctx.device,
                   dtype=dtype)
    return {"Out": [lo + (hi - lo) * u]}


@register_op("gaussian_random", inputs=(), outputs=("Out",), stop_gradient=True)
def _gaussian_random(ctx, op, ins):
    shape, dtype = _shape_dtype(op)
    mean = float(op.attrs.get("mean", 0.0))
    std = float(op.attrs.get("std", 1.0))
    z = torch.randn(shape, generator=ctx.op_generator(op), device=ctx.device,
                    dtype=dtype)
    return {"Out": [mean + std * z]}


@register_op("dropout", inputs=("X",), outputs=("Out", "Mask"))
def _dropout(ctx, op, ins):
    """Keep each element with probability 1 - p; upscale_in_train
    divides kept values by 1 - p. Recorded for its grad op like any
    forward op, so the backward applies the same mask (the tape keeps
    it; the reference re-draws it from the same key)."""
    x = ins["X"][0]
    p = float(op.attrs.get("dropout_prob", 0.5))
    is_test = bool(op.attrs.get("is_test", False))
    impl = op.attrs.get("dropout_implementation", "downgrade_in_infer")
    if is_test or p == 0.0:
        out = x if impl == "upscale_in_train" or p == 0.0 else x * (1.0 - p)
        keep = None
    else:
        keep = torch.rand(x.shape, generator=ctx.op_generator(op),
                          device=x.device) < (1.0 - p)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        if impl == "upscale_in_train":
            out = torch.where(keep, x / (1.0 - p), zero)
        else:
            out = torch.where(keep, x, zero)
    res = {"Out": [out]}
    if ctx.wants(op, "Mask"):
        res["Mask"] = [torch.ones_like(x, dtype=torch.uint8) if keep is None
                       else keep.to(torch.uint8)]
    return res
