"""Random ops, dropout and ``shuffle_channel``: torch lowerings with the
semantics of ``paddle_tpu/ops/random.py``. Each op draws from
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


def _batch_size_like_shape(op, ref):
    shape = [int(s) for s in op.attrs.get("shape", [1])]
    shape[int(op.attrs.get("output_dim_idx", 0))] = ref.shape[
        int(op.attrs.get("input_dim_idx", 0))]
    return tuple(shape)


@register_op("uniform_random_batch_size_like", inputs=("Input",),
             outputs=("Out",), stop_gradient=True)
def _uniform_random_bsl(ctx, op, ins):
    """``paddle_tpu/ops/random.py:30``: U(min, max) of ``shape`` with dim
    ``output_dim_idx`` taken from Input's ``input_dim_idx``."""
    dtype = torch_dtype(op.attrs.get("dtype", "float32"))
    lo = float(op.attrs.get("min", -1.0))
    hi = float(op.attrs.get("max", 1.0))
    u = torch.rand(_batch_size_like_shape(op, ins["Input"][0]),
                   generator=ctx.op_generator(op), device=ctx.device,
                   dtype=dtype)
    return {"Out": [lo + (hi - lo) * u]}


@register_op("truncated_gaussian_random", inputs=(), outputs=("Out",),
             stop_gradient=True)
def _truncated_gaussian_random(ctx, op, ins):
    """:57: N(mean, std) truncated at 2 std (``jax.random.
    truncated_normal(-2, 2)``): ``nn.init.trunc_normal_``'s inverse-CDF
    draw from the op's generator."""
    shape, dtype = _shape_dtype(op)
    mean = float(op.attrs.get("mean", 0.0))
    std = float(op.attrs.get("std", 1.0))
    z = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0,
                                generator=ctx.op_generator(op))
    return {"Out": [(mean + std * z).to(dtype)]}


@register_op("randint", inputs=(), outputs=("Out",), stop_gradient=True)
def _randint(ctx, op, ins):
    """:70: integers in [low, high)."""
    shape = tuple(int(s) for s in op.attrs.get("shape", []))
    return {"Out": [torch.randint(
        int(op.attrs.get("low", 0)), int(op.attrs.get("high", 1)), shape,
        generator=ctx.op_generator(op), device=ctx.device,
        dtype=torch_dtype(op.attrs.get("dtype", "int64")))]}


@register_op("shuffle_channel", inputs=("X",), outputs=("Out",))
def _shuffle_channel(ctx, op, ins):
    """:96: the channels as [group, C / group], transposed."""
    x = ins["X"][0]
    g = int(op.attrs.get("group", 1))
    n, c, h, w = x.shape
    return {"Out": [x.reshape(n, g, c // g, h, w).transpose(1, 2)
                    .reshape(n, c, h, w)]}


@register_op("sampling_id", inputs=("X",), outputs=("Out",),
             stop_gradient=True)
def _sampling_id(ctx, op, ins):
    """:104 (sampling_id_op.cc): one category a row drawn from the row's
    probabilities (``jax.random.categorical`` over log max(x, 1e-20)):
    a multinomial draw over max(x, 1e-20)."""
    x = ins["X"][0]
    p = torch.clamp(x.to(torch.float32), min=1e-20)
    ids = torch.multinomial(p, 1, generator=ctx.op_generator(op))[:, 0]
    return {"Out": [ids.to(torch_dtype(op.attrs.get("dtype", "int64")))]}
