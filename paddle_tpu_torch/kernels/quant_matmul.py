"""Quantized weight matmul (K11): the CUDA kernel
``csrc/quant_matmul.cu`` and its plain PyTorch version.

Replaces ``paddle_tpu/kernels/quant_matmul.py`` ``_quant_matmul_pallas``
(:231, body ``_make_quant_mm_kernel`` :170): ``x [M, K] @ dequant(W [K,
N])`` for three weight formats, quantized once at load
(``quantize_weight``, copied with ``dequantize_weight``, ``scale_shape``
and ``quantized_weight_bytes`` from :79-155):

  int8        int8 [K, N], per-output-channel float32 scales [N]
              (``max|w[:, n]| / 127``)
  int8_block  int8 [K, N], scales [ceil(K / block), N], one per block
              of ``block`` rows of a column
  fp8         float8_e4m3fn [K, N], per-channel scales
              (``max|w[:, n]| / 448``); bfloat16 compute

All-zero columns (blocks) get scale 1.0. Rounding is half to even,
as ``jnp.round``.

Numerics. The plain version repeats the JAX package's reference
(``_reference_quant_matmul`` :157): the weight is dequantized first,
``float(q) * scale`` in float32 (fp8: ``bf16(q) * bf16(scale)`` rounded
to bfloat16, and x rounded to bfloat16), then one float32 product.

Bound on the H100 at the serving shape (M = 128 rows a step): one
weight byte feeds 2·M = 256 flops. On the float32 FMA units (67
TFLOP/s), the earlier design, that is 4.87 ms of operations for the 1.27 G
weight elements of gpt3_1p3b against 0.38 ms of reading them. The
kernel (``quant_matmul_mma_kernel``) runs on the bf16 tensor cores
(``mma.sync.m16n8k16``, float32 accumulators), which brings the
operations near the bytes: fp8 takes one bf16 product a weight (989
TFLOP/s), the int8 modes three (989/3), since float32 x is split into
``hi + mid + lo``, three bf16 terms that sum to it exactly, and q (|q|
<= 127) is exact in bf16. Every product is then exact in float32. The
int8 mode scales the finished sum by ``scale[n]`` (the TPU kernel's
finish step); int8_block scales each block's partial sum, kept in
registers, as the block ends. So the kernel differs from the plain
version by the order of the float32 sums and, for the int8 modes, by
scaling after the sum instead of on each weight (one rounding more a
product); ``fp8`` has the plain version's products in another order.
The weights are decoded from their bytes in registers on the way to
shared memory; no float copy of x or of the weight is written to device
memory.

Filling the card: the output tiles are [128, 128]; where N / 128 tiles
are too few for the 132 SMs, K is cut into ``split_count(K, N)`` ranges
whose float32 partials a second pass sums in split order (no atomics).
Tile, split and summation order depend on K, N, mode and block, never
on M, so a row's result does not depend on the other rows of the batch.

int8_block with a block that is not a multiple of 16 (the mma depth)
runs ``quantized_matmul_fma``, the earlier kernel on the FMA units (each
weight dequantized in registers as the plain version does it), counted
in its own ``launches``. The wrapper picks it from the block alone.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

__all__ = ["QUANT_MODES", "DEFAULT_BLOCK", "quantize_weight",
           "dequantize_weight", "scale_shape", "quantized_weight_bytes",
           "quantized_matmul", "quantized_matmul_plain", "weight_dtype",
           "quantized_matmul_fma", "split_count", "MMA_DEPTH"]

QUANT_MODES = ("int8", "int8_block", "fp8")
DEFAULT_BLOCK = 256
_I8MAX = 127.0
_F8MAX = 448.0           # the largest finite float8_e4m3fn
_MODE_CODES = {"int8": 0, "int8_block": 1, "fp8": 2}
MMA_DEPTH = 16           # k of mma.m16n8k16: int8_block's tensor-core blocks
_TILE_N, _TILE_K, _SMS = 128, 32, 132


def split_count(K: int, N: int) -> int:
    """How many K ranges the tensor-core kernel cuts a [K, N] weight
    into: enough [128, 128] output tiles for the H100's 132 SMs at one
    row tile, each range at least 8 steps of 32. A function of K and N
    only, so a row's sums never depend on the batch."""
    n_tiles = -(-N // _TILE_N)
    k_steps = -(-K // _TILE_K)
    splits = max(1, min(_SMS // n_tiles, k_steps // 8))
    per = -(-k_steps // splits)
    return -(-k_steps // per)          # no empty range


def weight_dtype(mode: str) -> torch.dtype:
    """The storage dtype of a quantized weight under ``mode``."""
    return torch.float8_e4m3fn if mode == "fp8" else torch.int8


def _check_mode(mode: str, what: str) -> None:
    if mode not in QUANT_MODES:
        raise ValueError(f"{what}: mode must be one of {QUANT_MODES}, "
                         f"got {mode!r}")


def _on(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim tensor filled on ``like``'s device: on CUDA,
    torch divides by a Python scalar as a product with its reciprocal
    (one bit off an IEEE division); by a device tensor, it divides."""
    return like.new_full((), value)


def quantize_weight(w, mode: str = "int8", block: int = DEFAULT_BLOCK
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32/bf16 weight [K, N] (tensor or array) -> (qweight, scales)
    on the weight's device: int8 [K, N] + float32 [N] (int8), int8 +
    float32 [ceil(K/block), N] (int8_block), e4m3 + float32 [N] (fp8)."""
    _check_mode(mode, "quantize_weight")
    w = torch.as_tensor(w).float()
    if w.dim() != 2:
        raise ValueError(f"quantize_weight: expected a 2-D weight, got "
                         f"shape {tuple(w.shape)}")
    K, N = w.shape
    if mode in ("int8", "fp8"):
        qmax = _F8MAX if mode == "fp8" else _I8MAX
        amax = w.abs().amax(dim=0)
        scale = torch.where(amax > 0, amax / _on(qmax, amax),
                            torch.ones_like(amax))
        if mode == "fp8":
            return (w / scale[None, :]).to(torch.float8_e4m3fn), scale
        q = torch.clamp(torch.round(w / scale[None, :]), -_I8MAX, _I8MAX)
        return q.to(torch.int8), scale
    nb = -(-K // block)
    pad = nb * block - K
    wp = torch.nn.functional.pad(w, (0, 0, 0, pad)) if pad else w
    amax = wp.reshape(nb, block, N).abs().amax(dim=1)           # [nb, N]
    scale = torch.where(amax > 0, amax / _on(_I8MAX, amax),
                        torch.ones_like(amax))
    srow = scale.repeat_interleave(block, dim=0)[:K]             # [K, N]
    q = torch.clamp(torch.round(w / srow), -_I8MAX, _I8MAX)
    return q.to(torch.int8), scale


def dequantize_weight(qw: torch.Tensor, scales: torch.Tensor,
                      mode: str = "int8", block: int = DEFAULT_BLOCK
                      ) -> torch.Tensor:
    """Inverse of ``quantize_weight``: float32 for the int8 modes,
    bfloat16 for fp8 (``bf16(q) * bf16(scale)``)."""
    if mode == "fp8":
        return qw.to(torch.bfloat16) * scales.to(torch.bfloat16)[None, :]
    w = qw.float()
    if mode == "int8":
        return w * scales[None, :]
    return w * scales.repeat_interleave(block, dim=0)[:qw.shape[0]]


def scale_shape(weight_shape, mode: str, block: int = DEFAULT_BLOCK):
    """The scale plane's shape for a [K, N] weight under ``mode``."""
    K, N = int(weight_shape[0]), int(weight_shape[1])
    if mode == "int8_block":
        return (-(-K // block), N)
    return (N,)


def quantized_weight_bytes(weight_shape, mode: str,
                           block: int = DEFAULT_BLOCK) -> int:
    """Bytes of qweight + scales for a [K, N] weight (1 byte an
    element in every mode, 4 a scale)."""
    K, N = int(weight_shape[0]), int(weight_shape[1])
    n_scales = 1
    for d in scale_shape(weight_shape, mode, block):
        n_scales *= d
    return K * N + 4 * n_scales


def quantized_matmul_plain(x2: torch.Tensor, qw: torch.Tensor,
                           scales: torch.Tensor, mode: str = "int8",
                           block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """The plain version (the JAX reference): dequantize, then one
    product in float32 (fp8: bfloat16 operands, float32 products —
    torch's bf16 @ bf16 would round its output to bfloat16, so the
    product is taken on the float32 values of the bfloat16 operands)."""
    wd = dequantize_weight(qw, scales, mode, block)
    if mode == "fp8":
        out = x2.to(torch.bfloat16).float() @ wd.float()
    else:
        out = x2.float() @ wd
    return out.to(x2.dtype)


def quantized_matmul(x: torch.Tensor, qw: torch.Tensor, scales: torch.Tensor,
                     *, mode: str = "int8", block: int = DEFAULT_BLOCK
                     ) -> torch.Tensor:
    """``x [..., K] @ dequant(qw [K, N])`` -> ``[..., N]`` in x's dtype.
    CPU tensors (and meta ones under ``_build.evaluating_shapes``) run
    ``quantized_matmul_plain``; CUDA tensors run K11 on
    the tensor cores, counted in ``quantized_matmul.launches``
    (int8_block with a block that is not a multiple of 16:
    ``quantized_matmul_fma``)."""
    _check_mode(mode, "quantized_matmul")
    lead, K = x.shape[:-1], x.shape[-1]
    if qw.dim() != 2 or qw.shape[0] != K:
        raise ValueError(f"quantized_matmul: x [..., {K}] does not match "
                         f"the weight {tuple(qw.shape)}")
    N = qw.shape[1]
    want_scales = scale_shape(qw.shape, mode, block)
    if tuple(scales.shape) != want_scales:
        raise ValueError(f"quantized_matmul: scales {tuple(scales.shape)} "
                         f"!= {want_scales} for mode {mode!r} block {block}")
    if qw.dtype != weight_dtype(mode):
        raise TypeError(f"quantized_matmul: mode {mode!r} takes a "
                        f"{weight_dtype(mode)} weight, got {qw.dtype}")
    x2 = x.reshape(-1, K)
    if _build.takes_plain(x):
        return quantized_matmul_plain(x2, qw, scales, mode,
                                      block).reshape(*lead, N)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul: unsupported device {x.device}")
    if x.dtype != torch.float32 or scales.dtype != torch.float32:
        raise TypeError(f"quantized_matmul kernel takes float32 x and "
                        f"scales; got {x.dtype}, {scales.dtype}")
    if qw.device != x.device or scales.device != x.device:
        raise ValueError("quantized_matmul: x, qweight and scales must be "
                         "on one device")
    x2 = x2.contiguous()
    if not (qw.is_contiguous() and scales.is_contiguous()):
        raise ValueError("quantized_matmul kernel takes a contiguous "
                         "weight and scales")
    M = x2.shape[0]
    out = torch.empty((M, N), device=x.device, dtype=torch.float32)
    if mode == "int8_block" and block % MMA_DEPTH:
        quantized_matmul_fma(x2, qw, scales, out, block)
        return out.reshape(*lead, N)
    splits = split_count(K, N)
    partial = (torch.empty((splits, M, N), device=x.device,
                           dtype=torch.float32) if splits > 1 else None)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pt_quant_matmul(
            x2.data_ptr(), qw.data_ptr(), scales.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), M, K, N,
            _MODE_CODES[mode], int(block), splits, stream)
    _build.check(err, "quantized_matmul")
    _build.count(quantized_matmul)
    return out.reshape(*lead, N)


quantized_matmul.launches = 0


def quantized_matmul_fma(x2: torch.Tensor, qw: torch.Tensor,
                         scales: torch.Tensor, out: torch.Tensor,
                         block: int) -> torch.Tensor:
    """int8_block on the FMA units, for a block that is not a multiple
    of ``MMA_DEPTH``: fills ``out`` [M, N] from x2 [M, K] float32, qw
    int8 [K, N] and scales [ceil(K / block), N], all contiguous CUDA
    tensors (``quantized_matmul`` checks them). Counted in
    ``quantized_matmul_fma.launches``."""
    M, K = x2.shape
    N = qw.shape[1]
    lib = _build.library()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.pt_quant_matmul_fma(x2.data_ptr(), qw.data_ptr(),
                                      scales.data_ptr(), out.data_ptr(), M,
                                      K, N, int(block), stream)
    _build.check(err, "quantized_matmul (FMA, odd block)")
    _build.count(quantized_matmul_fma)
    return out


quantized_matmul_fma.launches = 0
