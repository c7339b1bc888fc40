"""Layer norm, forward and backward: the CUDA kernels of
``csrc/layer_norm.cu`` and their plain PyTorch versions.

K1 replaces ``paddle_tpu/kernels/layer_norm.py`` ``_fwd_impl`` (the
Pallas forward, ``pallas_call`` at :124) as the ``layer_norm`` op of
``ops/nn.py:427-445`` reaches it: per row of ``[R, C]``,
``y = (x - mean) * rsqrt(var + eps) * gamma + beta`` with population
variance about the mean (two passes) and float32 accumulation; y has
x's dtype. It writes the per-row mean and rstd (float32 ``[R]``) when
the backward will need them (``layer_norm_fwd``); the serving path asks
for y alone (``layer_norm``).

K3 replaces ``_vjp_bwd`` (:155, ``pallas_call`` at :164):
``dx = rstd * (dy*g - mean(dy*g) - xhat * mean(dy*g*xhat))`` per row,
``dgamma = sum_rows(dy * xhat)``, ``dbeta = sum_rows(dy)`` (float32
sums, cast to gamma's dtype), in two passes on the card: a block per
run of rows writes its partial sums once, then a column pass adds the
runs in a fixed order. No float atomics: two calls give the same bits.

``fused_layer_norm`` is the ``torch.autograd.Function`` over both, the
counterpart of the reference's ``jax.custom_vjp`` of the same name: y
only, as there, so the op's Mean/Variance outputs stay plain torch and
their gradients exact (``layer_norm_pallas``, :194-215).

Bound on the H100: memory. K1 moves ``2 * R * C * itemsize`` bytes
plus gamma and beta; K3 ``3 * R * C * itemsize`` plus gamma, the
stats, dgamma and dbeta. Each thread keeps fixed 16-byte vectors of a
row in registers and loads them once; wider rows take looped kernels,
so C has no cap (the TPU's VMEM bound ``MAX_C`` does not carry over).
The geometry is computed here, from C, R and the element size alone
(``ln_fwd_geometry``, ``ln_bwd_geometry``), never from the card: the
same inputs give the same bits on any card, and K1's path does not
depend on R, so a row's result does not depend on the rows beside it.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import _build

__all__ = ["layer_norm", "layer_norm_plain", "layer_norm_fwd",
           "layer_norm_fwd_plain", "layer_norm_bwd", "layer_norm_bwd_plain",
           "fused_layer_norm", "ln_fwd_geometry", "ln_bwd_geometry"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

VEC_BYTES = 16         # a thread's loads and stores: 16-byte vectors
MAX_THREADS = 512      # threads a block (the kernels' launch bound)
VECTORS_A_THREAD = 2   # the block-per-row paths aim at this many a thread
NARROW_VECTORS = 64    # K1: a row of at most this many vectors is one warp
NARROW_ROWS = 4        # K1: rows (warps) a block on that path
FWD_NVECS = (1, 2)     # K1: vectors a thread in registers (kernel variants)
BWD_NVECS = (1, 2)     # K3: the same (x, dy, the next row's, gamma, 2 sums)
BWD_BLOCKS = 256       # K3: at least this many runs of rows where R allows
BWD_MAX_ROWS = 8       # K3: rows a run, at most, while the scratch allows
BWD_SCRATCH = 1 << 19  # K3: floats of one [G, C] partial array, at most
COLUMN_WARPS = 32      # K3's column pass: warps a block of 32 columns


class FwdGeometry(NamedTuple):
    """K1's launch: ``row_threads`` threads a row, ``rows_per_block``
    rows a block, ``nvec`` vectors a thread in registers (0: the looped
    kernel)."""
    row_threads: int
    rows_per_block: int
    nvec: int


class BwdGeometry(NamedTuple):
    """K3's launch: ``threads`` a row (and a block), ``nvec`` vectors a
    thread in registers (0: looped), ``blocks`` (G) runs of
    ``rows_per_block`` rows, and the column pass's ``column_warps``."""
    threads: int
    nvec: int
    rows_per_block: int
    blocks: int
    column_warps: int


def _vectors(C: int, itemsize: int) -> int:
    """16-byte vectors a row of C elements spans (the last may be part
    of one)."""
    return -(-C // (VEC_BYTES // itemsize))


def _row_threads(nv: int) -> int:
    """Whole warps, about ``VECTORS_A_THREAD`` vectors each, at most
    ``MAX_THREADS``."""
    want = -(-nv // VECTORS_A_THREAD)
    return min(MAX_THREADS, max(32, -(-want // 32) * 32))


def _nvec(nv: int, threads: int, variants) -> int:
    """The least register variant that covers the row, or 0 (looped)."""
    need = -(-nv // threads)
    return next((n for n in variants if n >= need), 0)


def ln_fwd_geometry(C: int, itemsize: int = 4) -> FwdGeometry:
    """K1's geometry, a function of C and the element size alone (never
    of R or the card). A thread owns vectors ``t + k * row_threads`` of
    its row, k < nvec (k < ceil(vectors / row_threads) when looped)."""
    nv = _vectors(C, itemsize)
    if nv <= NARROW_VECTORS:
        return FwdGeometry(32, NARROW_ROWS, _nvec(nv, 32, FWD_NVECS))
    threads = _row_threads(nv)
    return FwdGeometry(threads, 1, _nvec(nv, threads, FWD_NVECS))


def ln_bwd_geometry(R: int, C: int, itemsize: int = 4) -> BwdGeometry:
    """K3's geometry, a function of R, C and the element size alone
    (never of the card). A row's threads and vectors depend on C alone,
    as in K1; block b takes rows ``[b * rows_per_block, ...)``."""
    nv = _vectors(C, itemsize)
    threads = _row_threads(nv)
    nvec = _nvec(nv, threads, BWD_NVECS)
    if nvec == 0:
        threads = MAX_THREADS
    # runs of at most BWD_MAX_ROWS rows (the depth that kept the most
    # bytes in flight of those timed), fewer where R is small so
    # that BWD_BLOCKS blocks still run, more where G partial rows of C
    # would pass BWD_SCRATCH (the scratch stays in L2)
    rows_per_block = max(1, min(BWD_MAX_ROWS, -(-R // BWD_BLOCKS)),
                         -(-R // max(1, BWD_SCRATCH // C)))
    return BwdGeometry(threads, nvec, rows_per_block,
                       -(-R // rows_per_block), COLUMN_WARPS)


def layer_norm_fwd_plain(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, eps: float = 1e-5
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version (and numerics oracle) of K1: y, and
    the float32 per-row mean and rstd."""
    xf = x.float()
    mean = xf.mean(dim=-1)
    var = (xf - mean[:, None]).square().mean(dim=-1)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean[:, None]) * rstd[:, None] * gamma.float() + beta.float()
    return y.to(x.dtype), mean, rstd


def layer_norm_plain(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """K1's plain version, y only."""
    return layer_norm_fwd_plain(x, gamma, beta, eps)[0]


def layer_norm_bwd_plain(x: torch.Tensor, gamma: torch.Tensor,
                         dy: torch.Tensor, mean: torch.Tensor,
                         rstd: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K3: (dx, dgamma, dbeta), the
    reference ``_bwd_kernel``'s arithmetic in float32."""
    xf, dyf = x.float(), dy.float()
    xhat = (xf - mean[:, None]) * rstd[:, None]
    dyg = dyf * gamma.float()
    m1 = dyg.mean(dim=1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=1, keepdim=True)
    dx = rstd[:, None] * (dyg - m1 - xhat * m2)
    dgamma = (dyf * xhat).sum(dim=0)
    dbeta = dyf.sum(dim=0)
    return dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


def _check(what, x, vecs, stats=()):
    if x.dim() != 2:
        raise ValueError(f"{what} takes x [R, C]; got {tuple(x.shape)}")
    R, C = x.shape
    for name, t in vecs:
        if tuple(t.shape) != (C,):
            raise ValueError(f"{what}: {name} must be [{C}], got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
    for name, t in stats:
        if tuple(t.shape) != (R,) or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32 [{R}], got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
    if x.device.type != "cuda" and not _build.takes_plain(x):
        raise ValueError(f"{what}: unsupported device {x.device}")


def _kernel_dtype(what, x, *others):
    code = _DTYPES.get(x.dtype)
    if code is None or any(t.dtype != x.dtype for t in others):
        raise TypeError(
            f"{what} kernel takes float32 or bfloat16 tensors of one dtype; "
            f"got {[t.dtype for t in (x,) + others]}")
    if not all(t.is_contiguous() for t in (x,) + others):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    return code


def _launch_fwd(x, gamma, beta, eps, stats):
    code = _kernel_dtype("layer_norm", x, gamma, beta)
    R, C = x.shape
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean = torch.empty(R, dtype=torch.float32, device=x.device)
        rstd = torch.empty(R, dtype=torch.float32, device=x.device)
    geo = ln_fwd_geometry(C, x.element_size())
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pt_layer_norm_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr() if stats else None,
            rstd.data_ptr() if stats else None, R, C, float(eps), code,
            *geo, stream)
    _build.check(err, "layer_norm")
    _build.count(layer_norm)
    return y, mean, rstd


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """y [R, C] for x [R, C] and gamma, beta [C] (float32 or bfloat16,
    one dtype). CPU tensors run ``layer_norm_plain``; CUDA tensors run
    K1, counted in ``layer_norm.launches``."""
    _check("layer_norm", x, (("gamma", gamma), ("beta", beta)))
    if _build.takes_plain(x):
        return layer_norm_plain(x, gamma, beta, eps)
    return _launch_fwd(x, gamma, beta, eps, stats=False)[0]


layer_norm.launches = 0


def layer_norm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd): K1 with its per-row float32 stats written, the
    forward of the training path. Counted in ``layer_norm.launches``
    (the same kernel)."""
    _check("layer_norm", x, (("gamma", gamma), ("beta", beta)))
    if _build.takes_plain(x):
        return layer_norm_fwd_plain(x, gamma, beta, eps)
    return _launch_fwd(x, gamma, beta, eps, stats=True)


def layer_norm_bwd(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor,
                   mean: torch.Tensor, rstd: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dgamma, dbeta) for x, dy [R, C], gamma [C] (one dtype) and
    the forward's float32 mean, rstd [R]. CPU tensors run
    ``layer_norm_bwd_plain``; CUDA tensors run K3, counted in
    ``layer_norm_bwd.launches``."""
    _check("layer_norm_bwd", x, (("gamma", gamma),),
           (("mean", mean), ("rstd", rstd)))
    if tuple(dy.shape) != tuple(x.shape) or dy.device != x.device:
        raise ValueError(f"layer_norm_bwd: dy {tuple(dy.shape)} on "
                         f"{dy.device}, x {tuple(x.shape)} on {x.device}")
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, gamma, dy, mean, rstd)
    code = _kernel_dtype("layer_norm_bwd", x, gamma, dy)
    if not (mean.is_contiguous() and rstd.is_contiguous()):
        raise ValueError("layer_norm_bwd kernel takes contiguous stats")
    R, C = x.shape
    geo = ln_bwd_geometry(R, C, x.element_size())
    lib = _build.library()
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(gamma)
    scratch = torch.empty(2 * geo.blocks, C, dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pt_layer_norm_bwd(
            x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), scratch.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(), R, C, code, *geo, stream)
    _build.check(err, "layer_norm_bwd")
    _build.count(layer_norm_bwd)
    return dx, dgamma, dbeta


layer_norm_bwd.launches = 0


class _LayerNormFunction(torch.autograd.Function):
    """y = layer_norm(x2, gamma, beta): forward K1, backward K3."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps):
        y, mean, rstd = layer_norm_fwd(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, gamma, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(x2, gamma, dy.contiguous(), mean,
                                           rstd)
        return dx, dgamma, dbeta, None


def fused_layer_norm(x2: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float) -> torch.Tensor:
    """Differentiable y for x2 [R, C], gamma and beta [C]: K1 forward,
    K3 backward (their plain versions on CPU tensors)."""
    return _LayerNormFunction.apply(x2, gamma, beta, float(eps))
