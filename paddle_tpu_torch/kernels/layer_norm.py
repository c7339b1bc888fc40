"""Layer-norm forward: the CUDA kernel ``csrc/layer_norm.cu`` and its
plain PyTorch version.

Replaces ``paddle_tpu/kernels/layer_norm.py`` ``_fwd_impl`` (the
Pallas forward, ``pallas_call`` at :124) as the ``layer_norm`` op of
``ops/nn.py:427-445`` reaches it: per row of ``[R, C]``,
``y = (x - mean) * rsqrt(var + eps) * gamma + beta`` with population
variance and float32 accumulation; y has x's dtype.

Bound on the H100: memory, ``2 * R * C * itemsize`` bytes (x read
once, y written once) plus gamma and beta. The kernel runs one block
per row and loops over the row, so C has no cap (the TPU's VMEM bound
``MAX_C`` does not carry over); at the serving slice's ``[128, 2048]``
float32 the work is 2 MB, so the launch sets its time. Forward only:
the serving path needs neither Mean/Variance nor the backward (the
backward, TPU kernel ``_vjp_bwd``, comes with the training slice).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["layer_norm", "layer_norm_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_plain(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The plain PyTorch version (and numerics oracle) of the kernel."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(x.dtype)


def _check(x, gamma, beta):
    if x.dim() != 2:
        raise ValueError(f"layer_norm takes x [R, C]; got {tuple(x.shape)}")
    C = x.shape[1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if tuple(t.shape) != (C,):
            raise ValueError(f"layer_norm: {name} must be [{C}], got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"layer_norm: {name} on {t.device}, x on "
                             f"{x.device}")


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """y [R, C] for x [R, C] and gamma, beta [C] (float32 or bfloat16,
    one dtype). CPU tensors run ``layer_norm_plain``; CUDA tensors run
    the kernel, counted in ``layer_norm.launches``."""
    _check(x, gamma, beta)
    if x.device.type == "cpu":
        return layer_norm_plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    code = _DTYPES.get(x.dtype)
    if code is None or gamma.dtype != x.dtype or beta.dtype != x.dtype:
        raise TypeError(
            f"layer_norm kernel takes float32 or bfloat16 x, gamma, beta of "
            f"one dtype; got {x.dtype}, {gamma.dtype}, {beta.dtype}")
    if not (x.is_contiguous() and gamma.is_contiguous()
            and beta.is_contiguous()):
        raise ValueError("layer_norm kernel takes contiguous tensors")
    R, C = x.shape
    y = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pt_layer_norm_fwd(x.data_ptr(), gamma.data_ptr(),
                                    beta.data_ptr(), y.data_ptr(), R, C,
                                    float(eps), code, stream)
    _build.check(err, "layer_norm")
    layer_norm.launches += 1
    return y


layer_norm.launches = 0
