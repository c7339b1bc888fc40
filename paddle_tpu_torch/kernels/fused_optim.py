"""One-pass optimizer updates in place: the CUDA kernels of
``csrc/fused_optim.cu``, Adam / AdamW (K10) and momentum (K10m), each
beside its plain PyTorch version.

Replaces ``paddle_tpu/kernels/fused_optim.py`` ``_run_fused`` (:134,
``pallas_call`` at :153) with its Adam body ``_adam_kernel`` (:93), as
the ``fused_adam`` / ``fused_adamw`` ops reach it:

    g  = g * clip_scale   (then rounded to the param dtype)
    m' = b1 * m + (1 - b1) * g;   v' = b2 * v + (1 - b2) * g^2
    p' = p - lr_t * m' / (sqrt(v') + eps)   [- lr * coeff * p  (AdamW)]
    lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)

p, m1 and m2 are updated IN PLACE, as the TPU kernel's
``input_output_aliases`` update the donated buffers; the beta-pow
accumulators stay with the caller. lr, the beta pows and the clip scale
are float32 tensors on the parameter's device: the kernel reads them
there and forms lr_t itself, so no value is read back to the host.

The plain version is op for op the reference's ``_reference_adam``
(:184-193), the unfused ``adam`` op's chain, so on one backend the
fused and unfused paths agree bit for bit (the kernel keeps that order
of roundings too, in float32).

Bound on the H100: memory, ``7 * n * itemsize`` bytes (p, g, m, v read;
p, m, v written).

K10m replaces the momentum body of the same TPU pallas_call
(``_momentum_kernel``, :117), as the ``fused_momentum`` op reaches it:

    g    = g * clip_scale   (then rounded to the param dtype)
    vel' = mu * vel + g
    p'   = p - lr * vel'    (nesterov: p - lr * (g + mu * vel'))

p and vel are updated in place; lr and the clip scale are float32
tensors on the parameter's device. The plain version is, in float32, op
for op the reference's ``_reference_momentum`` (:196-205), the unfused
``momentum`` op's chain; for a bfloat16 parameter it computes in float32
and rounds once at the end, as the TPU kernel does. The CUDA kernel
keeps that order of roundings, so it equals the plain version bit for
bit in both dtypes. Bound: memory, ``5 * n * itemsize`` bytes (p, g, vel
read; p, vel written).

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

__all__ = ["fused_adam_update", "fused_adam_update_plain",
           "fused_momentum_update", "fused_momentum_update_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lr_t(lr, beta1_pow, beta2_pow):
    return lr * torch.sqrt(1 - beta2_pow) / (1 - beta1_pow)


def fused_adam_update_plain(p, g, m1, m2, lr, beta1_pow, beta2_pow, *,
                            beta1=0.9, beta2=0.999, epsilon=1e-8,
                            clip_scale=None, weight_decay=0.0) -> None:
    """The plain PyTorch version: ``_reference_adam``'s chain of ops,
    written back into p, m1 and m2."""
    lr = lr.reshape(())
    lr_t = _lr_t(lr, beta1_pow.reshape(()), beta2_pow.reshape(()))
    if clip_scale is not None:
        g = g * clip_scale.reshape(())
    g = g.to(p.dtype)
    m1n = beta1 * m1 + (1 - beta1) * g
    m2n = beta2 * m2 + (1 - beta2) * torch.square(g)
    p_new = p - lr_t * m1n / (torch.sqrt(m2n) + epsilon)
    if weight_decay:
        p_new = p_new - lr * weight_decay * p
    p.copy_(p_new)
    m1.copy_(m1n)
    m2.copy_(m2n)


def _scalar(name, t, device, what="fused_adam_update"):
    if t.numel() != 1 or t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{what}: {name} must be one float32 "
                         f"value on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def fused_adam_update(p: torch.Tensor, g: torch.Tensor, m1: torch.Tensor,
                      m2: torch.Tensor, lr: torch.Tensor,
                      beta1_pow: torch.Tensor, beta2_pow: torch.Tensor, *,
                      beta1: float = 0.9, beta2: float = 0.999,
                      epsilon: float = 1e-8,
                      clip_scale: Optional[torch.Tensor] = None,
                      weight_decay: float = 0.0) -> None:
    """Update p, m1, m2 in place by one Adam(W) step. p, g, m1, m2 share
    a shape and a dtype (float32 or bfloat16); lr, beta1_pow, beta2_pow
    and the optional clip_scale are float32 one-element tensors on the
    same device. ``weight_decay`` > 0 selects the AdamW tail. CPU
    tensors run the plain version; CUDA tensors run K10, counted in
    ``fused_adam_update.launches``."""
    for name, t in (("g", g), ("m1", m1), ("m2", m2)):
        if t.shape != p.shape or t.device != p.device:
            raise ValueError(f"fused_adam_update: {name} {tuple(t.shape)} on "
                             f"{t.device}, p {tuple(p.shape)} on {p.device}")
    scalars = [("lr", lr), ("beta1_pow", beta1_pow),
               ("beta2_pow", beta2_pow)]
    if clip_scale is not None:
        scalars.append(("clip_scale", clip_scale))
    for name, t in scalars:
        _scalar(name, t, p.device)
    if p.device.type == "cpu":
        fused_adam_update_plain(p, g, m1, m2, lr, beta1_pow, beta2_pow,
                                beta1=beta1, beta2=beta2, epsilon=epsilon,
                                clip_scale=clip_scale,
                                weight_decay=weight_decay)
        return
    if p.device.type != "cuda":
        raise ValueError(f"fused_adam_update: unsupported device {p.device}")
    code = _DTYPES.get(p.dtype)
    if code is None or any(t.dtype != p.dtype for t in (g, m1, m2)):
        raise TypeError(
            "fused_adam_update kernel takes float32 or bfloat16 p, g, m1, m2 "
            f"of one dtype; got {[t.dtype for t in (p, g, m1, m2)]}")
    if not all(t.is_contiguous() for t in (p, g, m1, m2)):
        raise ValueError("fused_adam_update kernel takes contiguous tensors")
    lib = _build.library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.pt_fused_adam(
            p.data_ptr(), g.data_ptr(), m1.data_ptr(), m2.data_ptr(),
            lr.data_ptr(), beta1_pow.data_ptr(), beta2_pow.data_ptr(),
            clip_scale.data_ptr() if clip_scale is not None else None,
            p.numel(), float(beta1), float(beta2), float(1 - beta1),
            float(1 - beta2), float(epsilon), float(weight_decay), code,
            stream)
    _build.check(err, "fused_adam_update")
    _build.count(fused_adam_update)


fused_adam_update.launches = 0


def fused_momentum_update_plain(p, g, vel, lr, *, mu=0.9, use_nesterov=False,
                                clip_scale=None) -> None:
    """The plain PyTorch version, written back into p and vel: in
    float32 ``_reference_momentum``'s chain of ops; a bfloat16 parameter
    is updated in float32 and rounded once, as the TPU kernel does."""
    lr = lr.reshape(())
    g = g.float()
    if clip_scale is not None:
        g = g * clip_scale.reshape(())
    g = g.to(p.dtype).float()
    vel_new = mu * vel.float() + g
    if use_nesterov:
        p_new = p.float() - lr * (g + mu * vel_new)
    else:
        p_new = p.float() - lr * vel_new
    p.copy_(p_new)
    vel.copy_(vel_new)


def fused_momentum_update(p: torch.Tensor, g: torch.Tensor,
                          vel: torch.Tensor, lr: torch.Tensor, *,
                          mu: float = 0.9, use_nesterov: bool = False,
                          clip_scale: Optional[torch.Tensor] = None) -> None:
    """Update p and vel in place by one momentum step. p, g, vel share a
    shape and a dtype (float32 or bfloat16); lr and the optional
    clip_scale are float32 one-element tensors on the same device. CPU
    tensors run the plain version; CUDA tensors run K10m, counted in
    ``fused_momentum_update.launches``."""
    what = "fused_momentum_update"
    for name, t in (("g", g), ("vel", vel)):
        if t.shape != p.shape or t.device != p.device:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} on "
                             f"{t.device}, p {tuple(p.shape)} on {p.device}")
    _scalar("lr", lr, p.device, what)
    if clip_scale is not None:
        _scalar("clip_scale", clip_scale, p.device, what)
    if p.device.type == "cpu":
        fused_momentum_update_plain(p, g, vel, lr, mu=mu,
                                    use_nesterov=use_nesterov,
                                    clip_scale=clip_scale)
        return
    if p.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {p.device}")
    code = _DTYPES.get(p.dtype)
    if code is None or g.dtype != p.dtype or vel.dtype != p.dtype:
        raise TypeError(f"{what} kernel takes float32 or bfloat16 p, g, vel "
                        f"of one dtype; got {[p.dtype, g.dtype, vel.dtype]}")
    if not all(t.is_contiguous() for t in (p, g, vel)):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    lib = _build.library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.pt_fused_momentum(
            p.data_ptr(), g.data_ptr(), vel.data_ptr(), lr.data_ptr(),
            clip_scale.data_ptr() if clip_scale is not None else None,
            p.numel(), float(mu), int(bool(use_nesterov)), code, stream)
    _build.check(err, what)
    _build.count(fused_momentum_update)


fused_momentum_update.launches = 0
