"""Softmax cross-entropy with hard labels, forward and backward: the
CUDA kernels of ``csrc/softmax_xent.cu`` and their plain PyTorch
versions.

K4 replaces ``paddle_tpu/kernels/softmax_xent.py`` ``_fwd_impl`` (:94,
``pallas_call`` at :100): per row of logits ``[R, C]``,
``lse = m + log(sum exp(s - m))`` with ``m = max(s)`` and
``loss = lse - s[label]``. K5 replaces ``_vjp_bwd`` (:127,
``pallas_call`` at :135): ``dlogits = (exp(s - lse) - onehot(label)) *
dloss``. Both work in float32; loss and lse are float32 ``[R]`` and
dlogits has the logits' dtype. Labels are int64 and read as they are.

``ignore_index``: a row whose label equals it gets loss 0 and dlogits 0.
The reference op (``ops/nn.py:248,271``) masks those rows around its
kernel; the port folds the mask into the kernels, which gives the same
values with no pass over the labels. A label outside ``[0, C)`` picks
nothing (loss = lse), as the TPU kernel's iota compare does.

``fused_softmax_xent`` is the ``torch.autograd.Function`` over both, the
counterpart of the reference's ``jax.custom_vjp`` of that name (loss
only; lse is a saved residual).

Bound on the H100: memory. K4 reads the logits once
(``R * C * itemsize``) and writes 8 bytes a row; K5 reads them and
writes dlogits of the same size. K4 keeps an online max and sum per
thread, so each row is read from HBM once.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

__all__ = ["softmax_xent_fwd", "softmax_xent_fwd_plain", "softmax_xent_bwd",
           "softmax_xent_bwd_plain", "fused_softmax_xent"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def softmax_xent_fwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                           ignore_index: int = -100
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version (and numerics oracle) of K4."""
    s = logits.float()
    m = s.max(dim=1).values
    lse = m + torch.log(torch.exp(s - m[:, None]).sum(dim=1))
    C = s.shape[1]
    valid = (labels >= 0) & (labels < C)
    picked = torch.where(
        valid, s.gather(1, labels.clamp(0, C - 1)[:, None])[:, 0],
        torch.zeros((), dtype=s.dtype, device=s.device))
    loss = torch.where(labels == ignore_index,
                       torch.zeros((), dtype=s.dtype, device=s.device),
                       lse - picked)
    return loss, lse


def softmax_xent_bwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                           lse: torch.Tensor, dloss: torch.Tensor,
                           ignore_index: int = -100) -> torch.Tensor:
    """The plain PyTorch version of K5."""
    s = logits.float()
    cols = torch.arange(s.shape[1], device=s.device)
    onehot = (cols[None, :] == labels[:, None]).float()
    d = torch.where(labels == ignore_index,
                    torch.zeros((), dtype=torch.float32, device=s.device),
                    dloss.float())
    ds = (torch.exp(s - lse[:, None]) - onehot) * d[:, None]
    return ds.to(logits.dtype)


def _check(what, logits, labels, *vecs):
    if logits.dim() != 2:
        raise ValueError(f"{what} takes logits [R, C]; got "
                         f"{tuple(logits.shape)}")
    R = logits.shape[0]
    if tuple(labels.shape) != (R,) or labels.dtype != torch.int64:
        raise ValueError(f"{what}: labels must be int64 [{R}], got "
                         f"{labels.dtype} {tuple(labels.shape)}")
    for t in (labels,) + vecs:
        if t.device != logits.device:
            raise ValueError(f"{what}: inputs on {t.device} and "
                             f"{logits.device}")
    for t in vecs:
        if tuple(t.shape) != (R,):
            raise ValueError(f"{what}: per-row input must be [{R}], got "
                             f"{tuple(t.shape)}")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {logits.device}")


def _kernel_dtype(what, logits, *ints):
    code = _DTYPES.get(logits.dtype)
    if code is None:
        raise TypeError(f"{what} kernel takes float32 or bfloat16 logits, "
                        f"got {logits.dtype}")
    if not all(t.is_contiguous() for t in (logits,) + ints):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    return code


def softmax_xent_fwd(logits: torch.Tensor, labels: torch.Tensor,
                     ignore_index: int = -100
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, lse), float32 [R], for logits [R, C] (float32 or
    bfloat16) and int64 labels [R]. CPU tensors run the plain version;
    CUDA tensors run K4, counted in ``softmax_xent_fwd.launches``."""
    _check("softmax_xent_fwd", logits, labels)
    if logits.device.type == "cpu":
        return softmax_xent_fwd_plain(logits, labels, ignore_index)
    code = _kernel_dtype("softmax_xent_fwd", logits, labels)
    R, C = logits.shape
    loss = torch.empty(R, dtype=torch.float32, device=logits.device)
    lse = torch.empty(R, dtype=torch.float32, device=logits.device)
    lib = _build.library()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.pt_softmax_xent_fwd(
            logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), R, C, int(ignore_index), code, stream)
    _build.check(err, "softmax_xent_fwd")
    _build.count(softmax_xent_fwd)
    return loss, lse


softmax_xent_fwd.launches = 0


def softmax_xent_bwd(logits: torch.Tensor, labels: torch.Tensor,
                     lse: torch.Tensor, dloss: torch.Tensor,
                     ignore_index: int = -100) -> torch.Tensor:
    """dlogits [R, C] (the logits' dtype) for the forward's float32 lse
    and the loss cotangent dloss [R]. CPU tensors run the plain version;
    CUDA tensors run K5, counted in ``softmax_xent_bwd.launches``."""
    _check("softmax_xent_bwd", logits, labels, lse, dloss)
    if logits.device.type == "cpu":
        return softmax_xent_bwd_plain(logits, labels, lse, dloss,
                                      ignore_index)
    code = _kernel_dtype("softmax_xent_bwd", logits, labels)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("softmax_xent_bwd kernel takes a contiguous "
                         "float32 lse")
    dloss = dloss.to(torch.float32).contiguous()
    R, C = logits.shape
    dlogits = torch.empty_like(logits)
    lib = _build.library()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.pt_softmax_xent_bwd(
            logits.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            dloss.data_ptr(), dlogits.data_ptr(), R, C, int(ignore_index),
            code, stream)
    _build.check(err, "softmax_xent_bwd")
    _build.count(softmax_xent_bwd)
    return dlogits


softmax_xent_bwd.launches = 0


class _SoftmaxXentFunction(torch.autograd.Function):
    """loss = softmax cross-entropy(logits2, labels): forward K4,
    backward K5. The loss has the logits' dtype, as the reference's."""

    @staticmethod
    def forward(ctx, logits2, labels, ignore_index):
        loss, lse = softmax_xent_fwd(logits2, labels, ignore_index)
        ctx.save_for_backward(logits2, labels, lse)
        ctx.ignore_index = ignore_index
        return loss.to(logits2.dtype)

    @staticmethod
    def backward(ctx, dloss):
        logits2, labels, lse = ctx.saved_tensors
        return (softmax_xent_bwd(logits2, labels, lse, dloss,
                                 ctx.ignore_index), None, None)


def fused_softmax_xent(logits2: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Differentiable per-row loss [R] for logits2 [R, C] and int64
    labels [R]: K4 forward, K5 backward (their plain versions on CPU
    tensors)."""
    return _SoftmaxXentFunction.apply(logits2, labels, int(ignore_index))
