"""Flash attention, forward and backward: the CUDA kernels of
``csrc/flash_attention.cu`` and their plain PyTorch versions.

K6/K7 (forward) replace ``paddle_tpu/kernels/flash_attention.py``
``_flash_fwd_pallas`` (:169) and ``_flash_fwd_stream`` (:286); K8/K9
(backward) replace ``_flash_bwd_pallas`` (:641) and
``_flash_bwd_stream`` (:454). The TPU routes between a full-panel and
a streaming kernel by sequence length (``_panel_max``, :72); one CUDA
forward and one CUDA backward serve every length here. On q, k, v
``[B, H, S, D]`` (float32 or bfloat16, one dtype), in float32:

  * ``s = q k^T * scale + bias + mask[:, None, None, :]``; causal keys
    past the query are replaced by ``NEG_INF`` (-1e30, not -inf), so a
    row whose keys are all masked averages V uniformly, as the
    reference's ``_reference_attention`` (:82-94) does;
  * ``o = softmax(s) v`` (input dtype) and ``lse = m + log(sum exp(s -
    m))`` (float32 ``[B, H, S]``, only when a backward follows);
  * backward: ``delta = rowsum(dO o)``, ``p = exp(s - lse)``, ``dlogits
    = p (dO v^T - delta)``, ``dq = dlogits * scale k``, ``dk = (dlogits
    * scale)^T q``, ``dv = p^T dO``, ``dbias = dlogits`` summed over the
    dims the bias broadcasts, cast to the bias dtype (:570-578, :747).

The mask is additive float32 ``[B, S]`` at the kernels; the public
``flash_attention`` takes a bool or additive mask of shape ``[S]``,
``[B, S]`` or ``[B, 1, 1, S]`` (``_normalize_mask``, :788-798), and a
bias ``[B|1, H|1, S, S]``. JAX pads S to a multiple of 256
(``_pad_qkv``, :801-819); the kernels bounds-check their tiles instead,
which gives the padded computation's values (padded keys add nothing,
padded query rows are dropped).

``flash_attention`` is differentiable through ``_FlashFunction`` (the
counterpart of the ``_core`` custom_vjp, :828-848): the forward saves
q, k, v, mask, bias, o and lse; the backward returns dq, dk, dv and
dbias, and nothing for the mask. With no gradient to follow (``no_grad``
or no input requiring one) the forward writes no lse (``with_lse=False``,
:171, :830).

The plain versions repeat the kernels' arithmetic (the lse-based
backward included, so a fully masked row gets the same gradient as on
the card); ``flash_attention_plain`` is the reference's plain softmax
attention, the forward oracle of the tests.

Bound on the H100: operations. The forward does ``4 B H S^2 D`` flops
(half when causal), the backward ``10 B H S^2 D``; the bytes are those
of q, k, v, o, dO, dq, dk, dv and lse. Head dims up to 256. Forward
and backward run on the tensor cores: bf16 products for bfloat16 inputs
(P, and in the backward dS, rounded to bfloat16 as operands, as
FlashAttention-2 does; the forward's l and lse sum the unrounded P) and
three TF32 products a float32 product (3xTF32) for float32 inputs,
within the plain versions' tolerances; two runs give the same bits.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["NEG_INF", "MAX_HEAD_DIM", "flash_attention",
           "flash_attention_plain", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "normalize_mask",
           "flash_attention_layer"]

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _scores(q, k, sm_scale, causal, mask, bias):
    """float32 logits [B, H, S, S]: scale, + bias, + mask, causal where."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.float()
    if mask is not None:
        s = s + mask.float()[:, None, None, :]
    if causal:
        S = q.shape[2]
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, torch.full((), NEG_INF, device=q.device))
    return s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, sm_scale: float,
                          mask: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The reference's ``_reference_attention`` (:82-94) in float32:
    softmax attention over ``[B, H, S, D]`` with an additive ``[B, S]``
    mask and a ``[B|1, H|1, S, S]`` bias; o in q's dtype."""
    p = torch.softmax(_scores(q, k, sm_scale, causal, mask, bias), dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def flash_attention_fwd_plain(q, k, v, mask, bias, sm_scale: float,
                              causal: bool, with_lse: bool = True
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of the forward kernel: (o, lse or None)."""
    s = _scores(q, k, sm_scale, causal, mask, bias)
    m = s.max(dim=-1, keepdim=True).values
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    o = (torch.matmul(e, v.float()) / denom).to(q.dtype)
    lse = (m + torch.log(denom))[..., 0] if with_lse else None
    return o, lse


def flash_attention_bwd_plain(q, k, v, mask, bias, o, lse, do,
                              sm_scale: float, causal: bool):
    """The plain version of the backward kernels: (dq, dk, dv, dbias),
    dbias None without a bias, else summed over its broadcast dims."""
    s = _scores(q, k, sm_scale, causal, mask, bias)
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    dlogits = p * (dp - delta)
    ds = dlogits * sm_scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dbias = None
    if bias is not None:
        dims = tuple(i for i in (0, 1) if bias.shape[i] == 1
                     and dlogits.shape[i] != 1)
        dbias = (dlogits.sum(dim=dims, keepdim=True) if dims else dlogits)
        dbias = dbias.to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


# -- checks --------------------------------------------------------------------


def _check(what, q, k, v, mask, bias):
    if q.dim() != 4:
        raise ValueError(f"{what} takes q, k, v [B, H, S, D]; got "
                         f"{tuple(q.shape)}")
    B, H, S, _ = q.shape
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"{what}: {name} {tuple(t.shape)} != q "
                             f"{tuple(q.shape)}")
    if mask is not None and tuple(mask.shape) != (B, S):
        raise ValueError(f"{what}: mask must be [B, S] = [{B}, {S}], got "
                         f"{tuple(mask.shape)}")
    if bias is not None and (bias.dim() != 4 or tuple(bias.shape[2:]) != (S, S)
                             or bias.shape[0] not in (1, B)
                             or bias.shape[1] not in (1, H)):
        raise ValueError(
            f"{what}: bias must be [B|1, H|1, S, S] = [{B}|1, {H}|1, {S}, "
            f"{S}], got {tuple(bias.shape)}")
    for name, t in (("k", k), ("v", v), ("mask", mask), ("bias", bias)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on {q.device}")
    if q.device.type != "cuda" and not _build.takes_plain(q):
        raise ValueError(f"{what}: unsupported device {q.device}")


def _kernel_args(what, q, others, mask, bias):
    """dtype code of the kernel; raises on what the kernels do not take."""
    code = _DTYPES.get(q.dtype)
    if code is None or any(t.dtype != q.dtype for t in others):
        raise TypeError(
            f"{what} kernel takes float32 or bfloat16 q, k, v (one dtype); "
            f"got {[t.dtype for t in (q,) + tuple(others)]}")
    D = q.shape[3]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{what} kernel holds a head's row of accumulators "
                         f"in registers: head dim D <= {MAX_HEAD_DIM}, got "
                         f"{D}")
    for name, t in (("mask", mask), ("bias", bias)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{what} kernel takes a float32 {name}; got "
                            f"{t.dtype}")
    if not all(t.is_contiguous() for t in (q,) + tuple(others)
               + tuple(t for t in (mask, bias) if t is not None)):
        raise ValueError(f"{what} kernel takes contiguous tensors")
    return code


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bias_dims(bias):
    return (1, 1) if bias is None else (int(bias.shape[0]), int(bias.shape[1]))


# -- launch wrappers -------------------------------------------------------------


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor],
                        bias: Optional[torch.Tensor], sm_scale: float,
                        causal: bool, with_lse: bool = True
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(o, lse) for q, k, v [B, H, S, D], an additive float32 mask
    [B, S] or None and a float32 bias [B|1, H|1, S, S] or None; lse is
    None when ``with_lse`` is false. CPU tensors run
    ``flash_attention_fwd_plain``; CUDA tensors run the forward kernel,
    counted in ``flash_attention_fwd.launches``."""
    _check("flash_attention_fwd", q, k, v, mask, bias)
    if _build.takes_plain(q):
        return flash_attention_fwd_plain(q, k, v, mask, bias, sm_scale,
                                         causal, with_lse)
    code = _kernel_args("flash_attention_fwd", q, (k, v), mask, bias)
    B, H, S, D = q.shape
    Bb, Hb = _bias_dims(bias)
    o = torch.empty_like(q)
    lse = (torch.empty(B, H, S, dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(bias),
            o.data_ptr(), _ptr(lse), B, H, S, D, Bb, Hb, float(sm_scale),
            int(bool(causal)), code, stream)
    _build.check(err, "flash_attention_fwd")
    _build.count(flash_attention_fwd)
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, mask, bias, o, lse, do, sm_scale: float,
                        causal: bool):
    """(dq, dk, dv, dbias) from the forward's inputs, o, lse and the
    cotangent do; dbias is None without a bias, else bias-shaped in the
    bias dtype. CPU tensors run ``flash_attention_bwd_plain``; CUDA
    tensors run three kernels (delta, dq with dbias, dk/dv), counted
    once in ``flash_attention_bwd.launches`` and each in
    ``flash_attention_bwd.kernel_launches``."""
    _check("flash_attention_bwd", q, k, v, mask, bias)
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != tuple(q.shape) or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)} "
                             f"on {t.device}, q {tuple(q.shape)} on "
                             f"{q.device}")
    B, H, S, D = q.shape
    if (lse is None or tuple(lse.shape) != (B, H, S)
            or lse.dtype != torch.float32):
        raise ValueError("flash_attention_bwd needs the forward's float32 "
                         f"lse [{B}, {H}, {S}]")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, mask, bias, o, lse, do,
                                         sm_scale, causal)
    code = _kernel_args("flash_attention_bwd", q, (k, v, o, do), mask, bias)
    if not lse.is_contiguous():
        raise ValueError("flash_attention_bwd kernel takes a contiguous lse")
    Bb, Hb = _bias_dims(bias)
    lib = _build.library()
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    dbias32 = (torch.zeros(bias.shape, dtype=torch.float32, device=q.device)
               if bias is not None else None)
    counts = flash_attention_bwd.kernel_launches
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_flash_attention_bwd_delta(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(), B * H * S, D, code,
            stream)
        _build.check(err, "flash_attention_bwd (delta)")
        counts["delta"] += 1
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), _ptr(mask), _ptr(bias))
        tail = (B, H, S, D, Bb, Hb, float(sm_scale), int(bool(causal)), code,
                stream)
        err = lib.pt_flash_attention_bwd_dq(*args, dq.data_ptr(),
                                            _ptr(dbias32), *tail)
        _build.check(err, "flash_attention_bwd (dq)")
        counts["dq"] += 1
        err = lib.pt_flash_attention_bwd_dkv(*args, dk.data_ptr(),
                                             dv.data_ptr(), *tail)
        _build.check(err, "flash_attention_bwd (dk, dv)")
        counts["dkv"] += 1
    _build.count(flash_attention_bwd)
    dbias = None if bias is None else dbias32.to(bias.dtype)
    return dq, dk, dv, dbias


flash_attention_bwd.launches = 0
flash_attention_bwd.kernel_launches = {"delta": 0, "dq": 0, "dkv": 0}


# -- the differentiable function -------------------------------------------------


class _FlashFunction(torch.autograd.Function):
    """o = flash attention: forward kernel, backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, mask, bias, causal, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, mask, bias, sm_scale, causal)
        ctx.save_for_backward(q, k, v, mask, bias, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, bias, o, lse = ctx.saved_tensors
        dq, dk, dv, dbias = flash_attention_bwd(
            q, k, v, mask, bias, o, lse, do.contiguous(), ctx.sm_scale,
            ctx.causal)
        # the padding mask is 0 / NEG_INF: no cotangent (:843-845)
        return dq, dk, dv, None, dbias, None, None


def normalize_mask(mask, B: int, S: int) -> Optional[torch.Tensor]:
    """``_normalize_mask`` (:788-798): a bool (True = attend) or an
    additive float mask of shape [S], [B, S] or [B, 1, 1, S] -> additive
    float32 [B, S], contiguous."""
    if mask is None:
        return None
    if mask.dtype == torch.bool:
        mask = torch.where(mask, torch.zeros((), device=mask.device),
                           torch.full((), NEG_INF, device=mask.device))
    else:
        mask = mask.float()
    return mask.reshape(-1, S).expand(B, S).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    mask: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: [B, H, S, D] -> [B, H, S, D] (``:909-934``).

    mask: optional key-padding mask, bool (True = attend) or additive
    float, [S], [B, S] or [B, 1, 1, S]. bias: optional additive bias
    [B|1, H|1, S, S], differentiable. The default scale is 1/sqrt(D).
    Any S: the kernels bounds-check their tiles, so nothing is padded."""
    B, H, S, D = q.shape
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(D)
    mask = normalize_mask(mask, B, S)
    if bias is not None:
        if q.device.type == "cuda" and bias.dtype != torch.float32:
            # the kernels read a float32 bias; dbias goes back through
            # this cast to the bias dtype (:747)
            bias = bias.float()
        bias = bias.contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias))
    if not needs_grad:
        return flash_attention_fwd(q, k, v, mask, bias, scale, causal,
                                   with_lse=False)[0]
    return _FlashFunction.apply(q, k, v, mask, bias, bool(causal), scale)


def flash_attention_layer(q_var, k_var, v_var, num_heads: int,
                          causal: bool = False, mask_var=None,
                          bias_var=None, mask_type: str = "binary"):
    """Program-level layer emitting the fused ``flash_attention`` op
    (``:937-966``). mask_var: [B, S] key-padding mask, "binary" (1 =
    attend / 0 = padding) or "additive" (0 / -inf added to the logits);
    bias_var: [B|1, H|1, S, S] additive bias."""
    from ..layer_helper import LayerHelper
    from ..layers.nn import _out

    if mask_type not in ("binary", "additive"):
        raise ValueError(f"mask_type must be 'binary' or 'additive', "
                         f"got {mask_type!r}")
    helper = LayerHelper("flash_attention")
    out = _out(helper, q_var, shape=q_var.shape)
    inputs = {"Q": [q_var], "K": [k_var], "V": [v_var]}
    if mask_var is not None:
        inputs["Mask"] = [mask_var]
    if bias_var is not None:
        inputs["BiasQK"] = [bias_var]
    helper.append_op(
        type="flash_attention",
        inputs=inputs,
        outputs={"Out": [out]},
        attrs={"num_heads": num_heads, "causal": causal,
               "mask_type": mask_type},
    )
    return out
