"""Optimizer update ops: the unfused ``sgd``, ``momentum`` and ``adam``
chains (semantics of ``paddle_tpu/ops/optim.py:65-108, :133``) and the
one-pass ``fused_adam`` / ``fused_adamw`` / ``fused_momentum``
(``paddle_tpu/kernels/fused_optim.py:345-475``) over the K10 and K10m
kernels. Output names alias the inputs (ParamOut = Param), and the
Executor writes them back to the scope; the fused ops update their
state in place (the beta pows too, with plain torch), the unfused ops
return new tensors. Gradients are dense: a SelectedRows gradient
(``is_sparse`` embeddings) is ROADMAP A1."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from ..kernels.fused_optim import fused_adam_update, fused_momentum_update

_ADAM_INS = ("Param", "Grad", "LearningRate", "Moment1", "Moment2",
             "Beta1Pow", "Beta2Pow")
_ADAM_OUTS = ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
              "Beta2PowOut")


def _dense(ins):
    """The Grad tensor; anything else (a SelectedRows gradient) is not
    ported."""
    g = ins["Grad"][0]
    if not isinstance(g, torch.Tensor):
        raise NotImplementedError(
            f"a {type(g).__name__} gradient is not ported to "
            "paddle_tpu_torch yet (SelectedRows, ROADMAP A1)")
    return g


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


@register_op("sgd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), stop_gradient=True)
def _sgd(ctx, op, ins):
    p = ins["Param"][0]
    return {"ParamOut": [p - _lr(ins) * _dense(ins).to(p.dtype)]}


def _momentum_attrs(op):
    return (float(op.attrs.get("mu", 0.9)),
            bool(op.attrs.get("use_nesterov", False)))


@register_op("momentum", inputs=("Param", "Grad", "Velocity", "LearningRate"),
             outputs=("ParamOut", "VelocityOut"), stop_gradient=True)
def _momentum(ctx, op, ins):
    p, v, g = ins["Param"][0], ins["Velocity"][0], _dense(ins)
    mu, nesterov = _momentum_attrs(op)
    lr = _lr(ins)
    v_new = mu * v + g
    if nesterov:
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": [p_new], "VelocityOut": [v_new]}


@register_op("fused_momentum",
             inputs=("Param", "Grad", "Velocity", "LearningRate",
                     "ClipScale"),
             outputs=("ParamOut", "VelocityOut"), stop_gradient=True)
def _fused_momentum(ctx, op, ins):
    p, v, g = ins["Param"][0], ins["Velocity"][0], _dense(ins)
    mu, nesterov = _momentum_attrs(op)
    clip = ins["ClipScale"][0] if ins.get("ClipScale") else None
    fused_momentum_update(p, g.contiguous(), v, ins["LearningRate"][0],
                          mu=mu, use_nesterov=nesterov, clip_scale=clip)
    return {"ParamOut": [p], "VelocityOut": [v]}


def _attrs(op):
    return (float(op.attrs.get("beta1", 0.9)), float(op.attrs.get("beta2", 0.999)),
            float(op.attrs.get("epsilon", 1e-8)))


@register_op("adam", inputs=_ADAM_INS, outputs=_ADAM_OUTS, stop_gradient=True)
def _adam(ctx, op, ins):
    p, g = ins["Param"][0], _dense(ins)
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    beta1, beta2, eps = _attrs(op)
    lr = _lr(ins)
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    g = g.to(p.dtype)
    m1n = beta1 * m1 + (1 - beta1) * g
    m2n = beta2 * m2 + (1 - beta2) * torch.square(g)
    # bias-corrected lr, as in reference adam_op.h
    p_new = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return {
        "ParamOut": [p_new],
        "Moment1Out": [m1n],
        "Moment2Out": [m2n],
        "Beta1PowOut": [b1p * beta1],
        "Beta2PowOut": [b2p * beta2],
    }


def _lower_fused_adam(ctx, op, ins, default_coeff):
    p, g = ins["Param"][0], _dense(ins)
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    beta1, beta2, eps = _attrs(op)
    coeff = float(op.attrs.get("coeff", default_coeff))
    clip = ins["ClipScale"][0] if ins.get("ClipScale") else None
    fused_adam_update(p, g.contiguous(), m1, m2, ins["LearningRate"][0],
                      b1p, b2p, beta1=beta1, beta2=beta2, epsilon=eps,
                      clip_scale=clip, weight_decay=coeff)
    b1p.mul_(beta1)
    b2p.mul_(beta2)
    return {
        "ParamOut": [p],
        "Moment1Out": [m1],
        "Moment2Out": [m2],
        "Beta1PowOut": [b1p],
        "Beta2PowOut": [b2p],
    }


@register_op("fused_adam", inputs=_ADAM_INS + ("ClipScale",),
             outputs=_ADAM_OUTS, stop_gradient=True)
def _fused_adam(ctx, op, ins):
    return _lower_fused_adam(ctx, op, ins, 0.0)


@register_op("fused_adamw", inputs=_ADAM_INS + ("ClipScale",),
             outputs=_ADAM_OUTS, stop_gradient=True)
def _fused_adamw(ctx, op, ins):
    return _lower_fused_adam(ctx, op, ins, 0.01)
