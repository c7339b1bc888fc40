"""Optimizer update ops: the unfused ``sgd``, ``momentum`` and ``adam``
chains (semantics of ``paddle_tpu/ops/optim.py:65-108, :133``), the
other optimizers' dense updates (``lars_momentum``, ``adagrad``,
``decayed_adagrad``, ``adadelta``, ``adamax``, ``rmsprop``, ``ftrl``,
``lamb``, ``dpsgd``, ``proximal_gd``, ``proximal_adagrad``; :111-497,
in JAX's arithmetic order) and the one-pass ``fused_adam`` /
``fused_adamw`` / ``fused_momentum``
(``paddle_tpu/kernels/fused_optim.py:345-475``) over the K10 and K10m
kernels. Output names alias the inputs (ParamOut = Param), and the
Executor writes them back to the scope; the fused ops update their
state in place (the beta pows too, with plain torch), the unfused ops
return new tensors.

A SelectedRows gradient (an ``is_sparse`` embedding's) takes the sparse
path of ``sgd``, ``momentum``, ``adam`` and ``adagrad``
(``paddle_tpu/ops/optim.py:27-47``, :62-210): only the touched rows of
the parameter and its state change, in place, and the others keep their
bits (``lazy_mode``: their moments do not decay). SGD adds each slice to
its row in order, as JAX's scatter-add; the stateful updates merge the
duplicate rows first. ``fused_adam`` / ``fused_momentum`` hand such a
gradient to that path with the folded clip scale applied to its values
(``paddle_tpu/kernels/fused_optim.py:281-293``), so K10 and K10m never
see one. Every other update densifies it (``_dense``).

A division by an attribute goes through a tensor of the operand's
dtype: torch divides by a Python scalar (and divides a Python scalar
by a tensor) through a reciprocal, where JAX divides."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows, segment_sum_rows
from ..kernels.fused_optim import fused_adam_update, fused_momentum_update

_ADAM_INS = ("Param", "Grad", "LearningRate", "Moment1", "Moment2",
             "Beta1Pow", "Beta2Pow")
_ADAM_OUTS = ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
              "Beta2PowOut")


def _dense(ins):
    """The Grad as a dense tensor: an update without a sparse path
    densifies a SelectedRows gradient (``_densify_grad``,
    ``paddle_tpu/ops/optim.py:50-58``)."""
    g = ins["Grad"][0]
    return g.to_dense() if isinstance(g, SelectedRows) else g


def _sparse(ins):
    """The Grad when it is a SelectedRows, merged, else None."""
    g = ins["Grad"][0]
    return g.merge() if isinstance(g, SelectedRows) else None


def _with_clip(ins):
    """The fused ops' sparse hand-off: the unfused op's inputs, with the
    folded clip scale applied to the gradient's values."""
    g = ins["Grad"][0]
    ins = dict(ins)
    if ins.get("ClipScale"):
        s = ins["ClipScale"][0].reshape(())
        ins["Grad"] = [SelectedRows(g.rows, g.values * s, g.height)]
    return ins


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


@register_op("sgd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), stop_gradient=True)
def _sgd(ctx, op, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    if isinstance(g, SelectedRows):
        # no merge: each slice adds to its row in order, ((p + u1) + u2),
        # as JAX's scatter-add of -lr * values
        u = -_lr(ins) * g.values.to(p.dtype)
        rows, new = segment_sum_rows(g.rows, u, base=p)
        return {"ParamOut": [p.index_copy_(0, rows, new)]}
    return {"ParamOut": [p - _lr(ins) * g.to(p.dtype)]}


def _momentum_attrs(op):
    return (float(op.attrs.get("mu", 0.9)),
            bool(op.attrs.get("use_nesterov", False)))


@register_op("momentum", inputs=("Param", "Grad", "Velocity", "LearningRate"),
             outputs=("ParamOut", "VelocityOut"), stop_gradient=True)
def _momentum(ctx, op, ins):
    p, v = ins["Param"][0], ins["Velocity"][0]
    mu, nesterov = _momentum_attrs(op)
    lr = _lr(ins)
    sg = _sparse(ins)
    if sg is not None:
        rows, gv = sg.rows, sg.values.to(p.dtype)
        v_new = mu * v[rows] + gv
        if nesterov:
            p_new = p[rows] - (gv + mu * v_new) * lr
        else:
            p_new = p[rows] - lr * v_new
        return {"ParamOut": [p.index_copy_(0, rows, p_new)],
                "VelocityOut": [v.index_copy_(0, rows, v_new)]}
    g = ins["Grad"][0]
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
    if isinstance(ins["Grad"][0], SelectedRows):
        return _momentum(ctx, op, _with_clip(ins))
    p, v, g = ins["Param"][0], ins["Velocity"][0], ins["Grad"][0]
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
    p = ins["Param"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    beta1, beta2, eps = _attrs(op)
    lr = _lr(ins)
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    pows = {"Beta1PowOut": [b1p * beta1], "Beta2PowOut": [b2p * beta2]}
    sg = _sparse(ins)
    if sg is not None:
        # Fluid's SparseAdamFunctor in lazy mode: the touched rows only
        rows, gv = sg.rows, sg.values.to(p.dtype)
        m1n = beta1 * m1[rows] + (1 - beta1) * gv
        m2n = beta2 * m2[rows] + (1 - beta2) * torch.square(gv)
        p_new = p[rows] - lr_t * m1n / (torch.sqrt(m2n) + eps)
        return {"ParamOut": [p.index_copy_(0, rows, p_new)],
                "Moment1Out": [m1.index_copy_(0, rows, m1n)],
                "Moment2Out": [m2.index_copy_(0, rows, m2n)], **pows}
    g = ins["Grad"][0].to(p.dtype)
    m1n = beta1 * m1 + (1 - beta1) * g
    m2n = beta2 * m2 + (1 - beta2) * torch.square(g)
    # bias-corrected lr, as in reference adam_op.h
    p_new = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return {
        "ParamOut": [p_new],
        "Moment1Out": [m1n],
        "Moment2Out": [m2n],
        **pows,
    }


def _lower_fused_adam(ctx, op, ins, default_coeff):
    if isinstance(ins["Grad"][0], SelectedRows):
        # the lazy sparse adam, then the decoupled decay applied densely
        # to the whole parameter from its value before the update, as
        # the JAX package does (``kernels/fused_optim.py:345-358``)
        coeff = float(op.attrs.get("coeff", default_coeff))
        decay = _lr(ins) * coeff * ins["Param"][0] if coeff else None
        out = _adam(ctx, op, _with_clip(ins))
        if decay is not None:
            out["ParamOut"] = [out["ParamOut"][0].sub_(decay)]
        return out
    p, g = ins["Param"][0], ins["Grad"][0]
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


def _const(like, value):
    """A 0-dim tensor of ``like``'s dtype and device."""
    return torch.full((), float(value), dtype=like.dtype, device=like.device)


def _l2(x):
    return torch.sqrt(torch.sum(torch.square(x)))


@register_op("lars_momentum", inputs=("Param", "Grad", "Velocity",
                                      "LearningRate"),
             outputs=("ParamOut", "VelocityOut"), stop_gradient=True)
def _lars_momentum(ctx, op, ins):
    """Layer-adaptive lr scaling (reference lars_momentum_op.cc)."""
    p, g, v = ins["Param"][0], _dense(ins), ins["Velocity"][0]
    mu = float(op.attrs.get("mu", 0.9))
    coeff = float(op.attrs.get("lars_coeff", 0.001))
    wd = float(op.attrs.get("lars_weight_decay", 0.0005))
    eps = 1e-9
    p_norm, g_norm = _l2(p), _l2(g)
    local_lr = _lr(ins) * coeff * p_norm / (g_norm + wd * p_norm + eps)
    v_new = mu * v + local_lr * (g + wd * p)
    return {"ParamOut": [p - v_new], "VelocityOut": [v_new]}


@register_op("adagrad", inputs=("Param", "Grad", "Moment", "LearningRate"),
             outputs=("ParamOut", "MomentOut"), stop_gradient=True)
def _adagrad(ctx, op, ins):
    p, m = ins["Param"][0], ins["Moment"][0]
    eps = float(op.attrs.get("epsilon", 1e-6))
    sg = _sparse(ins)
    if sg is not None:
        # Fluid's SparseAdagradFunctor: the touched rows only
        rows, gv = sg.rows, sg.values.to(p.dtype)
        m_new = m[rows] + torch.square(gv)
        p_new = p[rows] - _lr(ins) * gv / (torch.sqrt(m_new) + eps)
        return {"ParamOut": [p.index_copy_(0, rows, p_new)],
                "MomentOut": [m.index_copy_(0, rows, m_new)]}
    g = ins["Grad"][0]
    m_new = m + torch.square(g)
    return {"ParamOut": [p - _lr(ins) * g / (torch.sqrt(m_new) + eps)],
            "MomentOut": [m_new]}


@register_op("decayed_adagrad", inputs=("Param", "Grad", "Moment",
                                        "LearningRate"),
             outputs=("ParamOut", "MomentOut"), stop_gradient=True)
def _decayed_adagrad(ctx, op, ins):
    p, g, m = ins["Param"][0], _dense(ins), ins["Moment"][0]
    decay = float(op.attrs.get("decay", 0.95))
    eps = float(op.attrs.get("epsilon", 1e-6))
    m_new = decay * m + (1 - decay) * torch.square(g)
    return {"ParamOut": [p - _lr(ins) * g / (torch.sqrt(m_new) + eps)],
            "MomentOut": [m_new]}


@register_op("adadelta", inputs=("Param", "Grad", "AvgSquaredGrad",
                                 "AvgSquaredUpdate"),
             outputs=("ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"),
             stop_gradient=True)
def _adadelta(ctx, op, ins):
    p, g = ins["Param"][0], _dense(ins)
    asg, asu = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = float(op.attrs.get("rho", 0.95))
    eps = float(op.attrs.get("epsilon", 1e-6))
    asg_n = rho * asg + (1 - rho) * torch.square(g)
    upd = -torch.sqrt((asu + eps) / (asg_n + eps)) * g
    asu_n = rho * asu + (1 - rho) * torch.square(upd)
    return {"ParamOut": [p + upd], "AvgSquaredGradOut": [asg_n],
            "AvgSquaredUpdateOut": [asu_n]}


@register_op("adamax", inputs=("Param", "Grad", "LearningRate", "Moment",
                               "InfNorm", "Beta1Pow"),
             outputs=("ParamOut", "MomentOut", "InfNormOut"),
             stop_gradient=True)
def _adamax(ctx, op, ins):
    """The beta1 power advances in a ``scale`` op the optimizer appends
    after every update (``AdamaxOptimizer._finish_update``)."""
    p, g = ins["Param"][0], _dense(ins)
    m, u, b1p = ins["Moment"][0], ins["InfNorm"][0], ins["Beta1Pow"][0]
    beta1, beta2, eps = _attrs(op)
    m_new = beta1 * m + (1 - beta1) * g
    u_new = torch.maximum(beta2 * u, torch.abs(g))
    lr_t = _lr(ins) / (1 - b1p.reshape(()))
    return {"ParamOut": [p - lr_t * m_new / (u_new + eps)],
            "MomentOut": [m_new], "InfNormOut": [u_new]}


@register_op("rmsprop", inputs=("Param", "Grad", "Moment", "MeanSquare",
                                "MeanGrad", "LearningRate"),
             outputs=("ParamOut", "MomentOut", "MeanSquareOut", "MeanGradOut"),
             stop_gradient=True)
def _rmsprop(ctx, op, ins):
    p, g = ins["Param"][0], _dense(ins)
    mom, ms = ins["Moment"][0], ins["MeanSquare"][0]
    eps = float(op.attrs.get("epsilon", 1e-10))
    decay = float(op.attrs.get("decay", 0.9))
    momentum = float(op.attrs.get("momentum", 0.0))
    ms_new = decay * ms + (1 - decay) * torch.square(g)
    if op.attrs.get("centered", False):
        mg_new = decay * ins["MeanGrad"][0] + (1 - decay) * g
        denom = torch.sqrt(ms_new - torch.square(mg_new) + eps)
    else:
        mg_new = (ins["MeanGrad"][0] if ins.get("MeanGrad")
                  else torch.zeros_like(p))
        denom = torch.sqrt(ms_new + eps)
    mom_new = momentum * mom + _lr(ins) * g / denom
    return {"ParamOut": [p - mom_new], "MomentOut": [mom_new],
            "MeanSquareOut": [ms_new], "MeanGradOut": [mg_new]}


@register_op("ftrl", inputs=("Param", "SquaredAccumulator",
                             "LinearAccumulator", "Grad", "LearningRate"),
             outputs=("ParamOut", "SquaredAccumOut", "LinearAccumOut"),
             stop_gradient=True)
def _ftrl(ctx, op, ins):
    p, g = ins["Param"][0], _dense(ins)
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    l1 = float(op.attrs.get("l1", 0.0)) + 1e-10
    l2 = float(op.attrs.get("l2", 0.0)) + 1e-10
    lr_power = float(op.attrs.get("lr_power", -0.5))
    lr = _lr(ins)
    sq_new = sq + torch.square(g)
    if lr_power == -0.5:
        sigma = (torch.sqrt(sq_new) - torch.sqrt(sq)) / lr
        denom = torch.sqrt(sq_new) / lr + 2 * l2
    else:
        sigma = (sq_new ** -lr_power - sq ** -lr_power) / lr
        denom = sq_new ** -lr_power / lr + 2 * l2
    lin_new = lin + g - sigma * p
    pre = torch.clamp(lin_new, -l1, l1) - lin_new
    return {"ParamOut": [pre / denom], "SquaredAccumOut": [sq_new],
            "LinearAccumOut": [lin_new]}


@register_op("lamb", inputs=_ADAM_INS, outputs=_ADAM_OUTS, stop_gradient=True)
def _lamb(ctx, op, ins):
    """Layer-wise adaptive large-batch Adam (reference lamb_op.cc): the
    trust ratio ||p|| / ||r|| takes whole-tensor norms (1 where either
    is 0)."""
    p, g = ins["Param"][0], _dense(ins)
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    beta1, beta2 = _attrs(op)[:2]
    eps = float(op.attrs.get("epsilon", 1e-6))
    wd = float(op.attrs.get("weight_decay", 0.01))
    g = g.to(p.dtype)
    m1n = beta1 * m1 + (1 - beta1) * g
    m2n = beta2 * m2 + (1 - beta2) * torch.square(g)
    m1h = m1n / (1 - b1p.reshape(()))
    m2h = m2n / (1 - b2p.reshape(()))
    r = m1h / (torch.sqrt(m2h) + eps) + wd * p
    p_norm, r_norm = _l2(p), _l2(r)
    ratio = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        _const(p_norm, 1.0))
    return {"ParamOut": [p - _lr(ins) * ratio * r], "Moment1Out": [m1n],
            "Moment2Out": [m2n], "Beta1PowOut": [b1p * beta1],
            "Beta2PowOut": [b2p * beta2]}


@register_op("dpsgd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), stop_gradient=True)
def _dpsgd(ctx, op, ins):
    """Differentially private SGD (reference dpsgd_op.cc): the gradient
    clipped to norm ``clip``, plus Gaussian noise of std ``sigma *
    clip`` over ``batch_size``, drawn from the op's generator (its bits
    differ from JAX's PRNG; its distribution does not)."""
    p, g = ins["Param"][0], _dense(ins)
    clip = float(op.attrs.get("clip", 10.0))
    batch_size = float(op.attrs.get("batch_size", 16.0))
    sigma = float(op.attrs.get("sigma", 1.0))
    g_norm = _l2(g)
    factor = torch.clamp_max(
        _const(g_norm, clip) / torch.clamp_min(g_norm, 1e-12), 1.0)
    g = g * factor
    noise = sigma * clip * torch.randn(g.shape, generator=ctx.op_generator(op),
                                       device=g.device, dtype=g.dtype)
    return {"ParamOut": [p - _lr(ins) * (g + noise / _const(g, batch_size))]}


def _proximal(prox, lr, op):
    """sign(prox) * max(|prox| - lr * l1, 0) / (1 + lr * l2)."""
    l1 = float(op.attrs.get("l1", 0.0))
    l2 = float(op.attrs.get("l2", 0.0))
    return (torch.sign(prox) * torch.clamp_min(torch.abs(prox) - lr * l1, 0.0)
            / (1.0 + lr * l2))


@register_op("proximal_gd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), no_grad=("LearningRate",),
             stop_gradient=True)
def _proximal_gd(ctx, op, ins):
    """Reference proximal_gd_op.cc."""
    p, lr = ins["Param"][0], _lr(ins)
    return {"ParamOut": [_proximal(p - lr * _dense(ins), lr, op)]}


@register_op("proximal_adagrad", inputs=("Param", "Moment", "Grad",
                                         "LearningRate"),
             outputs=("ParamOut", "MomentOut"), no_grad=("LearningRate",),
             stop_gradient=True)
def _proximal_adagrad(ctx, op, ins):
    """Reference proximal_adagrad_op.cc: the step takes the per-element
    lr, the l1/l2 shrinkage the scalar one (proximal_adagrad_op.h:52-63)."""
    p, m, g, lr = ins["Param"][0], ins["Moment"][0], _dense(ins), _lr(ins)
    m_new = m + g * g
    prox = p - (lr / torch.sqrt(m_new)) * g
    return {"ParamOut": [_proximal(prox, lr, op)], "MomentOut": [m_new]}
