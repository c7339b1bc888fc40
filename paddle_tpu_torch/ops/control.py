"""AMP support ops: ``check_finite_and_unscale`` and
``update_loss_scaling``, torch lowerings with the semantics of
``paddle_tpu/ops/control.py:31-80``. The found-infinite flag, the loss
scale and the good/bad step counters stay device tensors: nothing here
reads a value back to the host, so a step pays no sync for them."""

from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("check_finite_and_unscale", inputs=("X", "Scale"),
             outputs=("Out", "FoundInfinite"), stop_gradient=True)
def _check_finite_and_unscale(ctx, op, ins):
    """Out = X / Scale (in the operands' common dtype, as ``jnp``
    promotes); FoundInfinite: a 0-dim bool, whether any output holds an
    inf or a nan."""
    scale = ins["Scale"][0].reshape(())
    found = torch.zeros((), dtype=torch.bool, device=scale.device)
    outs = []
    for x in ins["X"]:
        dt = torch.promote_types(x.dtype, scale.dtype)
        y = x.to(dt) / scale.to(dt)
        outs.append(y)
        found = found | ~torch.isfinite(y).all()
    return {"Out": outs, "FoundInfinite": [found]}


@register_op(
    "update_loss_scaling",
    inputs=("X", "FoundInfinite", "PrevLossScaling", "InGoodSteps",
            "InBadSteps"),
    outputs=("Out", "LossScaling", "OutGoodSteps", "OutBadSteps"),
    stop_gradient=True,
)
def _update_loss_scaling(ctx, op, ins):
    """Dynamic loss scaling: after ``incr_every_n_steps`` finite steps
    in a row the scale grows by ``incr_ratio``; after
    ``decr_every_n_nan_or_inf`` non-finite ones it shrinks by
    ``decr_ratio`` (never below 1). A non-finite step zeroes the
    gradients."""
    found = ins["FoundInfinite"][0].reshape(())
    scale = ins["PrevLossScaling"][0].reshape(())
    good = ins["InGoodSteps"][0].reshape(())
    bad = ins["InBadSteps"][0].reshape(())
    incr_every = int(op.attrs.get("incr_every_n_steps", 1000))
    decr_every = int(op.attrs.get("decr_every_n_nan_or_inf", 2))
    incr_ratio = float(op.attrs.get("incr_ratio", 2.0))
    decr_ratio = float(op.attrs.get("decr_ratio", 0.5))

    zero = torch.zeros_like(good)
    good_new = torch.where(found, zero, good + 1)
    bad_new = torch.where(found, bad + 1, zero)
    grow = good_new >= incr_every
    scale_up = torch.where(grow, scale * incr_ratio, scale)
    good_new = torch.where(grow, zero, good_new)
    shrink = bad_new >= decr_every
    new_scale = torch.where(
        shrink, torch.clamp(scale * decr_ratio, min=1.0), scale_up)
    bad_new = torch.where(shrink, zero, bad_new)
    outs = [torch.where(found, torch.zeros_like(x), x) for x in ins["X"]]
    return {
        "Out": outs,
        "LossScaling": [new_scale.reshape(1)],
        "OutGoodSteps": [good_new.reshape(1).to(torch.int32)],
        "OutBadSteps": [bad_new.reshape(1).to(torch.int32)],
    }
