"""Structured control flow: ``while``, ``conditional_block`` and
``recompute_segment_grad``, the port's counterpart of
``paddle_tpu/core/control_flow.py``.

JAX compiles a sub-block into ``lax.while_loop`` / ``lax.cond`` over a
carry: the names the sub-block writes that exist before the op
(``_written_names``); the block's other values stay inside. The port
runs the sub-block eagerly (``executor.lower_ops``) with the same carry:
each pass starts from the enclosing environment with the carry's
current values, and only the carry comes back out. ``while`` reads its
condition to the host once an iteration and ``conditional_block`` its
predicate once, so each costs a sync there. Like ``lax.while_loop``,
neither has a gradient: they are not in the op registry, so
``append_backward`` refuses a program that differentiates through one,
as the JAX package's does.

``recompute_segment_grad`` (emitted by
``backward.append_backward_with_recompute``) is one checkpointed
segment's gradient: the segment's forward ran once without recording
anything on the tape (no grad op consumes it, so its activations were
freed after their last forward reader); here it runs again under
``torch.enable_grad()`` on detached leaves of the differentiable inputs,
and ``torch.autograd.grad`` applies the incoming cotangents. The rerun
keeps the ops' ``op_ident``s, so ``LoweringContext.op_generator`` draws
the same dropout masks, as ``jax.checkpoint`` replays the same key.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from .executor import lower_ops, register_control_flow


def _written_names(sub_block, env) -> List[str]:
    """The carry: names the sub-block (or a block nested in it) writes
    that are in ``env`` already."""
    seen: List[str] = []
    for op in sub_block.ops:
        for n in op.output_arg_names:
            if n in env and n not in seen:
                seen.append(n)
        for v in op.attrs.values():
            if hasattr(v, "ops") and hasattr(v, "vars"):   # a nested Block
                for n in _written_names(v, env):
                    if n not in seen:
                        seen.append(n)
    return seen


def _truth(value) -> bool:
    """A one-element predicate read back to the host."""
    return bool(value.reshape(()).to(torch.bool))


def _run_sub(sub, env: Dict[str, Any], ctx, carry: List[str]) -> None:
    local = dict(env)
    lower_ops(sub.ops, local, ctx)
    for n in carry:
        env[n] = local[n]


@register_control_flow("while")
def _lower_while(ctx, op, env):
    sub = op.attrs["sub_block"]
    cond_name = op.inputs["Condition"][0]
    carry = _written_names(sub, env)
    if cond_name not in carry:
        carry = [cond_name] + carry
    while _truth(env[cond_name]):
        _run_sub(sub, env, ctx, carry)


@register_control_flow("conditional_block")
def _lower_conditional_block(ctx, op, env):
    sub = op.attrs["sub_block"]
    cond_name = op.inputs.get("Cond", op.inputs.get("Input"))[0]
    carry = _written_names(sub, env)
    if not carry:
        return
    if _truth(env[cond_name]):
        _run_sub(sub, env, ctx, carry)


@register_control_flow("recompute_segment_grad", carries=False)
def _lower_recompute_segment_grad(ctx, op, env):
    sub = op.attrs["sub_block"]
    out_names = op.attrs["seg_outputs"]
    wanted = op.attrs["wanted"]
    local = {n: env[n] for n in op.inputs["Inputs"]}
    leaves = {}
    for n in wanted:
        v = env[n].detach()
        if v.is_floating_point():
            v.requires_grad_(True)
            leaves[n] = v
        local[n] = v
    with torch.enable_grad():
        lower_ops(sub.ops, local, ctx)
    heads, cots = [], []
    for n, g in zip(out_names, op.inputs["OutGrads"]):
        h = local[n]
        if isinstance(h, torch.Tensor) and h.requires_grad:
            heads.append(h)
            cots.append(env[g].to(h.dtype).reshape(h.shape))
    targets = list(leaves.values())
    grads = [None] * len(targets)
    if heads and targets:
        grads = torch.autograd.grad(heads, targets, cots, allow_unused=True)
    got = dict(zip(leaves, grads))
    for n, gname in zip(wanted, op.outputs["InGrads"]):
        g = got.get(n)
        env[gname] = g if g is not None else torch.zeros_like(local[n])
