"""Switch-style mixture of experts: the ``switch_moe`` op, the port's
counterpart of the dense lowering of ``paddle_tpu/ops/moe.py``
(``_moe_math`` :30-71 with every expert local, the op :143-160).

Top-1 routing: each token goes to the ``argmax`` of its router softmax
(ties to the lower index, as ``jnp.argmax`` and ``torch.argmax`` both
break them), its rank in that expert's queue is an exclusive cumulative
count in token order, and tokens ranked at or past the capacity
``cap = max(ceil(T * capacity_factor / E), 1)`` are dropped (zero expert
output). The expert FFNs are two batched products over [E, cap, *]
(``torch.bmm``; the JAX package leaves its einsums to XLA, outside any
Pallas kernel) with JAX's default ``gelu``, the tanh approximation. The
load-balance loss is ``E * sum_e (count_e / T) (prob_e / T)``, no
gradient through the counts.

Dispatch and combine are gathers through a slot -> token and a token ->
slot index built from the routing (each slot holds at most one token),
where JAX scatter-adds into the slots: the gather's gradient is the
gather the other way, so neither direction adds floats in an order the
card chooses. Gradients come from autograd through the Executor's tape.

Expert parallelism (the ``ep`` mesh axis, its psum and all-to-all
dispatch, ``paddle_tpu/ops/moe.py:74-210``) is ROADMAP A10: an ``ep``
mesh on the lowering context is refused.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op

__all__ = ["switch_moe", "moe_capacity", "route"]


def moe_capacity(tokens: int, capacity_factor: float, experts: int) -> int:
    """JAX's ``max(int(-(-T * cap_factor // E)), 1)``, in the same Python
    float arithmetic."""
    return max(int(-(-tokens * float(capacity_factor) // experts)), 1)


class _Gather(torch.autograd.Function):
    """Rows ``src[fwd]`` with a zero row for the sentinel index
    ``len(src)``; the gradient is ``grad[bwd]`` the same way, where
    ``bwd`` is ``fwd``'s inverse (a partial bijection)."""

    @staticmethod
    def forward(ctx, src, fwd, bwd):
        ctx.save_for_backward(bwd)
        ctx.rows = fwd.numel()
        pad = torch.cat([src, src.new_zeros((1,) + tuple(src.shape[1:]))])
        return pad[fwd]

    @staticmethod
    def backward(ctx, g):
        (bwd,) = ctx.saved_tensors
        pad = torch.cat([g, g.new_zeros((1,) + tuple(g.shape[1:]))])
        return pad[bwd], None, None


def route(probs: torch.Tensor, cap: int):
    """(expert [T], kept [T] bool, slot_token [E * cap], token_slot [T])
    of top-1 routing: ``slot_token`` holds T for an empty slot,
    ``token_slot`` E * cap for a dropped token."""
    T, E = probs.shape
    expert = torch.argmax(probs, dim=-1)
    onehot = F.one_hot(expert, E)
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(1, expert[:, None])[:, 0]
    keep = pos < cap
    slot = expert * cap + pos
    token_slot = torch.where(keep, slot, torch.full_like(slot, E * cap))
    slot_token = torch.full((E * cap + 1,), T, dtype=torch.int64,
                            device=probs.device)
    slot_token[token_slot] = torch.arange(T, device=probs.device)
    return expert, keep, slot_token[:E * cap], token_slot


def switch_moe(x2, wg, w1, b1, w2, b2, cap: int, act: str = "gelu"):
    """Switch MoE on tokens ``x2`` [T, D]: (out [T, D], aux [])."""
    T, D = x2.shape
    E = wg.shape[1]
    probs = torch.softmax(x2 @ wg, dim=-1)
    expert, keep, slot_token, token_slot = route(probs.detach(), cap)
    gate = probs.gather(1, expert[:, None])[:, 0]
    disp = _Gather.apply(x2, slot_token, token_slot).reshape(E, cap, D)
    h = torch.bmm(disp, w1) + b1[:, None, :]
    h = F.gelu(h, approximate="tanh") if act == "gelu" else F.relu(h)
    y = torch.bmm(h, w2) + b2[:, None, :]
    out = (_Gather.apply(y.reshape(E * cap, D), token_slot, slot_token)
           * (gate * keep.to(gate.dtype))[:, None])
    count_e = F.one_hot(expert, E).to(x2.dtype).sum(0)
    prob_e = probs.sum(0)
    t_total = torch.tensor(float(T), dtype=x2.dtype, device=x2.device)
    aux = E * torch.sum((count_e / t_total) * (prob_e / t_total))
    return out, aux


def _ep_axis(ctx) -> int:
    mesh = getattr(ctx, "mesh", None)
    if mesh is None:
        return 1
    shape = mesh.shape if hasattr(mesh, "shape") else mesh
    return int(dict(shape).get("ep", 1))


@register_op(
    "switch_moe",
    inputs=("X", "GateW", "ExpertW1", "ExpertB1", "ExpertW2", "ExpertB2"),
    outputs=("Out", "AuxLoss"),
)
def _switch_moe(ctx, op, ins):
    if _ep_axis(ctx) > 1:
        raise NotImplementedError(
            "switch_moe over an 'ep' mesh axis (expert parallelism, its psum "
            "and all-to-all dispatch) is not ported to paddle_tpu_torch yet "
            "(ROADMAP A10)")
    x = ins["X"][0]
    w1 = ins["ExpertW1"][0]
    D = x.shape[-1]
    x2 = x.reshape(-1, D)
    cap = moe_capacity(x2.shape[0], op.attrs.get("capacity_factor", 1.25),
                       int(w1.shape[0]))
    out, aux = switch_moe(x2, ins["GateW"][0], w1, ins["ExpertB1"][0],
                          ins["ExpertW2"][0], ins["ExpertB2"][0], cap,
                          op.attrs.get("act", "gelu"))
    return {"Out": [out.reshape(x.shape)], "AuxLoss": [aux.reshape(1)]}
