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

Expert parallelism (``CompiledProgram.with_expert_parallel``, the
JAX package's :74-210): each rank holds ``E/ep`` experts and the
lowering reads the bound step's ``moe`` context
(``runtime/dist_step.py``).

* ``psum``: the ranks of one ``dp`` index hold the same tokens; each
  routes them all, computes only its own experts' slots, and a sum over
  ``ep`` combines the outputs (``comm.reduce_from``). The tokens and
  the gate enter the experts through ``comm.copy_to`` (a sum over
  ``ep`` backward), since every rank's share of the output depends on
  them.
* ``alltoall``: every rank holds its own tokens; its dispatch buffer
  [E * cap, D] is one block of ``E/ep * cap`` slots a destination rank,
  one ``all_to_all`` over ``ep`` hands each rank the tokens routed to
  its experts, and a second returns the outputs. Capacity is per
  (source rank, expert), from the rank's own token count.

The router statistics are summed over the ranks holding different
tokens (``dp``; ``dp`` and ``ep`` under ``alltoall``) with a sum
backward, so the load-balance loss is the global one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op

__all__ = ["switch_moe", "switch_moe_ep", "moe_capacity", "route"]


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


def _local_slots(slot_token, token_slot, first: int, count: int):
    """The slot <-> token maps restricted to slots [first, first + count)
    (a rank's experts): slot indices shifted to start at 0, a token whose
    slot lies elsewhere mapped to the sentinel ``count``."""
    st = slot_token[first:first + count]
    ts = token_slot - first
    ts = torch.where((ts >= 0) & (ts < count), ts, torch.full_like(ts, count))
    return st, ts


def _experts(disp, w1, b1, w2, b2, act):
    h = torch.bmm(disp, w1) + b1[:, None, :]
    h = F.gelu(h, approximate="tanh") if act == "gelu" else F.relu(h)
    return torch.bmm(h, w2) + b2[:, None, :]


def _aux(expert, probs, E, T, group):
    """The load-balance loss over the ranks of ``group`` (their token
    counts and router probabilities summed, the probabilities with a
    sum backward)."""
    from ..parallel import comm

    count_e = F.one_hot(expert, E).to(probs.dtype).sum(0)
    prob_e = probs.sum(0)
    n = comm.group_size(group)
    if group is not None:
        comm.all_reduce(count_e, group=group)
        prob_e = comm.all_reduce_sum(prob_e, group)
    t_total = torch.tensor(float(T * n), dtype=probs.dtype,
                           device=probs.device)
    return E * torch.sum((count_e / t_total) * (prob_e / t_total))


def switch_moe_ep(x2, wg, w1, b1, w2, b2, cap_factor: float, act, moe):
    """Expert-parallel switch MoE on this rank's tokens ``x2`` [T, D]
    with its ``E/ep`` experts ``w1`` [E/ep, D, F] ...: (out [T, D],
    aux []). See the module docstring for the two dispatches."""
    from ..parallel import comm

    T, D = x2.shape
    E = wg.shape[1]
    e_local = w1.shape[0]
    if e_local * moe.ep != E:
        raise ValueError(f"switch_moe: the ep mesh axis ({moe.ep}) must "
                         f"divide num_experts ({E})")
    cap = moe_capacity(T, cap_factor, E)
    probs = torch.softmax(x2 @ wg, dim=-1)
    expert, keep, slot_token, token_slot = route(probs.detach(), cap)
    gate = probs.gather(1, expert[:, None])[:, 0]
    if moe.dispatch == "alltoall":
        disp = _Gather.apply(x2, slot_token, token_slot)       # [E*cap, D]
        recv = comm.all_to_all_autograd(disp, moe.ep_group)
        # [source, e_local, cap, D] -> [e_local, source * cap, D]
        h_in = (recv.reshape(moe.ep, e_local, cap, D).transpose(0, 1)
                .reshape(e_local, moe.ep * cap, D))
        y = _experts(h_in, w1, b1, w2, b2, act)
        y = (y.reshape(e_local, moe.ep, cap, D).transpose(0, 1)
             .reshape(E * cap, D))
        back = comm.all_to_all_autograd(y, moe.ep_group)
        out = (_Gather.apply(back, token_slot, slot_token)
               * (gate * keep.to(gate.dtype))[:, None])
    else:
        first = moe.ep_index * e_local * cap
        st, ts = _local_slots(slot_token, token_slot, first, e_local * cap)
        xin = comm.copy_to(x2, moe.ep_group)
        disp = _Gather.apply(xin, st, ts).reshape(e_local, cap, D)
        y = _experts(disp, w1, b1, w2, b2, act)
        mine = keep & (ts < e_local * cap)
        g = comm.copy_to(gate, moe.ep_group)
        part = (_Gather.apply(y.reshape(e_local * cap, D), ts, st)
                * (g * mine.to(g.dtype))[:, None])
        out = comm.reduce_from(part, moe.ep_group)
    return out, _aux(expert, probs, E, T, moe.token_group)


@register_op(
    "switch_moe",
    inputs=("X", "GateW", "ExpertW1", "ExpertB1", "ExpertW2", "ExpertB2"),
    outputs=("Out", "AuxLoss"),
)
def _switch_moe(ctx, op, ins):
    moe = ctx.dist.moe if getattr(ctx, "dist", None) is not None else None
    if moe is None and _ep_axis(ctx) > 1:
        raise NotImplementedError(
            "switch_moe: an 'ep' mesh on a bare lowering context; expert "
            "parallelism runs in a world through "
            "CompiledProgram.with_expert_parallel (ROADMAP A10a)")
    x = ins["X"][0]
    w1 = ins["ExpertW1"][0]
    D = x.shape[-1]
    x2 = x.reshape(-1, D)
    cap_factor = op.attrs.get("capacity_factor", 1.25)
    act = op.attrs.get("act", "gelu")
    if moe is not None:
        out, aux = switch_moe_ep(x2, ins["GateW"][0], w1, ins["ExpertB1"][0],
                                 ins["ExpertW2"][0], ins["ExpertB2"][0],
                                 float(cap_factor), act, moe)
        return {"Out": [out.reshape(x.shape)], "AuxLoss": [aux.reshape(1)]}
    cap = moe_capacity(x2.shape[0], cap_factor, int(w1.shape[0]))
    out, aux = switch_moe(x2, ins["GateW"][0], w1, ins["ExpertB1"][0],
                          ins["ExpertW2"][0], ins["ExpertB2"][0], cap, act)
    return {"Out": [out.reshape(x.shape)], "AuxLoss": [aux.reshape(1)]}
