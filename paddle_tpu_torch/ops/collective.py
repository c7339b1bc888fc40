"""Collective communication ops: the port's counterpart of
``paddle_tpu/ops/collective.py`` (reference
operators/collective/c_allreduce_op.h, c_broadcast, c_allgather,
c_reducescatter, c_comm_init / c_gen_nccl_id).

A ``ring_id`` resolves through ``parallel.mesh.ring_group`` to a
process group: its axis on the current mesh, else the whole world. With
no world the ops are identities, as the JAX package's are under GSPMD;
inside a ``CompiledProgram`` step they are identities too, because the
step itself reduces the gradients (``runtime/dist_step.py``), as GSPMD
does for the JAX package. The comm-setup ops are no-ops: the world is
formed by ``init_parallel_env`` and torch orders the collectives.

``collective_bucket_reduce`` is the planner's bucket op
(``parallel/collectives.py``): in a data-parallel step each of its fp32
gradients starts ``all_reduce(async_op=True)`` over the ``dp`` group
where the op sits, and the first reader waits on it; the int8 form
reduces the bucket as one flat payload a dtype through the two-shot
exchange (``kernels.quant.quantized_mean``). Anywhere else it is an
identity, so a planned program degrades to the unplanned one.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows
from ..parallel import comm


def _group_for(ctx, op):
    if ctx.dist is not None:
        return None
    from ..parallel.mesh import ring_group

    return ring_group(int(op.attrs.get("ring_id", 0)))


def _register_allreduce(name, red):
    @register_op(name, inputs=("X",), outputs=("Out",))
    def _lower(ctx, op, ins, _red=red):
        x = ins["X"][0]
        group = _group_for(ctx, op)
        if group is None:
            return {"Out": [x]}
        if _red == "prod":
            y = torch.log(x)
            comm.all_reduce(y, group=group)
            return {"Out": [torch.exp(y)]}
        y = x.clone()
        comm.all_reduce(y, op=_red, group=group)
        return {"Out": [y]}


_register_allreduce("c_allreduce_sum", "sum")
_register_allreduce("c_allreduce_max", "max")
_register_allreduce("c_allreduce_min", "min")
_register_allreduce("c_allreduce_prod", "prod")
_register_allreduce("allreduce", "sum")


@register_op("c_broadcast", inputs=("X",), outputs=("Out",))
def _c_broadcast(ctx, op, ins):
    x = ins["X"][0]
    group = _group_for(ctx, op)
    if group is None:
        return {"Out": [x]}
    return {"Out": [comm.broadcast(x.clone(), int(op.attrs.get("root", 0)),
                                   group)]}


@register_op("broadcast", inputs=("X",), outputs=("Out",))
def _broadcast_op(ctx, op, ins):
    return _c_broadcast(ctx, op, ins)


@register_op("c_allgather", inputs=("X",), outputs=("Out",))
def _c_allgather(ctx, op, ins):
    x = ins["X"][0]
    group = _group_for(ctx, op)
    if group is None:
        return {"Out": [x]}
    return {"Out": [comm.all_gather(x, group)]}


@register_op("c_reducescatter", inputs=("X",), outputs=("Out",))
def _c_reducescatter(ctx, op, ins):
    x = ins["X"][0]
    group = _group_for(ctx, op)
    if group is None:
        return {"Out": [x]}
    return {"Out": [comm.reduce_scatter(x, group)]}


@register_op("collective_bucket_reduce", inputs=("X",), outputs=("Out",),
             stop_gradient=True)
def _collective_bucket_reduce(ctx, op, ins):
    """One gradient bucket's mean over the data-parallel group (see the
    module docstring). The fp32 form leaves each reduction pending on
    the context (``ctx.pending``: handle, tensor, ``1/n``); the run's
    next reader of the output waits on it and scales it in place."""
    xs = ins["X"]
    dist = ctx.dist
    plan = getattr(op.block.program, "_collective_plan", None)
    group = dist.bucket_group if dist is not None else None
    if group is None or (plan is not None and plan.skip_reduce):
        return {"Out": list(xs)}
    for x, n in zip(xs, op.inputs["X"]):
        if isinstance(x, SelectedRows):
            raise NotImplementedError(
                f"{n!r} is a SelectedRows gradient: averaging sparse "
                "gradients over a data-parallel world is the parameter "
                "server's work (DistributeTranspiler in pserver mode, "
                "ps.PSTrainer)")
    size = comm.group_size(group)
    quantized = op.attrs.get("quantization", "none") == "int8"
    if not quantized:
        inv = 1.0 / size
        outs = []
        for x, raw, red in zip(xs, op.inputs["X"], op.outputs["Out"]):
            t = x if raw in dist.inplace_ok else x.clone()
            work = comm.all_reduce(t, group=group, async_op=True)
            ctx.pending[red] = (work, t, inv)
            outs.append(t)
        return {"Out": outs}
    if size == 1:
        # the JAX package reduces only over an axis of more than one
        # device; at one the bucket is an identity
        return {"Out": list(xs)}
    from ..kernels.quant import quantized_mean

    block = int(op.attrs.get("quant_block", 256))
    out: List[Any] = [None] * len(xs)
    by_dtype: Dict[Any, List[int]] = {}
    for i, x in enumerate(xs):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idxs in by_dtype.values():
        flat = (xs[idxs[0]].reshape(-1) if len(idxs) == 1 else
                torch.cat([xs[i].reshape(-1) for i in idxs]))
        red = quantized_mean(flat, group, block, exchange=True)
        off = 0
        for i in idxs:
            n = xs[i].numel()
            out[i] = red[off:off + n].reshape(xs[i].shape)
            off += n
    return {"Out": out}


def _register_noop(name, slots=("X",)):
    @register_op(name, inputs=slots, outputs=("Out",), stop_gradient=True)
    def _lower(ctx, op, ins):
        vals = ins.get(slots[0], []) if slots else []
        return {"Out": list(vals)}


# comm setup and stream ordering: the world is formed by
# init_parallel_env and torch orders the collectives
_register_noop("c_comm_init", ())
_register_noop("c_comm_init_all", ())
_register_noop("c_gen_nccl_id", ())
_register_noop("c_sync_calc_stream")
_register_noop("c_sync_comm_stream")
_register_noop("c_wait_comm", ())
_register_noop("c_wait_compute", ())


@register_op("local_sgd_select", inputs=("Step", "Avg", "Param"),
             outputs=("Out",), stop_gradient=True)
def _local_sgd_select(ctx, op, ins):
    """The LocalSGD gate (transpiler/collective.py): the cross-replica
    average every ``every`` steps, else the local parameter."""
    step = ins["Step"][0].reshape(())
    every = float(op.attrs.get("every", 1.0))
    sync = torch.remainder(step, every) < 0.5
    return {"Out": [torch.where(sync, ins["Avg"][0], ins["Param"][0])]}
