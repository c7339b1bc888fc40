"""Pipeline parallelism over a ``pp`` mesh axis: the port's counterpart
of ``paddle_tpu/parallel/pipeline.py``.

One rank a stage, in a world started by the launcher. Where the JAX
package compiles the schedule into one SPMD loop (``lax.fori_loop``
over ticks, activations by ``lax.ppermute``), the port runs it eagerly
and in the same lockstep: at every tick each rank does its stage's work
for the microbatch the schedule gives it (or nothing), then every rank
of the axis exchanges activations forward and gradients backward with
``comm.permute`` (one collective a tick, so the ranks stay in step).

* ``pipeline_apply`` / ``pipeline_train_step`` / ``pipeline_train_step_3d``
  (GPipe): the forward ticks run under autograd with the exchanges'
  autograd form (``comm.permute_autograd``); the backward is autograd
  through them, as the JAX package's is ``jax.grad`` through its loop.
  Every exchange feeds every rank's graph (``torch.where`` keeps the
  idle branch, as ``jnp.where`` does), so every rank's backward runs
  every exchange's backward, in the same order.
* ``pipeline_train_step_1f1b`` and ``run_stage`` (the Program-level
  GPipe and 1F1B schedules of ``core/pipeline_program.py``): the
  schedule is explicit. At tick t stage s runs the forward of
  microbatch t - s and (1F1B) the backward of microbatch
  t - 2(S - 1) + s; the stage keeps each forward's graph (its stash)
  until that microbatch's backward, so 1F1B holds at most 2(S - 1) + 1
  microbatches where GPipe holds M. ``one_f_one_b_ticks`` is the tick
  count, M + 2(S - 1).

Parameters of the library functions are stacked over a leading stage
dim (``[S, ...]``, as the JAX package's are); each rank takes its own
slice, and the gradients come back whole (every stage's, on every
rank).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from . import comm

__all__ = ["pipeline_apply", "pipeline_train_step",
           "pipeline_train_step_1f1b", "pipeline_train_step_3d",
           "one_f_one_b_ticks", "run_stage"]


def one_f_one_b_ticks(n_microbatches: int, n_stages: int) -> int:
    """Ticks of the 1F1B schedule: M + 2(S - 1), each tick a stage's F
    and / or B; GPipe's forward-then-backward takes 2(M + S - 1)."""
    return n_microbatches + 2 * (n_stages - 1)


def _axis(mesh, axis_name):
    n = mesh.axis_size(axis_name)
    return n, mesh.coord(axis_name), mesh.group(axis_name)


def _check_stages(stage_params, n_stages, axis_name):
    bad = {int(t.shape[0]) for t in stage_params.values()
           if int(t.shape[0]) != n_stages}
    if bad:
        raise ValueError(
            f"stage_params leading (stage) dims {sorted(bad)} must equal "
            f"mesh axis {axis_name!r} size {n_stages} — with fewer devices "
            "than stages the pipeline would silently run only the "
            "resident stages")


def _lockstep_forward(stage_fn, params, mb, n, idx, group):
    """The GPipe forward ticks under autograd: [M, ...] outputs of the
    last stage, on every rank (a masked sum over the axis)."""
    M = mb.shape[0]
    first = torch.tensor(idx == 0, device=mb.device)
    lastt = torch.tensor(idx == n - 1, device=mb.device)
    inflight = torch.zeros_like(mb[0])
    outs = []
    for t in range(M + n - 1):
        mb_t = mb[min(t, M - 1)]
        x_in = torch.where(first, mb_t, inflight)
        active = torch.tensor(0 <= t - idx < M, device=mb.device)
        y = torch.where(active, stage_fn(params, x_in), inflight)
        if t >= n - 1:
            outs.append(torch.where(lastt, y, torch.zeros_like(y)))
        inflight = comm.permute_autograd(y, group, 1, ring=False)
    # the last stage's buffer, summed over the axis (its ranks' zeros)
    return comm.reduce_from(torch.stack(outs), group)


def pipeline_apply(stage_fn: Callable, stage_params: Dict[str, torch.Tensor],
                   microbatches: torch.Tensor, mesh, axis_name: str = "pp",
                   remat: bool = True) -> torch.Tensor:
    """Run a pipeline of identical-structure stages.

    stage_fn(params, x) -> y (same shape in and out); stage_params:
    {name: [S, ...]}, every rank passing the whole stack (each takes its
    slice); microbatches: [M, mb, ...] for stage 0. Returns the last
    stage's [M, mb, ...] outputs on every rank, differentiable (every
    rank of the axis calls ``backward`` on what it computes from them).
    ``remat`` is accepted for the JAX signature: an eager stage keeps
    its activations."""
    n, idx, group = _axis(mesh, axis_name)
    _check_stages(stage_params, n, axis_name)
    params = {k: v[idx] for k, v in stage_params.items()}
    return _lockstep_forward(stage_fn, params, microbatches, n, idx, group)


def _leaf_slices(stage_params, idx):
    return {k: v[idx].detach().clone().requires_grad_(True)
            for k, v in stage_params.items()}


def _whole_grads(leaves, stage_params, group):
    out = {}
    for k, p in leaves.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        out[k] = comm.all_gather(g.unsqueeze(0).contiguous(), group) \
            if group is not None else g.unsqueeze(0)
    return out


def pipeline_train_step(stage_fn: Callable, loss_fn: Callable, mesh,
                        axis_name: str = "pp"):
    """GPipe train step: f(stage_params, microbatches, targets) ->
    (loss, grads), grads {name: [S, ...]} whole on every rank."""

    def step(stage_params, microbatches, targets):
        n, idx, group = _axis(mesh, axis_name)
        _check_stages(stage_params, n, axis_name)
        leaves = _leaf_slices(stage_params, idx)
        with torch.enable_grad():
            outs = _lockstep_forward(stage_fn, leaves, microbatches, n, idx,
                                     group)
            loss = loss_fn(outs, targets)
            loss.backward()
        return loss.detach(), _whole_grads(leaves, stage_params, group)

    return step


def pipeline_train_step_1f1b(stage_fn: Callable, loss_fn: Callable, mesh,
                             axis_name: str = "pp"):
    """1F1B train step: loss_fn(y_mb, target_mb) -> scalar a
    microbatch; the step's loss is their mean. Returns
    f(stage_params, microbatches, targets) -> (loss, grads) with the
    grads of ``pipeline_train_step`` whose loss is the microbatch mean
    of this one. ``step.peak_stash`` is the most microbatches the
    rank's stage held at once in the last call."""

    def step(stage_params, microbatches, targets):
        n, idx, group = _axis(mesh, axis_name)
        _check_stages(stage_params, n, axis_name)
        leaves = _leaf_slices(stage_params, idx)
        M = microbatches.shape[0]
        like = ((tuple(microbatches.shape[1:]), microbatches.dtype),)

        def forward(j, xs):
            x = microbatches[j] if xs is None else xs[0]
            y = stage_fn(leaves, x)
            if idx == n - 1:
                return (loss_fn(y, targets[j]),)
            return (y,)

        aux, peak = run_stage(forward, M, group, like, "1f1b",
                              lambda totals: (1.0 / M,),
                              device=microbatches.device)
        step.peak_stash = peak
        loss = (torch.stack([a[0] for a in aux]).sum() / M
                if aux is not None else torch.zeros(()))
        loss = comm.broadcast(loss.reshape(1).float().contiguous(),
                              n - 1, group)[0]
        return loss, _whole_grads(leaves, stage_params, group)

    step.peak_stash = 0
    return step


def pipeline_train_step_3d(stage_fn: Callable, mesh, param_specs,
                           pp_axis: str = "pp", dp_axis: str = "dp",
                           remat: bool = True):
    """3D parallelism on one mesh: GPipe over ``pp_axis``, tensor
    parallelism inside ``stage_fn`` (it receives its local parameter
    shards and runs its own collectives over the tensor axis, Megatron-
    style: ``comm.copy_to`` before a column-parallel linear,
    ``comm.reduce_from`` after a row-parallel one), the batch split
    over ``dp_axis``.

    param_specs: {name: spec} with the stage axis first (``pp_axis``)
    and tensor dims naming the tensor axis; dp must not appear.
    Returns step(stage_params, microbatches, targets) -> (loss, grads):
    stage_params whole ``[S, ...]``; microbatches / targets [M, mb, ...]
    with mb the rank's dp shard; loss the global mean of
    (y - target)², alike on every rank; grads whole, alike on every
    rank."""

    def _slice(t, spec):
        for d, a in enumerate(spec):
            if d == 0 or a is None:
                continue
            k, i, _ = _axis(mesh, a)
            size = t.shape[d - 1] // k
            t = t.narrow(d - 1, i * size, size)
        return t

    def _unslice(g, spec):
        for d, a in reversed(list(enumerate(spec))):
            if d == 0 or a is None:
                continue
            k, _, grp = _axis(mesh, a)
            g = comm._gather(g.contiguous(), d - 1, grp) if grp is not None \
                else g
        return g

    def step(stage_params, microbatches, targets):
        n, idx, group = _axis(mesh, pp_axis)
        dp, _, dp_group = _axis(mesh, dp_axis)
        _check_stages(stage_params, n, pp_axis)
        leaves = {k: _slice(v[idx], param_specs[k]).detach().clone()
                  .requires_grad_(True) for k, v in stage_params.items()}
        with torch.enable_grad():
            outs = _lockstep_forward(stage_fn, leaves, microbatches, n, idx,
                                     group)
            local = ((outs - targets) ** 2).sum() / (outs.numel() * dp)
            loss = comm.reduce_from(local, dp_group)
            loss.backward()
        grads = {}
        for k, p in leaves.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            comm.all_reduce(g, group=dp_group)
            g = _unslice(g, param_specs[k])
            grads[k] = comm.all_gather(g.unsqueeze(0).contiguous(), group) \
                if group is not None else g.unsqueeze(0)
        return loss.detach(), grads

    return step


# -- the explicit schedule of one stage --------------------------------------


def _exchange(tensors, group, shift):
    return tuple(comm.permute(t, group, shift, ring=False) for t in tensors)


def run_stage(forward: Callable, M: int, group, like: Sequence[Tuple],
              schedule: str, coeffs: Callable, device=None):
    """This rank's stage of a pipeline over ``group`` (its rank there is
    its stage), GPipe or 1F1B in lockstep ticks (module docstring).

    forward(j, xs) runs microbatch j's stage forward under autograd:
    ``xs`` is the tuple of boundary tensors received from the stage
    before (leaves; None on stage 0); it returns the boundary tensors
    for the next stage, or on the last stage a tuple of scalar tensors
    (the losses and metrics of the microbatch). ``like``: (shape,
    dtype) of each boundary tensor, on ``device``. ``coeffs(totals)`` gives, on the
    last stage, the gradient seed of each scalar: GPipe calls it after
    every forward with each scalar's sum over the microbatches, 1F1B
    before any with None. Parameter gradients accumulate in the leaves
    the forward reads (``.grad``).

    Returns (the last stage's scalars a microbatch, detached, or None
    on other stages; the most microbatches the stage held at once)."""
    S, s = comm.group_size(group), comm.group_rank(group)
    last = s == S - 1
    stash: Dict[int, Any] = {}
    aux: List[Any] = [None] * M
    peak = [0]
    zeros_f = tuple(torch.zeros(sh, dtype=dt, device=device)
                    for sh, dt in like)
    recv_f = zeros_f
    recv_b = zeros_f

    def do_f(j):
        xs = None
        if s > 0:
            xs = tuple(t.detach().requires_grad_(t.is_floating_point())
                       for t in recv_f)
        with torch.enable_grad():
            outs = tuple(forward(j, xs))
        stash[j] = (xs, outs)
        peak[0] = max(peak[0], len(stash))
        if last:
            aux[j] = tuple(a.detach() for a in outs)
            return zeros_f
        return tuple(o.detach() for o in outs)

    def do_b(j, grads, c):
        xs, outs = stash.pop(j)
        if last:
            pairs = [(o, torch.as_tensor(ci, dtype=o.dtype,
                                         device=o.device).expand_as(o))
                     for o, ci in zip(outs, c) if o.requires_grad]
        else:
            pairs = [(o, g.to(o.dtype)) for o, g in zip(outs, grads)
                     if o.requires_grad]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        if xs is None:
            return zeros_f
        return tuple(x.grad if (x.requires_grad and x.grad is not None)
                     else torch.zeros_like(x) for x in xs)

    if schedule == "gpipe":
        for t in range(M + S - 1):
            f = t - s
            send = do_f(f) if 0 <= f < M else zeros_f
            recv_f = _exchange(send, group, 1)
        c = None
        if last:
            totals = [sum(a[k] for a in aux) for k in range(len(aux[0]))]
            c = coeffs(totals)
        for t in range(M + S - 1):
            b = t - (S - 1 - s)
            send = do_b(b, recv_b, c) if 0 <= b < M else zeros_f
            recv_b = _exchange(send, group, -1)
    elif schedule == "1f1b":
        c = coeffs(None) if last else None
        for t in range(one_f_one_b_ticks(M, S)):
            f = t - s
            send_f = do_f(f) if 0 <= f < M else zeros_f
            b = t - 2 * (S - 1) + s
            send_b = do_b(b, recv_b, c) if 0 <= b < M else zeros_f
            recv_f = _exchange(send_f, group, 1)
            recv_b = _exchange(send_b, group, -1)
    else:
        raise ValueError(f"schedule must be 'gpipe' or '1f1b', got "
                         f"{schedule!r}")
    if stash:
        raise RuntimeError(f"pipeline stage {s}: microbatches "
                           f"{sorted(stash)} never ran their backward")
    return (aux if last else None), peak[0]

