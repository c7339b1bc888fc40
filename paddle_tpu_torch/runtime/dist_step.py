"""What a bound step of a ``CompiledProgram`` does across the world.

``core/compiler.py`` decides the parallelism (a mesh and the specs of
the sharded state); a ``DistStep`` is what one bound step of it runs,
worked out once at bind time against the step's ``_Plan``:

* **gradient reduction.** Every trainable parameter's gradient is
  averaged over the ranks that saw different data: right after the
  op that writes it last, ``all_reduce(async_op=True)`` starts in
  place, and the first op that reads the gradient waits on the handle
  and scales by ``1/n`` (``pending``). A program planned by
  ``parallel.collectives.ensure_planned`` does this at its
  ``collective_bucket_reduce`` ops instead. Expert-parallel steps
  reduce an expert's gradient over the ``dp`` group only, scaled by the
  ranks whose tokens reached it.
* **ZeRO.** A var whose spec places the ``dp`` axis on a dim is held
  as this rank's chunk of that dim (``parallel.sharding.Shard``): the
  first step after a whole value reaches the scope (the startup
  program, a checkpoint restore) cuts it. An optimizer op over a
  sharded accumulator runs on chunks: its parameter and other
  whole-shaped inputs are cut, its gradient is reduce-scattered (or
  cut, when something besides the optimizer reads the reduced value),
  and the updated parameter is all-gathered. ZeRO-3 parameters stay
  chunks in the scope and are all-gathered at the start of each step.
* **expert parallelism.** Expert weights and their accumulators are
  held as this rank's ``E/ep`` experts; ``switch_moe`` reads ``moe``
  for its dispatch and groups.
* **fetches.** A scalar float fetch computed before the optimizer is
  the mean over the ranks that saw different data; every other fetch
  is the rank's own value, and an integer fetch that depends on the
  rank's batch or random draws raises (``export_taint``).
* **randomness.** With more than one data shard, each rank mixes its
  shard's index into its ops' seeds, so dropout masks differ between
  shards and agree between the ranks of one shard (the expert-parallel
  ``psum`` dispatch).
* **tensor and sequence parallelism.** A ``tp`` or ``sp`` axis larger
  than 1 gets a ``runtime.tp_plan.ShardPlan``: the ops that meet a split
  value run its hooks, and a split fetch is gathered whole. Under ``sp``
  every rank saw other tokens, so the gradients and fetches are averaged
  over the world, and the dropout salt is the ``dp`` index alone (the
  plan draws whole-shape masks).
* **gradient merge.** A merged step's microbatches reduce nothing; the
  merged gradients are averaged once, at the apply (``reduce_merged``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.framework import OpRole, Parameter
from ..core.selected_rows import SelectedRows
from ..parallel import comm
from ..parallel.collectives import OP_TYPE, export_taint
from ..parallel.mesh import world_group
from ..parallel.sharding import Shard, set_layout
from .tp_plan import ShardPlan, interleave_groups, unshard

__all__ = ["DistStep", "MoEContext", "finish"]


class MoEContext:
    """What the expert-parallel ``switch_moe`` lowering needs."""

    def __init__(self, dispatch, ep, dp, ep_group, dp_group, token_group,
                 ep_index):
        self.dispatch = dispatch
        self.ep, self.dp = int(ep), int(dp)
        self.ep_group, self.dp_group = ep_group, dp_group
        self.token_group = token_group
        self.ep_index = int(ep_index)


def _is_opt(op) -> bool:
    return bool(int(op.attrs.get("op_role", 0))
                & (OpRole.Optimize | OpRole.LRSched))


def finish(ctx, name: str) -> None:
    """Wait on ``name``'s pending reduction and scale it."""
    work, t, scale = ctx.pending.pop(name)
    comm.wait(work)
    t.mul_(scale)


class DistStep:
    """The world side of one bound step (see the module docstring).
    ``active`` is False without a world: the step then runs as a plain
    one."""

    def __init__(self, compiled, plan, block, fetch_names):
        mesh = compiled._mesh
        self.mesh = mesh
        strategy = compiled._strategy
        axis_env = compiled._axis_env or {}
        world = world_group()
        self.moe: Optional[MoEContext] = None
        dp_group = mesh.group("dp")
        dp = mesh.axis_size("dp")
        if strategy == "with_expert_parallel":
            dispatch = axis_env.get("ep_dispatch", "psum")
            ep = mesh.axis_size("ep")
            ep_group = mesh.group("ep")
            if dispatch == "alltoall":
                self.batch_group, self.batch_n = world, dp * ep
                self.batch_index = mesh.rank
                token_group = world if dp > 1 else ep_group
            else:
                self.batch_group, self.batch_n = dp_group, dp
                self.batch_index = mesh.coord("dp")
                token_group = dp_group
            self.moe = MoEContext(dispatch, ep, dp, ep_group, dp_group,
                                  token_group, mesh.coord("ep"))
        elif strategy == "with_sequence_parallel":
            # the ranks of one dp index hold other positions of the same
            # rows: every rank saw other tokens, and each rank's loss is
            # the whole loss (runtime/tp_plan.py), so the gradients are
            # averaged over the world; the dropout masks are drawn
            # whole on the ranks of one dp index (one salt)
            self.batch_group = world if dp * mesh.axis_size("sp") > 1 \
                else None
            self.batch_n = dp * mesh.axis_size("sp")
            self.batch_index = mesh.rank
        else:
            self.batch_group, self.batch_n = dp_group, dp
            self.batch_index = mesh.coord("dp")
        self.active = world is not None
        self.salt = (mesh.coord("dp") if dp > 1 else None) \
            if strategy == "with_sequence_parallel" else \
            (self.batch_index if self.batch_n > 1 else None)
        prog_plan = getattr(block.program, "_collective_plan", None)
        self.bucket_group = (dp_group if strategy in (
            "with_data_parallel", "with_partitioning") else None)
        if prog_plan is not None and self.bucket_group is not None:
            prog_plan.attach(dp, exchange=True)
        ops = plan.ops

        # -- sharded state ---------------------------------------------------
        tp = mesh.axis_size("tp")
        groups = interleave_groups(block, ops) if tp > 1 else {}
        for n in list(groups):
            # an accumulator of an interleaved parameter is cut alike
            for v in block.vars.values():
                if getattr(v, "accumulator_owner", None) == n and \
                        tuple(v.shape or ()) == tuple(block.var(n).shape):
                    groups[v.name] = groups[n]
        self.shards: Dict[str, Shard] = {}
        shard_axis: Dict[str, str] = {}
        self.zero_accums: Dict[str, Shard] = {}
        self.zero_params: Dict[str, Shard] = {}
        for name, spec in (compiled._state_shardings or {}).items():
            if not block.has_var(name):
                continue
            var = block.var(name)
            shape = tuple(int(d) for d in (var.shape or ()))
            if not shape or any(d < 0 for d in shape):
                continue
            for d, e in enumerate(spec):
                axes = () if e is None else ((e,) if isinstance(e, str)
                                             else tuple(e))
                live = [a for a in axes if mesh.axis_size(a) > 1]
                if not live:
                    continue
                if len(live) > 1:
                    raise NotImplementedError(
                        f"{name!r}: dim {d} is sharded over several live "
                        f"mesh axes {live} at once; the sharded step holds "
                        "a dim over one axis (as the JAX package's rules "
                        "table maps each logical axis to one mesh axis)")
                a = live[0]
                parts = mesh.axis_size(a)
                k = groups.get(name, 1) if a == "tp" else 1
                if shape[d] % (parts * k):
                    raise ValueError(
                        f"{name!r}: dim {d} ({shape[d]}) is not a multiple "
                        f"of the {a} axis ({parts})"
                        + (f" times its {k} fused parts" if k > 1 else ""))
                writer = all(mesh.coord(b) == 0 for b in mesh.axis_names
                             if b != a)
                sh = Shard(d, parts, mesh.coord(a), shape, writer, k)
                self.shards[name] = sh
                shard_axis[name] = a
                if a == "dp":
                    if getattr(var, "is_accumulator", False):
                        self.zero_accums[name] = sh
                    elif isinstance(var, Parameter):
                        self.zero_params[name] = sh
                break

        # -- the optimizer ops over ZeRO chunks ----------------------------
        # param name -> its chunking (from its accumulators)
        owner_shard: Dict[str, Shard] = {}
        for n, sh in self.zero_accums.items():
            owner = getattr(block.var(n), "accumulator_owner", None)
            if owner and block.has_var(owner) and \
                    tuple(block.var(owner).shape) == sh.shape:
                owner_shard[owner] = sh
        self.opt_hooks: Dict[int, Tuple[str, Shard]] = {}
        for i, op in enumerate(ops):
            if not _is_opt(op):
                continue
            pn = (op.inputs.get("Param") or [None])[0]
            if pn in owner_shard:
                self.opt_hooks[i] = (pn, owner_shard[pn])

        # -- gradient reduction --------------------------------------------
        producer: Dict[str, int] = {}
        readers_of: Dict[str, List[int]] = {}
        for i, op in enumerate(ops):
            for n in op.input_arg_names:
                readers_of.setdefault(n, []).append(i)
            for n in op.output_arg_names:
                producer[n] = i
        bucketed = set()
        for op in ops:
            if op.type == OP_TYPE and self.bucket_group is not None:
                bucketed.update(op.inputs.get("X", []))
        self.reduce_after: Dict[int, List[Tuple[str, Any, float]]] = {}
        self.scatter_grads: Dict[str, Tuple[Any, float]] = {}
        self.inplace_ok = set()
        fetch_set = set(fetch_names)
        for p in block.all_parameters():
            if not getattr(p, "trainable", True):
                continue
            g = p.name + "@GRAD"
            idx = producer.get(g)
            if idx is None:
                continue
            group, scale = self._grad_group(p)
            readers = [j for j in readers_of.get(g, ()) if j > idx]
            if g in bucketed:
                only_bucket = all(ops[j].type == OP_TYPE for j in readers)
                if only_bucket and g not in fetch_set:
                    self.inplace_ok.add(g)
                continue
            if group is None and scale == 1.0:
                continue
            if (group is not None and p.name in owner_shard and readers
                    and all(j in self.opt_hooks for j in readers)
                    and g not in fetch_set):
                self.scatter_grads[g] = (group, scale)
                continue
            self.reduce_after.setdefault(idx, []).append((g, group, scale))

        # -- values split along tp or sp (runtime/tp_plan.py) ------------------
        self.shard = None
        sp = mesh.axis_size("sp")
        if tp > 1 or sp > 1:
            axis = "tp" if tp > 1 else "sp"
            if tp > 1 and sp > 1:
                raise NotImplementedError(
                    "a mesh with both tp and sp larger than 1: the sharded "
                    "step splits values along one of them")
            state_dims = {n: sh.dim for n, sh in self.shards.items()
                          if shard_axis[n] == axis}
            feed_dims = {}
            for n, spec in (compiled._in_shardings or {}).items():
                for d, e in enumerate(spec):
                    if e == axis or (isinstance(e, tuple) and axis in e):
                        feed_dims[n] = d
            self.shard = ShardPlan(
                block, ops, mesh, axis, axis, state_dims, feed_dims,
                {n: k for n, k in groups.items() if n in state_dims},
                fetch_names, sp_mode=axis_env.get("sp_mode", "ring"))

        # -- fetches -----------------------------------------------------------
        opt_outs = set()
        for op in ops:
            if _is_opt(op):
                opt_outs.update(op.output_arg_names)
        self.mean_fetches = set()
        for n in fetch_names:
            v = block._find_var_recursive(n)
            if v is not None and v.persistable:
                continue
            if n in opt_outs:
                continue
            self.mean_fetches.add(n)
        self.refused: List[str] = []
        if self.batch_n > 1:
            data = [n for n, v in block.vars.items()
                    if getattr(v, "is_data", False)]
            dtypes = {n: v.dtype for n, v in block.vars.items()}
            self.refused = export_taint(ops, data, fetch_names, dtypes)

    def _grad_group(self, p):
        """(group, scale) a parameter's gradient is averaged with: over
        the ranks that saw other tokens, an expert's over ``dp`` only
        (its ``ep`` peers hold other experts), each scaled by the ranks
        whose tokens reached it."""
        expert = self.moe is not None and getattr(p, "_moe_expert_param",
                                                  False)
        return ((self.moe.dp_group if expert else self.batch_group),
                1.0 / self.batch_n)

    def reduce_merged(self, acc: Dict[str, Any]) -> None:
        """Average a gradient-merge step's merged parameter gradients
        over the world, once: one flat all-reduce a group (the
        expert-parallel experts' over ``dp``, the rest over the ranks
        that saw other tokens)."""
        if self.zero_accums or self.zero_params or self.scatter_grads:
            raise NotImplementedError(
                "gradient merge with ZeRO-sharded state: the merged step "
                "averages whole gradients (use zero=0)")
        by_group: Dict[tuple, List[Tuple[str, Any, float]]] = {}
        for entries in self.reduce_after.values():
            for g, group, scale in entries:
                if g in acc:
                    by_group.setdefault((id(group), acc[g].dtype),
                                        []).append((g, group, scale))
        for entries in by_group.values():
            group, scale = entries[0][1], entries[0][2]
            if group is None:
                for g, _, sc in entries:
                    acc[g] = acc[g] * sc
                continue
            vals = [acc[g] for g, _, _ in entries]
            for v in vals:
                if isinstance(v, SelectedRows):
                    raise NotImplementedError(
                        "a SelectedRows gradient averaged over a data-"
                        "parallel world is the parameter server's work: "
                        "train it through DistributeTranspiler in pserver "
                        "mode (ps.PSTrainer)")
            flat = torch.cat([v.reshape(-1) for v in vals])
            comm.all_reduce(flat, group=group)
            flat.mul_(scale)
            off = 0
            for (g, _, _), v in zip(entries, vals):
                acc[g] = flat[off:off + v.numel()].view_as(v)
                off += v.numel()

    # -- per step ------------------------------------------------------------
    def check_fetches(self) -> None:
        if self.refused:
            n = self.refused[0]
            raise NotImplementedError(
                f"collectives: integer var {n!r} fetched from a "
                "data-parallel step depends on the rank's own batch or "
                "its random draws, so its value differs per rank and has "
                "no cross-replica correction (floats return the mean); "
                "fetch it from a plain run instead")

    def prepare_scope(self, scope) -> None:
        """Cut every sharded var the scope holds whole into this rank's
        chunk, and record the scope's layout for checkpoints."""
        if not self.shards:
            return
        for n, sh in self.shards.items():
            v = scope.find_var(n)
            if isinstance(v, torch.Tensor) and tuple(v.shape) == sh.shape:
                scope.set_var(n, sh.take(v))
        set_layout(scope, self.shards)

    def gather_params(self, env: Dict[str, Any]) -> None:
        """ZeRO-3: the whole parameters for this step's ops."""
        for n, sh in self.zero_params.items():
            if n in env:
                env[n] = _gather_dim(env[n], sh.dim, self.mesh.group("dp"))

    def after_op(self, i: int, env: Dict[str, Any], ctx) -> None:
        for g, group, scale in self.reduce_after[i]:
            t = env[g]
            if isinstance(t, SelectedRows):
                raise NotImplementedError(
                    f"{g!r} is a SelectedRows gradient: averaging sparse "
                    "gradients over a data-parallel world is the "
                    "parameter server's work (DistributeTranspiler in "
                    "pserver mode, ps.PSTrainer)")
            if group is None:
                # no rank shares this gradient, but its tokens came from
                # other ranks' batches (alltoall experts at dp 1)
                t.mul_(scale)
                continue
            work = comm.all_reduce(t, group=group, async_op=True)
            ctx.pending[g] = (work, t, scale)

    def run_opt(self, i: int, op, opdef, ctx, ins):
        """An optimizer op over ZeRO chunks (see the module docstring)."""
        pname, sh = self.opt_hooks[i]
        group = self.mesh.group("dp")
        local = {}
        for slot, vals in ins.items():
            names = op.inputs.get(slot, [])
            out = []
            for n, v in zip(names, vals):
                if n in self.zero_accums or not isinstance(v, torch.Tensor):
                    out.append(v)
                elif n in self.scatter_grads:
                    grp, scale = self.scatter_grads[n]
                    out.append(_scatter_dim(v, sh.dim, grp) * scale)
                elif tuple(v.shape) == sh.shape:
                    out.append(sh.take(v))
                else:
                    out.append(v)
            local[slot] = out
        outs = opdef.lower(ctx, op, local)
        if pname in self.zero_params:
            return outs
        for slot, names in op.outputs.items():
            if pname in names:
                vals = list(outs[slot])
                k = names.index(pname)
                vals[k] = _gather_dim(vals[k], sh.dim, group)
                outs = dict(outs)
                outs[slot] = vals
        return outs

    def finish_fetches(self, fetched: List[Any], names) -> List[Any]:
        sp = self.shard
        if sp is not None and sp.fetch_dims:
            fetched = [unshard(v, sp.fetch_dims[n], sp.n, sp.group,
                               sp._ilv(n))
                       if n in sp.fetch_dims and isinstance(v, torch.Tensor)
                       else v for n, v in zip(names, fetched)]
        if self.batch_n <= 1 or self.batch_group is None:
            return fetched
        out = []
        for n, v in zip(names, fetched):
            if (n in self.mean_fetches and isinstance(v, torch.Tensor)
                    and v.numel() == 1 and v.is_floating_point()):
                v = v.clone()
                comm.all_reduce(v, group=self.batch_group)
                v = v * (1.0 / self.batch_n)
            out.append(v)
        return out


def _gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    if dim == 0:
        return comm.all_gather(t, group)
    return comm.all_gather(t.movedim(dim, 0), group).movedim(0, dim) \
        .contiguous()


def _scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    if dim == 0:
        return comm.reduce_scatter(t, group)
    return comm.reduce_scatter(t.movedim(dim, 0), group).movedim(0, dim) \
        .contiguous()

