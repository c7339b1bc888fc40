"""Program-level pipeline parallelism: the port's counterpart of
``paddle_tpu/core/pipeline_program.py``.

A ``PipelineOptimizer`` program compiled ``with_pipeline`` runs a stage
a rank over the mesh's ``pp`` axis. The forward ops split at the cut
vars into S segments (``_segment_ops``); rank s runs segment s for each
of the M microbatches of the feed (``num_microbatches``), under
autograd, in the GPipe or 1F1B schedule of
``parallel.pipeline.run_stage``: activations at the cuts go to the next
stage, their gradients come back. As in the JAX package, the Program's
appended grad ops are not run: the backward is autograd through each
stage's ops (the kernels' own backward: K3, K5, K8), and the optimizer
and learning-rate ops then run once on the merged gradients, each
stage's on its own parameters. The global-norm clip's squared sums are
summed over the stages (each parameter is one stage's), so every stage
clips by the whole model's norm.

The losses and metrics fetched are the last stage's, summed over the
microbatches and recombined as the JAX package does (``_aux_kind``):
a batch mean (``mean``, ``reduce_mean``) is divided by M, a sum kept,
and a ratio of sums (BERT's masked mean, ``reduce_sum(ce * mask) /
reduce_sum(mask)``) divides the summed numerator by the summed
denominator. GPipe seeds each microbatch's backward with the
recombination's gradient after every forward has run (exact for any
ratio); 1F1B must seed before, so a ratio's denominator has to come
from the feeds alone and is computed first from the whole batch
(``_ratio_den_ops``, ``_grad_scale_1f1b``). The fetched values are
broadcast from the last stage to every rank.

With ``dp`` the ranks of one stage average their gradients (and the
fetches) over the ``dp`` axis; each ``dp`` shard's ranks feed its rows.
A stage rank's scope holds its own stage's parameters and accumulators
current; the others' stay as they were (``sync_stage_state`` brings
every stage's to every rank).

Constraints, checked with the JAX package's errors: every cut boundary
carries the same activation structure; the forward writes no
persistable var; fetched values are the last stage's floating scalars.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .framework import OpRole
from .registry import LoweringContext, get_op_def

__all__ = ["PipelineStep", "sync_stage_state"]

_SUM_OPS = {"reduce_sum", "sum"}
_MEAN_OPS = {"mean", "reduce_mean", "accuracy", "auc"}
_TRANSPARENT = {"scale", "cast", "reshape", "reshape2", "squeeze",
                "squeeze2", "unsqueeze", "unsqueeze2", "assign"}


def _role(op) -> int:
    return int(op.attrs.get("op_role", 0) or 0)


def _segment_ops(fwd_ops, cut_names: List[str]):
    segments, cur = [], []
    remaining = set(cut_names)
    for op in fwd_ops:
        cur.append(op)
        hit = remaining.intersection(op.output_arg_names)
        if hit:
            remaining -= hit
            segments.append(cur)
            cur = []
    if remaining:
        raise ValueError(
            f"pipeline cut vars never produced: {sorted(remaining)}")
    if cur:
        segments.append(cur)
    if len(segments) != len(cut_names) + 1:
        raise ValueError(
            f"{len(cut_names)} pipeline cuts yield {len(segments)} segments, "
            f"not {len(cut_names) + 1} — duplicate cut vars, one op producing "
            "several cut vars, or a cut var produced after the last op?")
    return segments


def _split_roles(block):
    """(forward ops, optimizer-section ops): the optimizer section is the
    Optimize / LRSched ops and the forward-role ops after the backward
    (the gradient clip's and regularizers' arithmetic, which both
    packages emit with the forward role)."""
    ops = [op for op in block.ops if op.type not in ("feed", "fetch")]
    start = next((i for i, op in enumerate(ops)
                  if _role(op) & OpRole.Backward), len(ops))
    fwd, opt = [], []
    for i, op in enumerate(ops):
        role = _role(op)
        if role & (OpRole.Optimize | OpRole.LRSched):
            opt.append(op)
        elif role & OpRole.Backward:
            continue
        elif i < start:
            fwd.append(op)
        else:
            opt.append(op)
    return fwd, opt


def _run_ops(ops, env: Dict[str, Any], ctx) -> None:
    for op in ops:
        opdef = get_op_def(op.type)
        ins = {}
        for slot in opdef.input_slots:
            names = op.inputs.get(slot)
            if names:
                ins[slot] = [env[n] for n in names]
        outs = opdef.lower(ctx, op, ins)
        for slot, names in op.outputs.items():
            vals = outs.get(slot, [])
            for j, n in enumerate(names):
                if j < len(vals):
                    env[n] = vals[j]


class PipelineStep:
    """What a bound step of a ``with_pipeline`` compile runs (module
    docstring). Built once at bind time."""

    def __init__(self, compiled, block, feed_names, fetch_names,
                 state_names, written):
        program = block.program
        mesh = compiled._mesh
        self.block = block
        self.mesh = mesh
        self.S = mesh.axis_size("pp")
        self.stage = mesh.coord("pp")
        self.group = mesh.group("pp")
        self.dp = mesh.axis_size("dp")
        self.dp_group = mesh.group("dp")
        self.dp_index = mesh.coord("dp")
        cuts = list(program._pipeline_cuts)
        self.M = int(getattr(program, "_pipeline_microbatches", 0) or 4)
        self.schedule = getattr(program, "_pipeline_schedule", "gpipe")
        if self.S != len(cuts) + 1:
            raise ValueError(
                f"pipeline has {len(cuts) + 1} stages ({len(cuts)} cuts) but "
                f"mesh axis 'pp' is {self.S} devices")
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        fwd_ops, self.opt_ops = _split_roles(block)
        self.fwd_ops = fwd_ops
        self.segments = _segment_ops(fwd_ops, cuts)
        fwd_written = {n for op in fwd_ops
                       for n in op.output_arg_names} & set(written)
        opt_written = {n for op in self.opt_ops for n in op.output_arg_names}
        bad = fwd_written - opt_written
        if bad:
            raise NotImplementedError(
                f"pipeline forward writes persistable vars {sorted(bad)} — "
                "per-microbatch state writes are not supported; move them "
                "out of the pipelined region")
        loss_name = None
        for op in block.ops:
            if _role(op) & OpRole.Loss and op.type == "fill_constant":
                out = op.outputs["Out"][0]
                if out.endswith("@GRAD"):
                    loss_name = out[: -len("@GRAD")]
        if loss_name is None:
            raise ValueError(
                "pipeline program has no loss op (run minimize first)")
        self.loss_name = loss_name
        seg_produced = [{n for op in seg for n in op.output_arg_names}
                        for seg in self.segments]
        produced_any = set().union(*seg_produced)
        self.aux_names = sorted(
            ({loss_name} | (set(fetch_names) & produced_any)) - opt_written)
        self.aux_kinds = {n: self._aux_kind(n) for n in self.aux_names}
        self.aux_fetch = list(dict.fromkeys(
            x for n in self.aux_names
            for x in (self.aux_kinds[n][1:]
                      if self.aux_kinds[n][0] == "ratio" else (n,))))
        not_last = [n for n in self.aux_names if n not in seg_produced[-1]]
        if not_last:
            raise NotImplementedError(
                f"fetch vars {not_last} are produced by a non-final pipeline "
                "stage; only last-stage scalars can be fetched under "
                "pipelining")
        self.boundaries: List[List[str]] = []
        for i in range(self.S - 1):
            before = set().union(*seg_produced[: i + 1])
            after = {n for seg in self.segments[i + 1:] for op in seg
                     for n in op.input_arg_names}
            self.boundaries.append(sorted(before & after))
        state_set = set(state_names)
        self.grad_wanted = sorted({
            n[: -len("@GRAD")] for op in self.opt_ops
            for n in op.input_arg_names
            if n.endswith("@GRAD") and n[: -len("@GRAD")] in state_set})
        reads = [{n for op in seg for n in op.input_arg_names}
                 for seg in self.segments]
        self.owner: Dict[str, int] = {}
        for p in self.grad_wanted:
            stages = [s for s in range(self.S) if p in reads[s]]
            if len(stages) != 1:
                raise NotImplementedError(
                    f"parameter {p!r} is read by stages {stages}: each "
                    "parameter must belong to one pipeline stage")
            self.owner[p] = stages[0]
        # sorted: the ranks of one stage reduce these in one order
        self.own = sorted(p for p, s in self.owner.items()
                          if s == self.stage)
        for op in self.opt_ops:
            for n in op.input_arg_names:
                ok = (n in state_set or n in opt_written
                      or n == loss_name or n in self.aux_names
                      or (n.endswith("@GRAD")
                          and n[: -len("@GRAD")] in state_set))
                if not ok:
                    raise NotImplementedError(
                        f"optimizer op {op.type!r} consumes {n!r}, which "
                        "the pipelined step does not materialize")
        self.live = ({n for op in fwd_ops for n in op.input_arg_names}
                     | set(self.aux_fetch)
                     | {n for b in self.boundaries for n in b})
        self.like = None
        self.peak_stash = 0

    # -- the recombination of the last stage's scalars -------------------------
    def _producer(self, name):
        for op in reversed(self.fwd_ops):
            if name in op.output_arg_names:
                return op
        return None

    def _sum_chain(self, name):
        n, hops = name, 0
        while hops < 32:
            op = self._producer(n)
            if op is None:
                return None
            if op.type in _SUM_OPS:
                return "sum"
            if op.type in _MEAN_OPS:
                return "mean"
            if op.type in _TRANSPARENT:
                if op.type == "scale" and \
                        float(op.attrs.get("bias", 0.0)) != 0.0:
                    return None
                n = op.inputs.get("X", [None])[0]
                hops += 1
                continue
            return None
        return None

    def _aux_is_mean(self, name) -> bool:
        n, hops, op = name, 0, None
        while hops < 32:
            op = self._producer(n)
            if op is None:
                break
            if op.type in _MEAN_OPS:
                return True
            if op.type in _SUM_OPS:
                return False
            if op.type in _TRANSPARENT:
                n = op.inputs.get("X", [None])[0]
                hops += 1
                continue
            break
        raise NotImplementedError(
            f"cannot tell whether {name!r} is a batch mean or sum (producer "
            f"chain ends at {op.type if op else '<feed>'}); end the loss/"
            "metric in mean/reduce_mean or reduce_sum so the pipelined "
            "microbatch aggregation is well-defined")

    def _aux_kind(self, name):
        op = self._producer(name)
        if (op is not None and op.type == "elementwise_div"
                and self._sum_chain(op.inputs["X"][0]) == "sum"
                and self._sum_chain(op.inputs["Y"][0]) == "sum"):
            return ("ratio", op.inputs["X"][0], op.inputs["Y"][0])
        return ("mean",) if self._aux_is_mean(name) else ("sum",)

    def _recombine(self, vals):
        out = {}
        for n in self.aux_names:
            k = self.aux_kinds[n]
            if k[0] == "ratio":
                out[n] = vals[k[1]] / vals[k[2]]
            elif k[0] == "mean":
                out[n] = vals[n] / self.M
            else:
                out[n] = vals[n]
        return out

    def _den_subgraph_ops(self, name):
        needed, chosen = {name}, []
        for op in reversed(self.fwd_ops):
            if set(op.output_arg_names) & needed:
                chosen.append(op)
                needed |= set(op.input_arg_names)
        chosen.reverse()
        produced = {n for op in chosen for n in op.output_arg_names}
        external = {n for op in chosen for n in op.input_arg_names} \
            - produced
        return chosen, external

    def _ratio_den_ops(self):
        k = self.aux_kinds[self.loss_name]
        chosen, external = self._den_subgraph_ops(k[2])
        if external - set(self.feed_names):
            raise NotImplementedError(
                "ratio-of-sums loss whose denominator depends on non-feed "
                f"vars {sorted(external - set(self.feed_names))} cannot "
                "seed the hand-scheduled 1F1B backward — use "
                "schedule='gpipe' (exact for any ratio), or make the "
                "denominator feed-only")
        return chosen

    def _coeffs(self, totals, env, ctx):
        """The gradient seed of each last-stage scalar (``aux_fetch``
        order): d loss / d (its sum over the microbatches)."""
        k = self.aux_kinds[self.loss_name]
        if totals is None:
            # 1F1B: before any forward has run
            if k[0] == "mean":
                return tuple(1.0 / self.M if n == self.loss_name else 0.0
                             for n in self.aux_fetch)
            if k[0] == "sum":
                return tuple(1.0 if n == self.loss_name else 0.0
                             for n in self.aux_fetch)
            denv = dict(env)
            with torch.no_grad():
                _run_ops(self._ratio_den_ops(), denv, ctx)
            den = float(denv[k[2]].reshape(()))
            return tuple(1.0 / den if n == k[1] else 0.0
                         for n in self.aux_fetch)
        leaves = [t.detach().clone().requires_grad_(True) for t in totals]
        with torch.enable_grad():
            loss = self._recombine(dict(zip(self.aux_fetch,
                                            leaves)))[self.loss_name]
            gs = torch.autograd.grad(loss.reshape(()), leaves,
                                     allow_unused=True)
        return tuple(0.0 if g is None else g.detach() for g in gs)

    # -- one step ------------------------------------------------------------
    def _boundary_like(self, mb: int):
        """(shape, dtype) of each boundary tensor from the block's
        declared shapes (the batch dim a microbatch of ``mb`` rows), and
        the fetched scalars checked likewise."""
        from .executor import torch_dtype

        def shape_of(n):
            v = self.block.var(n)
            shape = [int(d) for d in (v.shape or ())]
            if any(d < 0 for d in shape[1:]):
                raise NotImplementedError(
                    f"pipeline boundary {n!r} has a dynamic dim past the "
                    f"batch ({shape}); the schedule exchanges fixed shapes")
            if shape and shape[0] < 0:
                shape[0] = mb
            return tuple(shape), torch_dtype(v.dtype)

        sigs = [tuple(shape_of(n) for n in b) for b in self.boundaries]
        if len(set(sigs)) > 1:
            raise NotImplementedError(
                "pipeline cut boundaries carry different activation "
                f"structures {sigs}; v1 requires uniform boundaries "
                "(equal widths at every cut)")
        for n in self.aux_fetch:
            shape, dt = shape_of(n)
            if int(np.prod(shape)) != 1:
                raise NotImplementedError(
                    f"fetch var {n!r} has shape {shape}; only scalar "
                    "last-stage metrics can be fetched under pipelining")
            if not dt.is_floating_point:
                raise NotImplementedError(
                    f"fetch var {n!r} has dtype {dt}; integer metrics "
                    "cannot be microbatch-averaged under pipelining")
        return sigs[0] if sigs else ()

    def run(self, bound, env: Dict[str, Any], step: int) -> Dict[str, Any]:
        from ..parallel import comm
        from ..parallel.pipeline import run_stage

        ex = bound.executor
        M, s, S = self.M, self.stage, self.S
        feeds = {}
        for n in self.feed_names:
            v = env[n]
            if v.shape[0] % M:
                raise ValueError(
                    f"pipeline microbatches M={M} does not divide batch "
                    f"{v.shape[0]} of feed {n!r}")
            feeds[n] = v.reshape((M, v.shape[0] // M) + tuple(v.shape[1:]))
        if self.like is None:
            self.like = self._boundary_like(
                next(iter(feeds.values())).shape[1] if feeds else 1)
        leaves = {p: env[p].detach().requires_grad_(True) for p in self.own}
        base = {n: v for n, v in env.items() if n not in feeds}
        base.update(leaves)
        salt = self.dp_index if self.dp > 1 else None
        seg = self.segments[s]
        bnames_in = self.boundaries[s - 1] if s > 0 else []
        bnames_out = self.boundaries[s] if s < S - 1 else []

        def ctx_for(j):
            ctx = LoweringContext(ex.device, seed=bound.seed, step=step,
                                  live=self.live, constants=ex._constants,
                                  fold=j)
            ctx.salt = salt
            return ctx

        def forward(j, xs):
            local = dict(base)
            local.update({n: v[j] for n, v in feeds.items()})
            if xs is not None:
                local.update(zip(bnames_in, xs))
            _run_ops(seg, local, ctx_for(j))
            if s < S - 1:
                return tuple(local[n] for n in bnames_out)
            return tuple(local[n].reshape(()) for n in self.aux_fetch)

        full = {n: env[n] for n in self.feed_names}
        full.update(base)
        aux, self.peak_stash = run_stage(
            forward, M, self.group, self.like, self.schedule,
            lambda totals: self._coeffs(totals, full, ctx_for(M)),
            device=ex.device)

        # the fetched scalars: the last stage's, on every rank
        vals = torch.zeros(len(self.aux_fetch), dtype=torch.float32,
                           device=ex.device)
        if aux is not None:
            vals = torch.stack([sum(a[k] for a in aux).float().reshape(())
                                for k in range(len(self.aux_fetch))])
        if self.group is not None:
            comm.broadcast(vals, S - 1, self.group)
        out = dict(env)
        rec = self._recombine(dict(zip(self.aux_fetch, vals)))
        if self.dp > 1:
            for n in list(rec):
                v = rec[n].reshape(1).clone()
                comm.all_reduce(v, group=self.dp_group)
                rec[n] = v[0] / self.dp
        for n, v in rec.items():
            var = self.block.var(n) if self.block.has_var(n) else None
            shape = tuple(int(d) for d in var.shape) if var is not None \
                and var.shape else ()
            out[n] = v.reshape(shape)
        # the stage's gradients, averaged over dp
        for p, leaf in leaves.items():
            g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
            if self.dp > 1:
                comm.all_reduce(g, group=self.dp_group)
                g.mul_(1.0 / self.dp)
            out[p] = env[p]
            out[p + "@GRAD"] = g
        self._run_optimizer(out, ctx_for(M))
        return out

    def _run_optimizer(self, env, ctx) -> None:
        """The optimizer and learning-rate ops, each update on the
        stage's own parameters; a reduction of gradients (the global-norm
        clip's squared sums) summed over the stages, a stage counting
        the parameters it owns."""
        from ..parallel import comm

        absent = {p + "@GRAD" for p in self.owner if p not in self.own}
        grad_derived = {p + "@GRAD" for p in self.owner}
        with torch.no_grad():
            for op in self.opt_ops:
                ins_names = op.input_arg_names
                if "Param" in op.inputs and op.inputs["Param"] and \
                        op.inputs["Param"][0] in self.owner and \
                        op.inputs["Param"][0] not in self.own:
                    continue
                reads_absent = any(n in absent for n in ins_names)
                derived = reads_absent or any(n in grad_derived
                                              for n in ins_names)
                if op.type in ("reduce_sum", "reduce_mean") and derived:
                    if reads_absent:
                        v = torch.zeros((), dtype=torch.float32,
                                        device=ctx.device)
                        shape = self.block.var(op.outputs["Out"][0]).shape
                        v = v.reshape([int(d) for d in shape] if shape
                                      else [])
                    else:
                        opdef = get_op_def(op.type)
                        v = opdef.lower(ctx, op, {"X": [env[
                            op.inputs["X"][0]]]})["Out"][0].clone()
                    comm.all_reduce(v, group=self.group)
                    env[op.outputs["Out"][0]] = v
                    continue
                if reads_absent:
                    absent.update(op.output_arg_names)
                    grad_derived.update(op.output_arg_names)
                    continue
                _run_ops([op], env, ctx)
                if derived:
                    grad_derived.update(op.output_arg_names)


def sync_stage_state(program, scope, compiled) -> None:
    """Bring every stage's parameters and accumulators to every rank of
    the ``pp`` axis (each from the rank whose stage owns it), so the
    scope holds the whole model: for a checkpoint or an evaluation
    after pipelined training."""
    from ..parallel import comm

    mesh = compiled._mesh
    group = mesh.group("pp")
    if group is None:
        return
    block = program.global_block()
    cuts = list(program._pipeline_cuts)
    segs = _segment_ops(_split_roles(block)[0], cuts)
    owner = {}
    for s, seg in enumerate(segs):
        for op in seg:
            for n in op.input_arg_names:
                v = block.var(n) if block.has_var(n) else None
                if v is not None and getattr(v, "trainable", False) and \
                        n not in owner:
                    owner[n] = s
    for v in block.vars.values():
        o = getattr(v, "accumulator_owner", None)
        if o in owner:
            owner[v.name] = owner[o]
    for n in sorted(owner):
        t = scope.find_var(n)
        if isinstance(t, torch.Tensor):
            comm.broadcast(t, owner[n], group)
