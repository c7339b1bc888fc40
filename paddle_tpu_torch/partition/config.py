"""PartitionConfig: one flags-driven config that resolves the specs
of parameters, optimizer state and feeds from the logical-axis rules
table, for any Program. The port's counterpart of
``paddle_tpu/partition/config.py``.

``resolve`` is the JAX package's pass, unchanged and pure: it walks the
program's variables and maps each one's logical axes through the rules
onto the mesh's axes, tensor-parallel specs included, so its report
can be held to the JAX package's. Logical axes come from, in order:

1. an explicit ``var.sharding`` annotation, respected when its axes
   exist on the mesh;
2. the variable's ``logical_axes`` tag (``ParamAttr(logical_axes=...)``);
3. ``var_rules``: (regex, logical axes) patterns matched against the
   var name;
4. data vars default to ``("batch", None, ...)``.

Accumulators (the ``is_accumulator`` / ``accumulator_owner`` tags)
inherit their owner parameter's spec, and ``zero >= 1`` shards any
still-replicated divisible dim over ``dp``; ``zero >= 3`` shards the
parameters too.

The mesh of a resolve is a ``parallel.mesh.Mesh`` over the world, or
for a resolve alone any {axis: size} mapping. Executing a resolved
partition (``CompiledProgram.with_partitioning``) runs its ``dp`` axis
with ZeRO and its ``tp`` axis (``runtime/dist_step.py``,
``runtime/tp_plan.py``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .rules import (DEFAULT_RULES, LogicalAxisRules, parse_mesh, parse_rules,
                    resolve_spec, rules_to_str)

__all__ = ["PartitionConfig", "ResolvedPartition"]


def _is_replicated(spec) -> bool:
    return spec is None or all(a is None for a in spec)


def _var_nbytes(var) -> int:
    if not var.shape:
        return 0
    n = 1
    for d in var.shape:
        if d is None or d < 0:
            return 0  # dynamic dim: not a state var in practice
        n *= int(d)
    try:
        return n * np.dtype(var.dtype).itemsize
    except TypeError:
        return 0


class _AxesOnly:
    """A mesh given as {axis: size}: enough for a resolve alone."""

    def __init__(self, axes):
        self.shape = {str(k): int(v) for k, v in dict(axes).items()}
        self.axis_names = tuple(self.shape)
        self.devices = np.arange(int(np.prod(list(self.shape.values())
                                             or [1])))


class ResolvedPartition:
    """The output of ``PartitionConfig.resolve`` for one program: the
    mesh plus a complete sharding assignment, ready to attach to a
    ``CompiledProgram`` (``with_partitioning``) or inspect directly.

    ``report()`` answers "what got sharded and why not the rest";
    the summary also exports as ``paddle_partition_*`` registry gauges
    (one labeled series per live resolve)."""

    def __init__(self, config: "PartitionConfig", program, mesh,
                 in_shardings: Dict[str, Any],
                 state_shardings: Dict[str, tuple],
                 rows: List[Dict[str, Any]]):
        self.config = config
        self.program_uid = program.uid
        self.mesh = mesh
        self.in_shardings = in_shardings
        self.state_shardings = state_shardings
        self.rows = rows
        s = {"state_sharded_bytes": 0, "state_replicated_bytes": 0,
             "vars_sharded": 0, "vars_replicated": 0, "feeds_sharded": 0}
        for r in rows:
            if r["kind"] == "data":
                if not _is_replicated(r["spec"]):
                    s["feeds_sharded"] += 1
                continue
            if _is_replicated(r["spec"]):
                s["state_replicated_bytes"] += r["bytes"]
                s["vars_replicated"] += 1
            else:
                s["state_sharded_bytes"] += r["bytes"]
                s["vars_sharded"] += 1
        self.summary = s
        from ..observability import watch_partition

        watch_partition(self)

    def mesh_axes(self) -> Dict[str, int]:
        return {str(k): int(v) for k, v in dict(self.mesh.shape).items()}

    def report(self) -> Dict[str, Any]:
        """Full resolve report: mesh shape, rules table, per-var rows
        (name, kind, logical axes, resolved spec, bytes, skip reasons)
        and the sharded-vs-replicated byte summary."""
        return {
            "program_uid": self.program_uid,
            "mesh": self.mesh_axes(),
            "rules": rules_to_str(self.config.rules),
            "zero": self.config.zero,
            "summary": dict(self.summary),
            "vars": [dict(r, spec=list(r["spec"]) if r["spec"] else None)
                     for r in self.rows],
        }


class PartitionConfig:
    """Flags-driven partitioner config.

    ``mesh_axes``  — {"dp": 4, "tp": 2} or "dp=4,tp=2"; defaults to the
        ``partition_mesh`` flag. Sizes must multiply to at most the
        available device count (`build_mesh` checks).
    ``rules``      — logical-axis rules table (sequence or flag-syntax
        string); defaults to the ``partition_rules`` flag, which
        defaults to ``rules.DEFAULT_RULES``.
    ``var_rules``  — ((name_regex, logical_axes), ...) applied via
        ``re.search`` to params that carry no ``logical_axes`` tag.
    ``zero``       — ZeRO level: 0 = replicated optimizer state,
        1 = shard accumulators over dp, 3 = shard params too; defaults
        to the ``partition_zero`` flag.
    ``collective_bucket_mb`` / ``collective_quantization`` /
    ``collective_quant_block`` — the gradient-collective planner
        (parallel/collectives.py): bucket the DP gradient all-reduce
        (size cap in MB; 0 = off) and optionally blockwise-int8
        quantize the wire payload; default to the ``collective_*``
        flags. ``with_partitioning`` plans the program when these ask
        for it.
    """

    def __init__(self, mesh_axes=None, rules: Optional[LogicalAxisRules] = None,
                 var_rules: Optional[Sequence[Tuple[str, Sequence[Optional[str]]]]] = None,
                 zero: Optional[int] = None,
                 collective_bucket_mb: Optional[float] = None,
                 collective_quantization: Optional[str] = None,
                 collective_quant_block: Optional[int] = None):
        from ..flags import flag

        self.mesh_axes = parse_mesh(
            mesh_axes if mesh_axes is not None else flag("partition_mesh"))
        self.rules = parse_rules(
            rules if rules is not None else (flag("partition_rules") or None))
        self.var_rules = tuple(
            (re.compile(pat), tuple(axes)) for pat, axes in (var_rules or ()))
        self.zero = int(flag("partition_zero") if zero is None else zero)
        from ..parallel.collectives import parse_bucket_mb

        # a float for the single-value form, an {axis: mb} dict for the
        # per-mesh-axis "dp=32,dcn=8" form (DCN reduces pick bigger
        # buckets) — effective_bucket_mb(mesh) resolves either
        self.collective_bucket_mb = parse_bucket_mb(
            flag("collective_bucket_mb") if collective_bucket_mb is None
            else collective_bucket_mb)
        self.collective_quantization = str(
            flag("collective_quantization") if collective_quantization is None
            else collective_quantization) or "none"
        self.collective_quant_block = int(
            flag("collective_quant_block") if collective_quant_block is None
            else collective_quant_block)

    def effective_bucket_mb(self, mesh=None) -> float:
        """The bucket cap for a gradient reduce on ``mesh`` — the
        per-axis form resolves against whether the mesh's collectives
        cross hosts (``coordinator.spans_processes``)."""
        from ..parallel.collectives import effective_bucket_mb

        return effective_bucket_mb(self.collective_bucket_mb, mesh=mesh)

    def collectives_active(self) -> bool:
        """True when this config asks for the gradient-collective
        planner (bucketed and/or quantized DP all-reduce)."""
        mb = self.collective_bucket_mb
        any_bucket = (any(v > 0 for v in mb.values())
                      if isinstance(mb, dict) else mb > 0)
        return any_bucket or self.collective_quantization != "none"

    def build_mesh(self, devices=None):
        """The ``parallel.mesh.Mesh`` of ``mesh_axes`` over the world
        (its size must be the world's)."""
        from ..parallel.mesh import make_mesh

        if not self.mesh_axes:
            raise ValueError(
                "PartitionConfig has no mesh axes — pass mesh_axes= or "
                "set the partition_mesh flag (e.g. 'dp=4,tp=2')")
        return make_mesh(dict(self.mesh_axes), devices)

    # -- logical-axis sources ------------------------------------------------
    def _axes_of(self, var) -> Optional[Tuple[Optional[str], ...]]:
        la = getattr(var, "logical_axes", None)
        if la is not None:
            return tuple(la)
        for pat, axes in self.var_rules:
            if pat.search(var.name):
                return axes
        return None

    # -- the resolve pass ----------------------------------------------------
    def resolve(self, program, mesh=None, devices=None) -> ResolvedPartition:
        """Walk ``program``'s global block and resolve a complete
        sharding assignment over ``mesh`` (built from ``mesh_axes``
        when not given). Pure: program variables are never mutated —
        the assignment lives in the returned object (and the
        CompiledProgram it is attached to), so one program can compile
        against different meshes."""
        from ..core.framework import Parameter

        mesh = mesh if mesh is not None else self.build_mesh(devices)
        if isinstance(mesh, dict):
            mesh = _AxesOnly(mesh)
        sizes = dict(mesh.shape)
        gb = program.global_block()
        in_shardings: Dict[str, Any] = {}
        state_shardings: Dict[str, tuple] = {}
        rows: List[Dict[str, Any]] = []

        def record(var, kind, la, spec, skipped, note=None):
            rows.append({
                "name": var.name, "kind": kind,
                "logical_axes": list(la) if la else None,
                "spec": spec, "bytes": _var_nbytes(var),
                "skipped": [f"dim{d} {l}->{m}: {why}"
                            for d, l, m, why in (skipped or [])],
                "note": note,
            })

        params: List[Any] = []
        accums: List[Any] = []
        for var in gb.vars.values():
            if getattr(var, "is_data", False) and var.shape:
                exp = self._explicit_spec(var, sizes)
                if exp is not None:
                    spec, note = exp
                    record(var, "data", None, spec, None, note)
                else:
                    la = self._axes_of(var)
                    if la is None:
                        la = ("batch",) + (None,) * (len(var.shape) - 1)
                    # static dims must divide; dynamic (-1) dims are
                    # validated against the actual feed at dispatch bind
                    # time (runtime.dispatch.validate_feed_shardings)
                    shape = [None if (d is None or d < 0) else d
                             for d in var.shape]
                    spec, skipped = resolve_spec(la, self.rules, sizes,
                                                 shape)
                    record(var, "data", la, spec, skipped)
                if not _is_replicated(spec):
                    in_shardings[var.name] = tuple(spec)
            elif getattr(var, "is_accumulator", False):
                accums.append(var)
            elif getattr(var, "persistable", False) and var.shape:
                if isinstance(var, Parameter) or \
                        self._axes_of(var) is not None:
                    params.append(var)

        # a resolved-replicated spec is still RECORDED for any var that
        # carries its own ``sharding`` annotation, so that the record,
        # not the raw annotation (which may name axes this mesh does not
        # have), is what the step holds
        for var in params:
            spec, skipped, note = self._param_spec(var, sizes)
            record(var, "param", self._axes_of(var), spec, skipped, note)
            if not _is_replicated(spec) or \
                    getattr(var, "sharding", None) is not None:
                state_shardings[var.name] = tuple(spec)

        for var in accums:
            spec, note = self._accum_spec(var, gb, state_shardings, sizes)
            record(var, "accumulator", None, spec, None, note)
            if not _is_replicated(spec) or \
                    getattr(var, "sharding", None) is not None:
                state_shardings[var.name] = tuple(spec)

        return ResolvedPartition(self, program, mesh, in_shardings,
                                 state_shardings, rows)

    @staticmethod
    def _explicit_spec(var, sizes):
        """The var's own ``sharding`` annotation validated against
        THIS mesh: (spec, note) respected verbatim when every
        referenced axis exists, overridden replicated (with a report
        note) when not — e.g. a checkpointed model whose serialized
        tags name a dp/ep mesh, served on a tp-only one. None when the
        var carries no annotation."""
        explicit = getattr(var, "sharding", None)
        if explicit is None:
            return None
        flat = [a for e in explicit if e is not None
                for a in ((e,) if isinstance(e, str) else tuple(e))]
        if all(a in sizes for a in flat):
            return tuple(explicit), "explicit var.sharding"
        return ((None,) * len(var.shape),
                f"explicit var.sharding {tuple(explicit)} references "
                "axes absent from this mesh — overridden replicated")

    def _param_spec(self, var, sizes):
        exp = self._explicit_spec(var, sizes)
        if exp is not None:
            return exp[0], None, exp[1]
        la = self._axes_of(var)
        spec: tuple = (None,) * len(var.shape)
        skipped = None
        if la is not None:
            spec, skipped = resolve_spec(la, self.rules, sizes, var.shape)
        if self.zero >= 3:
            spec = self._zero_shard(spec, var.shape, sizes)
        return spec, skipped, None

    def _accum_spec(self, var, gb, state_shardings, sizes):
        """Accumulators inherit their owner param's spec (same-shape
        moments must co-locate with the param shards their update
        reads), then ZeRO-1 shards any still-replicated divisible dim
        over dp. Scalar state (beta-pow etc.) stays replicated —
        sharding O(1) bytes buys nothing."""
        if not var.shape or max(var.shape) <= 1:
            return (None,) * len(var.shape or ()), "scalar: replicated"
        exp = self._explicit_spec(var, sizes)
        if exp is not None and exp[1] == "explicit var.sharding":
            return exp
        # annotation naming foreign axes: fall through to structural
        # inheritance (the caller records the result either way, so
        # the raw annotation never reaches the step)
        spec = (None,) * len(var.shape)
        note = None
        owner = getattr(var, "accumulator_owner", None)
        if owner and owner in state_shardings and gb.has_var(owner) and \
                tuple(gb.var(owner).shape) == tuple(var.shape):
            spec = state_shardings[owner]
            note = f"inherited from owner {owner!r}"
        if self.zero >= 1:
            z = self._zero_shard(spec, var.shape, sizes)
            if z != spec:
                note = (note + " + " if note else "") + "zero-dp"
                spec = z
        return spec, note

    @staticmethod
    def _zero_shard(spec, shape, sizes):
        """Add a dp shard on the first still-replicated dim dp divides
        (the ``parallel.sharding.shardable_dim`` policy, composed with
        whatever tp placement the rules already made)."""
        dp = sizes.get("dp", 1)
        # spec entries may be joint-axis tuples (("dp","tp"), None) —
        # flatten before asking "is dp already placed", else ZeRO adds
        # a second dp placement and NamedSharding rejects the dup
        used = {a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else tuple(e))}
        if dp <= 1 or "dp" in used:
            return spec
        for d, extent in enumerate(shape):
            if spec[d] is None and extent and extent >= dp \
                    and extent % dp == 0:
                return spec[:d] + ("dp",) + spec[d + 1:]
        return spec
