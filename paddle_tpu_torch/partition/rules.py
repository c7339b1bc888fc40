"""Logical-axis rules: the single table that turns model-space axis
names into mesh-space placements. A copy of
``paddle_tpu/partition/rules.py`` (pure Python), the port's own.

The reference framework's distribution story is a graph-rewrite pass
per parallelism form (multi_devices_graph_pass.cc scatters vars,
NCCLCommContext carries a ring per collective); T5X showed the
TPU-native replacement is ONE declarative table — an ordered sequence
of (logical axis, mesh axis) pairs — consumed by the partitioner. A tensor
declares what its dimensions MEAN (``("embed", "mlp")``); the rules
decide where those meanings LIVE (``embed -> None`` replicated,
``mlp -> "tp"`` sharded over the tensor-parallel axis); the mesh
decides how much hardware each axis name spans. Changing the
parallelism strategy is a rules/mesh edit — zero model edits, zero
per-subsystem wiring.

Resolution semantics (T5X ``logical_axis_rules``):

* rules are ordered; for each tensor dimension the FIRST rule whose
  logical name matches wins, subject to:
  - a rule mapping to ``None`` (spelled ``embed=`` in flag syntax)
    pins the dimension replicated and stops the search;
  - a rule whose mesh axis is absent from the mesh is inapplicable
    (the same table drives a ``dp``-only training mesh and a
    ``tp``-only serving mesh);
  - one mesh axis may appear at most once per tensor (a second
    ``tp``-mapped dimension falls through to later rules);
  - a static dimension the mesh axis does not divide falls through
    (recorded, so the report can say WHY something stayed replicated).
* no applicable rule -> replicated.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

# (logical axis, mesh axis or None). The canonical mesh axes are
# "dp" (data parallel) and "tp" (tensor parallel); a rules table may
# reference any axis name — rules for axes the mesh doesn't have are
# skipped, so one table serves every mesh shape.
LogicalAxisRules = Sequence[Tuple[str, Optional[str]]]

# The default table: batch over dp; the model's contraction axis
# (embed) replicated; heads/mlp/vocab — the megatron-sharded axes —
# plus kv/kv_pages (attention KV heads and the paged KV-cache pool's
# head dim) and experts over tp.
DEFAULT_RULES: LogicalAxisRules = (
    ("batch", "dp"),
    ("seq", None),
    ("embed", None),
    ("heads", "tp"),
    ("kv", "tp"),
    ("kv_pages", "tp"),
    ("mlp", "tp"),
    ("vocab", "tp"),
    # experts live on the expert-parallel axis: with_expert_parallel,
    # ops/moe.py and the MoE examples all build meshes named "ep" —
    # mapping expert->tp here could never shard an expert-tagged
    # tensor on an actual expert-parallel mesh (the rule was silently
    # inapplicable and the tensor stayed replicated; PTL060 surfaces
    # exactly this class of dead mapping)
    ("expert", "ep"),
    ("stage", None),
)


def parse_mesh(spec) -> Dict[str, int]:
    """``"dp=4,tp=2"`` (or a dict) -> ordered {axis: size}. ``""`` ->
    {} (partitioning disabled)."""
    if spec is None:
        return {}
    if isinstance(spec, dict):
        return {str(k): int(v) for k, v in spec.items()}
    out: Dict[str, int] = {}
    for pos, part in enumerate(str(spec).replace(";", ",").split(","), 1):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"partition mesh: entry {pos} ({part!r}) of {spec!r}: "
                "expected axis=size (e.g. 'dp=4,tp=2')")
        k, v = part.split("=", 1)
        if not k.strip():
            raise ValueError(
                f"partition mesh: entry {pos} ({part!r}) of {spec!r}: "
                "the axis name is empty — expected axis=size "
                "(e.g. 'dp=4,tp=2')")
        try:
            out[k.strip()] = int(v)
        except ValueError:
            raise ValueError(
                f"partition mesh: entry {pos} ({part!r}) of {spec!r}: "
                f"size {v.strip()!r} is not an integer — expected "
                "axis=size (e.g. 'dp=4,tp=2')") from None
    return out


def parse_rules(spec) -> Tuple[Tuple[str, Optional[str]], ...]:
    """``"batch=dp,embed=,heads=tp"`` (or a rules sequence) -> rules
    tuple. An empty right-hand side pins the logical axis replicated."""
    if spec is None:
        return tuple(DEFAULT_RULES)
    if not isinstance(spec, str):
        return tuple((str(l), m if m else None) for l, m in spec)
    out: List[Tuple[str, Optional[str]]] = []
    for pos, part in enumerate(spec.replace(";", ",").split(","), 1):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"partition rules: entry {pos} ({part!r}) of {spec!r}: "
                "expected logical=mesh (e.g. 'heads=tp') or logical= "
                "for replicated")
        l, m = part.split("=", 1)
        if not l.strip():
            raise ValueError(
                f"partition rules: entry {pos} ({part!r}) of {spec!r}: "
                "the logical axis name is empty — expected logical=mesh "
                "(e.g. 'heads=tp')")
        out.append((l.strip(), m.strip() or None))
    return tuple(out)


def resolve_spec(
    logical_axes: Sequence[Optional[str]],
    rules: LogicalAxisRules,
    mesh_axis_sizes: Dict[str, int],
    shape: Optional[Sequence[int]] = None,
):
    """Resolve one tensor's logical axes to a PartitionSpec-like tuple
    (mesh-axis-name-or-None per dim).

    Returns (spec, skipped) where skipped lists
    (dim, logical_axis, mesh_axis, reason) records for dimensions a
    rule WANTED to shard but could not — the partition report surfaces
    these so "why is my mlp replicated" is one lookup.
    """
    spec: List[Optional[str]] = []
    used: set = set()
    skipped: List[Tuple[int, str, str, str]] = []
    for d, la in enumerate(logical_axes):
        assigned = None
        if la is not None:
            for lname, maxis in rules:
                if lname != la:
                    continue
                if maxis is None:
                    break  # explicitly replicated
                size = mesh_axis_sizes.get(maxis)
                if size is None:
                    continue  # axis not on this mesh: rule inapplicable
                if maxis in used:
                    skipped.append((d, la, maxis, "axis already used"))
                    continue
                if shape is not None and d < len(shape):
                    dim = shape[d]
                    if dim is not None and dim > 0 and dim % size:
                        skipped.append(
                            (d, la, maxis,
                             f"dim {dim} not divisible by {maxis}={size}"))
                        continue
                assigned = maxis
                used.add(maxis)
                break
        spec.append(assigned)
    return tuple(spec), skipped


def rules_to_str(rules: LogicalAxisRules) -> str:
    return ",".join(f"{l}={m or ''}" for l, m in rules)
