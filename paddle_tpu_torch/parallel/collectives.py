"""Gradient-collective planner: bucketed, backward-overlapped,
optionally int8-quantized data-parallel gradient all-reduce. The port's
counterpart of ``paddle_tpu/parallel/collectives.py``.

``ensure_planned`` is the JAX package's program rewrite, unchanged: it
partitions the parameter gradients into size-capped buckets in
backward-production order and inserts one ``collective_bucket_reduce``
op right after each bucket's last producer, repointing every later
consumer (clip, regularization, the optimizer ops) at the reduced
twins (``<grad>@BUCKETREDUCED``).

Where the JAX package then splits the step into a ``shard_map``
region, the port's eager step runs the bucket op at its place in the
program: each of its gradients is handed to ``all_reduce(async_op=True)``
over the data-parallel group right there, and the first op that reads a
reduced gradient waits on its handle (``runtime.dist_step``), so the
exchange runs under the rest of the backward. The fp32 path reduces
each gradient on its own, never as one flat buffer: the bucketed step
must equal the unbucketed one bit for bit, and slicing gradients back
out of a flat buffer would change how later consumers sum them. The
int8 path reduces a bucket as one flat payload a dtype through
``kernels.quant.quantized_mean``.

Semantics (the reference's GradAllReduce + 1/nranks): the loss is a
batch mean, each rank computes the gradients of its local batch's mean,
and the bucket op averages them. A scalar float fetch computed before
the optimizer is returned as the cross-replica mean; any other fetch is
the rank's own value, and an integer fetch that depends on the rank's
batch or on its random draws is refused (the export-taint check), since
it has no cross-replica correction.
"""

from __future__ import annotations

import contextlib
import logging
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_log = logging.getLogger("paddle_tpu_torch.collectives")

OP_TYPE = "collective_bucket_reduce"
REDUCED_SUFFIX = "@BUCKETREDUCED"

__all__ = ["CollectivePlan", "ensure_planned", "suppress_planning",
           "OP_TYPE", "REDUCED_SUFFIX", "parse_bucket_mb",
           "effective_bucket_mb", "export_taint"]


def parse_bucket_mb(spec):
    """``collective_bucket_mb`` in either form: a single size (number or
    numeric string, applied to every axis) or per mesh axis
    ``"dp=32,dcn=8"`` (sizes in MB). Returns a float or an {axis: mb}
    dict; a malformed entry is named by its position."""
    if spec is None:
        return 0.0
    if isinstance(spec, (int, float)):
        return float(spec)
    if isinstance(spec, dict):
        return {str(k): float(v) for k, v in spec.items()}
    s = str(spec).strip()
    if not s:
        return 0.0
    if "=" not in s:
        try:
            return float(s)
        except ValueError:
            raise ValueError(
                f"collective_bucket_mb: {s!r} is neither a bucket size "
                "in MB nor the per-axis form axis=mb[,axis=mb...] "
                "(e.g. '32' or 'dp=32,dcn=8')") from None
    out: Dict[str, float] = {}
    for pos, part in enumerate(s.replace(";", ",").split(","), 1):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"collective_bucket_mb: entry {pos} ({part!r}) of "
                f"{spec!r}: expected axis=mb (e.g. 'dp=32,dcn=8')")
        k, v = part.split("=", 1)
        if not k.strip():
            raise ValueError(
                f"collective_bucket_mb: entry {pos} ({part!r}) of "
                f"{spec!r}: the axis name is empty — expected axis=mb "
                "(e.g. 'dp=32,dcn=8')")
        try:
            out[k.strip()] = float(v)
        except ValueError:
            raise ValueError(
                f"collective_bucket_mb: entry {pos} ({part!r}) of "
                f"{spec!r}: size {v.strip()!r} is not a number (MB) — "
                "expected axis=mb (e.g. 'dp=32,dcn=8')") from None
    return out


def effective_bucket_mb(spec, mesh=None, crosses_hosts=None) -> float:
    """The bucket cap for the data-parallel gradient reduce under
    ``spec``. The per-axis form picks ``dcn`` first for a reduce that
    crosses processes (a mesh of more than one process, or with no mesh
    a world of more than one) and ``dp`` first otherwise; either falls
    back to the other, and no match means 0 (planner off)."""
    parsed = parse_bucket_mb(spec)
    if not isinstance(parsed, dict):
        return parsed
    if crosses_hosts is None:
        if mesh is not None:
            from ..distributed.coordinator import spans_processes

            crosses_hosts = spans_processes(mesh)
        else:
            from .env import get_world_size

            crosses_hosts = get_world_size() > 1
    for axis in (("dcn", "dp") if crosses_hosts else ("dp", "dcn")):
        if axis in parsed:
            return float(parsed[axis])
    return 0.0


def _numel(shape) -> int:
    n = 1
    for d in shape or ():
        if d is None or d < 0:
            return 0
        n *= int(d)
    return n


def _itemsize(dtype) -> int:
    try:
        return np.dtype(str(dtype)).itemsize
    except TypeError:
        return 4


class CollectivePlan:
    """The planner's output, stamped on the Program as
    ``_collective_plan``: the buckets and the quantization settings,
    with the wire-byte model exported as ``paddle_collective_*{plan=}``
    gauges."""

    def __init__(self, program, buckets: List[Dict[str, Any]],
                 quantization: str, quant_block: int, bucket_mb: float,
                 axis: str = "dp"):
        self._program = weakref.ref(program)
        self.buckets = buckets
        self.quantization = quantization
        self.quant_block = int(quant_block)
        self.bucket_mb = float(bucket_mb)
        self.axis = axis
        # timing-only mode: the bucket ops run as identities so that a
        # compute-only step can be measured; toggling re-binds
        self.skip_reduce = False
        self._dp: Optional[int] = None
        self._exchange = False
        from ..observability import watch_collectives

        watch_collectives(self)

    def reduced_names(self) -> List[str]:
        return [n for b in self.buckets for n in b["reduced"]]

    def fingerprint(self) -> Tuple:
        return (tuple(tuple(b["grads"]) for b in self.buckets),
                self.quantization, self.quant_block, self.skip_reduce)

    def set_skip_reduce(self, flag: bool) -> None:
        if bool(flag) == self.skip_reduce:
            return
        self.skip_reduce = bool(flag)
        prog = self._program()
        if prog is not None:
            prog._bump()

    def attach(self, dp: int, exchange: bool = True) -> None:
        """Record the data-parallel degree the plan runs at (and whether
        the int8 mode runs the real exchange), so the wire gauges are
        concrete."""
        self._dp = int(dp)
        self._exchange = bool(exchange)

    def wire_stats(self) -> Dict[str, float]:
        """Per-device per-step wire bytes under the ring model: fp32
        moves 2(n-1)/n of the payload, the quantized two-shot exchange
        2(n-1)/n of the int8 body and its scales. Zeros until the plan
        ran over a group of more than one rank."""
        dp = self._dp
        if not dp or dp <= 1:
            return {"wire_bytes_per_step": 0.0,
                    "wire_bytes_fp32_per_step": 0.0,
                    "wire_bytes_saved_per_step": 0.0,
                    "wire_bytes_saved_ratio": 1.0}
        ring = 2.0 * (dp - 1) / dp
        fp32 = q = 0.0
        for b in self.buckets:
            numel = sum(b["numels"])
            fp32 += ring * sum(
                ne * it for ne, it in zip(b["numels"], b["itemsizes"]))
            if self.quantization == "int8":
                nb = -(-numel // self.quant_block)
                nb = -(-nb // dp) * dp
                if self._exchange:
                    q += ring * (nb * self.quant_block + 4 * nb)
                else:
                    q += ring * nb * self.quant_block * 4
            else:
                q += ring * sum(
                    ne * it for ne, it in zip(b["numels"], b["itemsizes"]))
        return {
            "wire_bytes_per_step": q,
            "wire_bytes_fp32_per_step": fp32,
            "wire_bytes_saved_per_step": fp32 - q,
            "wire_bytes_saved_ratio": (fp32 / q) if q else 1.0,
        }

    def snapshot(self) -> Dict[str, Any]:
        out = {
            "buckets": len(self.buckets),
            "grads_total": sum(len(b["grads"]) for b in self.buckets),
            "bucket_bytes_max": max(
                (b["bytes"] for b in self.buckets), default=0),
            "quant_block": self.quant_block if self.quantization != "none"
            else 0,
            "quantized": self.quantization == "int8",
            "quantized_exchange": (self.quantization == "int8"
                                   and self._exchange),
            "dp": self._dp or 0,
        }
        out.update(self.wire_stats())
        return out


def _grad_pairs_from_block(block):
    """(param, grad var) by the append_backward naming convention."""
    pairs = []
    for p in block.all_parameters():
        if not getattr(p, "trainable", True):
            continue
        g = block.vars.get(p.name + "@GRAD")
        if g is not None:
            pairs.append((p, g))
    return pairs


_SUPPRESSED = 0


@contextlib.contextmanager
def suppress_planning():
    """Make ``ensure_planned`` a no-op inside the ``with`` body (for
    optimizers whose gradient flow the planner must not touch)."""
    global _SUPPRESSED
    _SUPPRESSED += 1
    try:
        yield
    finally:
        _SUPPRESSED -= 1


def ensure_planned(program=None, params_grads=None, bucket_mb=None,
                   quantization=None, quant_block=None
                   ) -> Optional[CollectivePlan]:
    """Plan gradient collectives for ``program`` if the flags (or the
    arguments) ask for them and it has parameter gradients. Idempotent:
    a program is planned at most once (``program._collective_plan``).
    Returns the plan, or None when planning is off or inapplicable."""
    from ..core.framework import OpRole, default_main_program
    from ..flags import flag

    program = program if program is not None else default_main_program()
    mb = effective_bucket_mb(
        flag("collective_bucket_mb") if bucket_mb is None else bucket_mb)
    quant = str(flag("collective_quantization") if quantization is None
                else quantization) or "none"
    qblock = int(flag("collective_quant_block") if quant_block is None
                 else quant_block)
    if quant not in ("none", "int8"):
        raise ValueError(
            f"collective_quantization={quant!r}: supported modes are "
            "'none' (fp32 psum) and 'int8' (blockwise-quantized)")
    if qblock <= 0:
        raise ValueError(
            f"collective_quant_block={qblock}: block must be positive")
    off = mb <= 0 and quant == "none"
    if mb <= 0 and not off:
        mb = 25.0  # quantization requested: a sane default bucket cap

    existing = getattr(program, "_collective_plan", None)
    if existing is not None:
        if (off or quant != existing.quantization
                or (quant == "int8" and qblock != existing.quant_block)
                or mb != existing.bucket_mb):
            _log.warning(
                "collectives: program already planned with bucket_mb=%s "
                "quantization=%r quant_block=%s; ignoring conflicting "
                "request bucket_mb=%s quantization=%r quant_block=%s — "
                "set the collective_* flags / PartitionConfig fields "
                "before the first minimize/compile of this program",
                existing.bucket_mb, existing.quantization,
                existing.quant_block,
                "off" if off else mb, quant, qblock)
        else:
            pairs = (params_grads if params_grads is not None
                     else _grad_pairs_from_block(program.global_block()))
            planned = {n for b in existing.buckets for n in b["grads"]}
            uncovered = sorted({g.name for _, g in pairs
                                if g is not None
                                and g.name not in planned})
            if uncovered:
                _log.warning(
                    "collectives: program already planned; %d "
                    "gradient(s) added after the plan (%s%s) stay "
                    "un-bucketed/un-quantized (monolithic reduce). Plan "
                    "once, after the last minimize.",
                    len(uncovered), ", ".join(uncovered[:3]),
                    ", ..." if len(uncovered) > 3 else "")
        return existing
    if _SUPPRESSED or off:
        return None
    if getattr(program, "_pipeline_cuts", None):
        _log.info("collectives: program has pipeline cuts — the "
                  "pipeline schedule owns its gradient flow; not planned")
        return None
    if int(getattr(program, "_gradient_merge_k", 0) or 0) > 1:
        _log.info("collectives: program uses gradient merge — the "
                  "accumulator owns its gradient flow; not planned")
        return None

    block = program.global_block()
    if params_grads is None:
        pairs = _grad_pairs_from_block(block)
    else:
        pairs = [(p, g) for p, g in params_grads if g is not None]
    if not pairs:
        return None

    producer: Dict[str, int] = {}
    for i, op in enumerate(block.ops):
        for ns in op.outputs.values():
            for n in ns:
                producer[n] = i
    entries = []
    for p, g in pairs:
        idx = producer.get(g.name)
        if idx is None:
            continue  # declared, never produced (a frozen param)
        shape = g.shape if g.shape else p.shape
        nbytes = _numel(shape) * _itemsize(g.dtype)
        entries.append((idx, g.name, shape, g.dtype, nbytes))
    if not entries:
        return None
    entries.sort(key=lambda e: e[0])  # backward-production order

    cap = mb * (1 << 20)
    buckets: List[Dict[str, Any]] = []
    cur: Optional[Dict[str, Any]] = None
    for idx, gname, shape, dtype, nbytes in entries:
        if cur is None or (cur["bytes"] and cur["bytes"] + nbytes > cap):
            cur = {"grads": [], "reduced": [], "numels": [],
                   "itemsizes": [], "bytes": 0, "insert_after": -1}
            buckets.append(cur)
        cur["grads"].append(gname)
        cur["numels"].append(_numel(shape))
        cur["itemsizes"].append(_itemsize(dtype))
        cur["bytes"] += nbytes
        cur["insert_after"] = max(cur["insert_after"], idx)
        rname = gname + REDUCED_SUFFIX
        gv = block.var(gname)
        block.create_var(name=rname, shape=gv.shape, dtype=gv.dtype,
                         stop_gradient=True)
        cur["reduced"].append(rname)

    for b in sorted(buckets, key=lambda b: -b["insert_after"]):
        block.append_op(
            type=OP_TYPE,
            inputs={"X": list(b["grads"])},
            outputs={"Out": list(b["reduced"])},
            attrs={"op_role": OpRole.Backward,
                   "quantization": quant, "quant_block": qblock},
        )
        block.ops.insert(b["insert_after"] + 1, block.ops.pop())

    reduce_idx: Dict[str, int] = {}
    mapping: Dict[str, str] = {}
    for i, op in enumerate(block.ops):
        if op.type == OP_TYPE:
            for raw, red in zip(op.inputs["X"], op.outputs["Out"]):
                reduce_idx[raw] = i
                mapping[raw] = red
    for i, op in enumerate(block.ops):
        if op.type == OP_TYPE:
            continue
        for slot, names in op.inputs.items():
            if any(n in mapping and i > reduce_idx[n] for n in names):
                op.inputs[slot] = [
                    mapping[n] if (n in mapping and i > reduce_idx[n])
                    else n for n in names]

    plan = CollectivePlan(program, buckets, quant, qblock, mb)
    program._collective_plan = plan
    program._bump()
    _log.info(
        "collectives: planned %d bucket(s) over %d gradient(s) "
        "(cap %.1f MB, quantization=%s block=%d)",
        len(buckets), len(entries), mb, quant, qblock)
    return plan


# -- the export-taint check ---------------------------------------------------


_RNG_OPS: Optional[set] = None
_RNG_OPS_COUNT = -1  # registry size the cache was computed at


def _rng_op_types() -> set:
    """Op types whose lowering draws from its op generator: their
    outputs differ between ranks even from equal inputs (each rank of a
    data-parallel world mixes its index into the seeds). Found by
    reading each lowering's source for ``op_generator``; ops only ever
    register, so the registry's size dates the cache."""
    global _RNG_OPS, _RNG_OPS_COUNT
    import inspect

    from ..core.registry import _OP_REGISTRY

    if _RNG_OPS is None or _RNG_OPS_COUNT != len(_OP_REGISTRY):
        found = set()
        for t, d in list(_OP_REGISTRY.items()):
            try:
                if "op_generator" in inspect.getsource(d.lower):
                    found.add(t)
            except (OSError, TypeError):
                found.add(t)
        _RNG_OPS, _RNG_OPS_COUNT = found, len(_OP_REGISTRY)
    return _RNG_OPS


def export_taint(ops, split_inputs, fetch_names, dtypes) -> List[str]:
    """The integer fetches that depend on a rank's own batch (a name of
    ``split_inputs``) or on a random draw: their value differs between
    ranks, and no cross-replica correction exists for them.
    ``dtypes`` maps a name to its dtype string."""
    rng = _rng_op_types()
    tainted = set(split_inputs)
    for op in ops:
        reads = set(op.input_arg_names)
        if op.type in rng or reads & tainted:
            tainted |= set(op.output_arg_names)
    out = []
    for n in fetch_names:
        dt = str(dtypes.get(n, "float32"))
        if n in tainted and not (dt.startswith("float")
                                 or dt.startswith("bfloat")):
            out.append(n)
    return out
