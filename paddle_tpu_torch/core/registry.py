"""Op registry: op type -> torch lowering (+ slot metadata + grad policy).

The port's counterpart of ``paddle_tpu/core/registry.py``
(``register_op``, ``OpDef``, ``get_op_def``, ``LoweringContext``,
:41-141). An op is one Python lowering ``fn(ctx, op, ins)`` that takes
``{slot: [tensor]}`` and returns ``{slot: [tensor]}``; the Executor
(``core/executor.py``) calls them one op at a time, eagerly.

Gradients come in two flavors, as in the reference:

  * explicit: a registered ``<type>_grad`` lowering (``lookup_table_grad``);
  * automatic: the default. The reference's grad op re-traces the
    forward under ``jax.vjp`` (``_make_auto_grad``, :209-271) and XLA
    removes the duplicate forward. Eagerly that would run the forward
    twice and hold its memory twice, so the port records instead: when
    a forward op has an automatic grad op in the block, the Executor
    runs its lowering under ``torch.enable_grad()`` on detached leaf
    inputs and keeps (leaves, outputs) on a per-run tape keyed by the
    op's ``op_ident`` (``run_recorded``). The grad op (which copies the
    forward's ident) pops that entry and calls ``torch.autograd.grad``
    with the incoming cotangents; an output without one contributes
    nothing, as the reference's zero cotangent does (:248-253).

Random numbers: ``LoweringContext.op_generator`` is a ``torch.Generator``
on the executor's device seeded from (run seed, step, ``op_ident``), the
counterpart of ``op_key`` (:61-70), so two builds of one program draw
the same init. A grad op never draws: the tape holds what its forward
drew (a dropout mask); a recompute segment's rerun draws again under the
same idents, so it draws the same masks. A gradient-merge step gives
each microbatch its own ``fold`` (JAX folds the index into the key).
"""

from __future__ import annotations

import difflib
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

_MASK64 = (1 << 64) - 1


def _mix(*vals: int) -> int:
    """splitmix64 over the values: a 63-bit seed."""
    h = 0x9E3779B97F4A7C15
    for v in vals:
        h = (h ^ (int(v) & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h & ((1 << 63) - 1)


class LoweringContext:
    """Carried through one Executor run.

    ``device``: where the run's tensors live. ``seed``/``step``: the
    program's ``random_seed`` and the executor's run counter, from
    which each op's generator derives. ``live``: var names some op
    reads, the run fetches or the scope keeps — a lowering may skip an
    output slot none of whose names is live (``wants``); None means all
    are live. ``tape``: the forward records of this run, by op_ident.
    ``constants``: a cache the Executor keeps across runs for values
    built from op attrs (``constant``). ``fold``: the microbatch of a
    gradient-merge step (None outside one). ``dist``: the bound step's
    ``runtime.dist_step.DistStep`` in a data- or expert-parallel step
    (None otherwise); ``pending``: reductions started and not yet
    waited on, by name; ``salt``: the rank's data shard, mixed into
    every op's seed so that shards draw their own dropout masks (None
    with one shard)."""

    def __init__(self, device, seed: int = 0, step: int = 0,
                 live: Optional[set] = None,
                 constants: Optional[Dict[int, Any]] = None,
                 fold: Optional[int] = None, dist=None):
        self.device = torch.device(device)
        self.seed = int(seed)
        self.step = int(step)
        self.fold = fold
        self.live = live
        self.tape: Dict[int, Any] = {}
        self.constants = constants if constants is not None else {}
        self.dist = dist
        self.pending: Dict[str, Any] = {}
        self.salt = dist.salt if dist is not None else None

    def op_generator(self, op) -> Optional[torch.Generator]:
        """A fresh generator for this op in this run, seeded from (run
        seed, step, op_ident). Grad ops reuse the forward's ident. None
        on the ``meta`` device (shape inference draws nothing)."""
        if self.device.type == "meta":
            return None
        ident = int(op.attrs.get("op_ident", 0) or 0)
        gen = torch.Generator(device=self.device)
        vals = [self.seed, self.step, ident]
        if self.fold is not None:
            vals.append(self.fold)
        if self.salt is not None:
            vals += [-1, self.salt]
        gen.manual_seed(_mix(*vals))
        return gen

    def wants(self, op, slot: str) -> bool:
        """Whether anything reads output ``slot`` of ``op``."""
        if self.live is None:
            return True
        return any(n in self.live for n in op.outputs.get(slot, ()))

    def constant(self, op, build: Callable[[], torch.Tensor]) -> torch.Tensor:
        """``build()`` once per op object on this device, then reused:
        for outputs that depend on attrs alone (``assign_value``)."""
        hit = self.constants.get(id(op))
        if hit is None or hit[0] is not op:
            hit = (op, build())
            self.constants[id(op)] = hit
        return hit[1]


class OpDef:
    """Metadata + lowering for one op type.

    input_slots/output_slots: ordered slot names. The Executor hands a
    lowering exactly the declared input slots the op carries.
    no_grad_slots: input slots that never receive gradients (integer
    labels, ids). ``auto_grad``: made by ``_make_auto_grad`` (reads
    only the cotangent slots; the rest comes from the tape)."""

    def __init__(
        self,
        type: str,
        lower: Callable,
        input_slots: Sequence[str] = ("X",),
        output_slots: Sequence[str] = ("Out",),
        no_grad_slots: Sequence[str] = (),
        stop_gradient: bool = False,
        auto_grad: bool = False,
    ):
        self.type = type
        self.lower = lower
        self.input_slots = tuple(input_slots)
        self.output_slots = tuple(output_slots)
        self.no_grad_slots = tuple(no_grad_slots)
        self.stop_gradient = stop_gradient
        self.auto_grad = auto_grad


_OP_REGISTRY: Dict[str, OpDef] = {}


def register_op(
    type: str,
    inputs: Sequence[str] = ("X",),
    outputs: Sequence[str] = ("Out",),
    no_grad: Sequence[str] = (),
    stop_gradient: bool = False,
):
    """Decorator. The lowering signature is ``fn(ctx, op, ins)`` where
    ``ins`` maps slot -> list of tensors (parallel to op.inputs), and
    returns slot -> list of tensors for op.outputs."""

    def deco(fn):
        _OP_REGISTRY[type] = OpDef(type, fn, input_slots=inputs,
                                   output_slots=outputs,
                                   no_grad_slots=no_grad,
                                   stop_gradient=stop_gradient)
        return fn

    return deco


def get_op_def(type: str) -> OpDef:
    if type in _OP_REGISTRY:
        return _OP_REGISTRY[type]
    if type.endswith("_grad"):
        fwd = _OP_REGISTRY.get(type[: -len("_grad")])
        if fwd is not None:
            gd = _make_auto_grad(fwd)
            _OP_REGISTRY[type] = gd
            return gd
    base = type[: -len("_grad")] if type.endswith("_grad") else type
    near = difflib.get_close_matches(base, sorted(_OP_REGISTRY), n=3,
                                     cutoff=0.6)
    hint = (f" (did you mean {' / '.join(repr(n) for n in near)}?)"
            if near else "")
    raise NotImplementedError(
        f"op type {type!r} has no registered lowering in paddle_tpu_torch"
        f"{hint}")


def has_op(type: str) -> bool:
    if type in _OP_REGISTRY:
        return True
    return type.endswith("_grad") and type[: -len("_grad")] in _OP_REGISTRY


# --------------------------------------------------------------------------
# automatic gradients from the run's tape
# --------------------------------------------------------------------------


def run_recorded(ctx: LoweringContext, opdef: OpDef, op,
                 ins: Dict[str, List[Any]], want_slots) -> Dict[str, List]:
    """Run a forward op whose automatic grad op comes later in the
    block: inputs of ``want_slots`` become fresh leaves (floating
    tensors only), the lowering runs with autograd on, and (leaves,
    outputs) go on ``ctx.tape`` under the op's ident. Returns the
    outputs detached, for the run's environment."""
    leaves: Dict[str, List[Any]] = {}
    rins: Dict[str, List[Any]] = {}
    for slot, vals in ins.items():
        if slot in want_slots and slot not in opdef.no_grad_slots:
            vals = [v.detach().requires_grad_(v.is_floating_point())
                    for v in vals]
            leaves[slot] = vals
        rins[slot] = vals
    with torch.enable_grad():
        outs = opdef.lower(ctx, op, rins)
    ident = int(op.attrs["op_ident"])
    if ident in ctx.tape:
        raise RuntimeError(f"op {op.type!r} (op_ident {ident}) recorded "
                           "twice in one run")
    ctx.tape[ident] = (leaves, outs)
    return {s: [v.detach() if isinstance(v, torch.Tensor) else v
                for v in vals] for s, vals in outs.items()}


def _make_auto_grad(fwd: OpDef) -> OpDef:
    grad_type = fwd.type + "_grad"

    def lower(ctx: LoweringContext, op, ins: Dict[str, List[Any]]):
        ident = int(op.attrs.get("op_ident", 0))
        entry = ctx.tape.pop(ident, None)
        if entry is None:
            raise RuntimeError(
                f"{grad_type}: the forward op (op_ident {ident}) left no "
                "record on this run's tape")
        leaves, outs = entry
        # which input slots need grads = the grad op's declared outputs
        want = [s[: -len("@GRAD")] for s in op.outputs
                if s.endswith("@GRAD") and op.outputs[s]]
        heads, cots = [], []
        for s in fwd.output_slots:
            gs = ins.get(s + "@GRAD", [])
            for i, o in enumerate(outs.get(s, [])):
                if (i < len(gs) and gs[i] is not None
                        and isinstance(o, torch.Tensor) and o.requires_grad):
                    heads.append(o)
                    cots.append(gs[i].to(o.dtype).reshape(o.shape))
        targets = [(slot, k, t) for slot in want
                   for k, t in enumerate(leaves.get(slot, []))
                   if t.requires_grad]
        grads = [None] * len(targets)
        if heads and targets:
            grads = torch.autograd.grad(heads, [t for _, _, t in targets],
                                        cots, allow_unused=True)
        got = {(slot, k): g for (slot, k, _), g in zip(targets, grads)}
        out = {}
        for slot in want:
            vals = leaves.get(slot) or ins.get(slot, [])
            out[slot + "@GRAD"] = [
                got.get((slot, k)) if got.get((slot, k)) is not None
                else torch.zeros_like(v.detach())
                for k, v in enumerate(vals)]
        return out

    return OpDef(
        grad_type,
        lower,
        input_slots=tuple(s + "@GRAD" for s in fwd.output_slots),
        output_slots=tuple(s + "@GRAD" for s in fwd.input_slots),
        auto_grad=True,
    )
