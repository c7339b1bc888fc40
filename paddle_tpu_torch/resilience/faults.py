"""Deterministic fault injection for the training supervisor (the
port's copy of ``paddle_tpu/resilience/faults.py``: the same spec
grammar, rank scoping and exit code).

The whole fault lifecycle — retry, rollback, watchdog, kill/auto-resume
— is only trustworthy if it can be exercised on demand, so faults are a
first-class, flag-gated input: ``FLAGS_resilience_fault_spec`` (or the
``fault_injector`` Supervisor argument) names exactly which step each
fault fires at, and every fault is ONE-SHOT — after the supervisor
recovers (retry or rollback) the re-run of the same step proceeds
clean, which is what makes the recovered loss trajectory comparable
bitwise against an uninterrupted run.

Spec grammar (comma-separated, ``[rR:]kind@step`` with an optional
``:arg``)::

    raise@12            step 12 raises InjectedFault before running
    nan@20              step 20's fetched loss is replaced with NaN
    hang@30:2.5         step 30 sleeps 2.5s before running (watchdog bait)
    kill@40             step 40 hard-kills the process (os._exit) —
                        simulates preemption without a signal
    killsave@8          the checkpoint save following step 8 dies AFTER
                        this rank's shards are written but BEFORE its
                        shard-done file — the torn-commit scenario the
                        two-phase cross-host protocol must absorb
    r2:kill@40          rank-scoped: fires only on the process whose
                        PADDLE_TRAINER_ID is 2 — "kill exactly one
                        host of N", the dominant real failure mode
                        (entries without a rank prefix fire everywhere)
"""

from __future__ import annotations

import os
import re
import time
from typing import Any, List, Optional, Tuple

import numpy as np

__all__ = ["FaultSpec", "FaultInjector", "InjectedFault", "KILL_EXIT_CODE",
           "check_save_kill"]

# distinctive exit status so a test or a launcher can tell an injected kill
# from a genuine crash of the child process
KILL_EXIT_CODE = 43

_KINDS = ("raise", "nan", "hang", "kill", "killsave")

_RANK_RE = re.compile(r"^r(\d+):(.+)$")


class InjectedFault(RuntimeError):
    """The transient step failure raised by a ``raise@N`` fault."""


class FaultSpec:
    """Parsed fault plan: a list of (kind, step, arg, rank) actions
    (rank None = every rank)."""

    def __init__(self, actions: List[Tuple]):
        norm = []
        for act in actions:
            kind, step, arg = act[0], act[1], act[2]
            rank = act[3] if len(act) > 3 else None
            if kind not in _KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} (expected one of {_KINDS})")
            if step < 0:
                raise ValueError(f"fault step must be >= 0, got {step}")
            if rank is not None and rank < 0:
                raise ValueError(f"fault rank must be >= 0, got {rank}")
            norm.append((kind, step, arg, rank))
        self.actions = norm

    @classmethod
    def parse(cls, spec: str) -> "FaultSpec":
        """Parse ``"raise@12,nan@20,hang@30:2.5,r1:kill@40"``."""
        actions: List[Tuple[str, int, Optional[float], Optional[int]]] = []
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            rank: Optional[int] = None
            m = _RANK_RE.match(part)
            if m:
                rank, part = int(m.group(1)), m.group(2)
            try:
                kind, rest = part.split("@", 1)
                arg: Optional[float] = None
                if ":" in rest:
                    rest, arg_s = rest.split(":", 1)
                    arg = float(arg_s)
                actions.append((kind.strip(), int(rest), arg, rank))
            except ValueError as e:
                raise ValueError(
                    f"bad fault spec entry {part!r} (grammar: [rN:]kind@step"
                    f"[:arg], kinds {_KINDS}): {e}"
                ) from None
        return cls(actions)

    def __bool__(self):
        return bool(self.actions)


# one-shot flag set by an armed ``killsave`` fault and consumed by the
# checkpoint writer (io.py) at its pre-done-file injection point — this
# is how "a host dies mid-save, after its data but before its
# done-file" is simulated deterministically
_SAVE_KILL_ARMED = {"on": False}


def check_save_kill(point: str = "before_shard_done") -> None:
    """Called by the checkpoint writer at its injection points; a
    pending ``killsave`` fault hard-kills the process here (after the
    shard data landed, before the done-file), leaving a torn save the
    two-phase commit must never publish."""
    if _SAVE_KILL_ARMED["on"] and point == "before_shard_done":
        _SAVE_KILL_ARMED["on"] = False
        os._exit(KILL_EXIT_CODE)


class FaultInjector:
    """Applies a FaultSpec around each supervised step, one shot per
    action. ``before_step`` runs where the step would (raise / hang /
    kill, and arms a pending killsave); ``after_step`` poisons the
    fetched loss (nan). Rank-scoped entries (``rN:``) only fire on the
    process whose rank (``PADDLE_TRAINER_ID``, or the ``rank=``
    argument) matches — on every other rank they are dropped at
    construction and never reported by ``fired()``."""

    def __init__(self, spec: Optional[FaultSpec] = None,
                 rank: Optional[int] = None):
        if isinstance(spec, str):
            spec = FaultSpec.parse(spec)
        self.rank = int(os.environ.get("PADDLE_TRAINER_ID", "0")
                        if rank is None else rank)
        self.spec = spec or FaultSpec([])
        # rank filter applied once: foreign-rank entries are not "ours"
        self.spec = FaultSpec([
            a for a in self.spec.actions
            if a[3] is None or a[3] == self.rank
        ])
        self._fired: List[Tuple[str, int]] = []

    @classmethod
    def from_flags(cls) -> "FaultInjector":
        from ..flags import flag

        return cls(FaultSpec.parse(flag("resilience_fault_spec")))

    _NOT_PENDING = object()

    def _take(self, kind: str, step: int):
        """Pop the pending action (kind, step) and return its arg
        (None when the spec gave no ``:arg``) — one-shot. Returns the
        ``_NOT_PENDING`` sentinel when no such action is pending, so an
        explicit ``:0`` arg stays distinguishable from "absent"."""
        for i, (k, s, arg, _rank) in enumerate(self.spec.actions):
            if k == kind and s == step:
                del self.spec.actions[i]
                self._fired.append((kind, step))
                return arg
        return self._NOT_PENDING

    def fired(self) -> List[Tuple[str, int]]:
        return list(self._fired)

    def before_step(self, step: int) -> None:
        arg = self._take("hang", step)
        if arg is not self._NOT_PENDING:
            # bare `hang@N` = hang "forever" (an hour dwarfs any
            # sane watchdog timeout); `hang@N:x` sleeps exactly x
            time.sleep(3600.0 if arg is None else arg)
        if self._take("kill", step) is not self._NOT_PENDING:
            # hard preemption: no cleanup, no atexit, no signal handler
            # — exactly what a spot-VM reclaim looks like to the child
            os._exit(KILL_EXIT_CODE)
        if self._take("killsave", step) is not self._NOT_PENDING:
            _SAVE_KILL_ARMED["on"] = True
        if self._take("raise", step) is not self._NOT_PENDING:
            raise InjectedFault(f"injected transient fault at step {step}")

    def after_step(self, step: int, fetched: List[Any], loss_index: int):
        if not fetched or loss_index >= len(fetched):
            # nothing to poison: leave the action PENDING (and
            # unreported by fired()) rather than consuming it silently
            # — a chaos run with an empty fetch_list should not claim
            # the NaN path was exercised
            return fetched
        if self._take("nan", step) is not self._NOT_PENDING:
            bad = np.asarray(fetched[loss_index], dtype=np.float32).copy()
            bad.fill(np.nan)
            fetched = list(fetched)
            fetched[loss_index] = bad
        return fetched
