"""Scope and Executor: run a Program's global block op by op, eagerly.

The port's counterpart of ``paddle_tpu/core/executor.py``: ``Scope``,
``global_scope``, ``scope_guard`` and ``Executor(place).run(program,
feed, fetch_list, scope)``. The reference lowers the whole block into
one jitted JAX function (``_lower_block``, :164-205); the port runs the
same ops in the same order over torch tensors on the executor's device,
which is what PyTorch does best without a compiler. Its fast path is
the reference's: ``Executor.bind`` resolves a ``BoundStep``
(``runtime/dispatch.py``) once per (program, version, feed signature,
fetch list, scope), ``Executor.run`` goes through it, and
``cache_stats()`` counts ``bound_hits`` / ``bound_misses``. A bound
Program step runs eagerly; the generation engine's fixed-shape steps
replay as CUDA graphs (``runtime/graphs.py``). There is no mesh and no
persistent cache of executables.

What an eager run needs that a compiled one gets from XLA, worked out
once per (program, version, feeds, fetches) in ``_Plan``:

  * dead outputs: XLA drops outputs nothing reads. The plan's ``live``
    set (read by an op, fetched, or persistable) lets a lowering skip an
    output slot nobody reads (``LoweringContext.wants``): the Softmax of
    softmax_with_cross_entropy, layer-norm Mean/Variance, XShape, Mask.
  * lifetimes: a value leaves the run's environment after its last
    reader, so activations and gradients do not pile up over a step.
  * the tape: forward ops with an automatic grad op later in the block
    run recorded (``registry.run_recorded``); everything else runs under
    ``torch.no_grad()``. The tape must be empty when the run ends:
    every record was consumed by its grad op before the optimizer ops
    update parameters in place.

Persistable outputs are written back to the scope. The error messages
for a missing feed and for running main before startup are the
reference's.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import framework
from .framework import Block, Program, Variable
from .places import CUDAPlace, Place
from .registry import get_op_def

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a Program dtype spec."""
    name = framework.convert_dtype(dtype)
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"dtype {name!r} has no torch tensor mapping in "
                         "paddle_tpu_torch") from None


def to_numpy(v) -> np.ndarray:
    """Host numpy copy of a tensor (bfloat16 widened to float32). A copy
    also for a CPU tensor, whose ``numpy()`` would share its memory: the
    fused optimizer ops update parameters in place, so a view fetched
    after one step would change with the next."""
    t = v.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy() if t.is_cuda else t.numpy().copy()


class Scope:
    """name -> tensor store for persistable variables (parameters,
    optimizer state), with a parent link (reference framework/scope.h).
    ``generation`` moves on every ``set_var`` / ``erase``: a bound step
    caches its state tensors and resolves them again only when it has
    moved (``runtime.dispatch.scope_chain_generation``)."""

    _uids = itertools.count(1)
    # one lock for every scope: a lost bump would leave a bound step on
    # stale state
    _gen_lock = threading.Lock()

    def __init__(self, parent: Optional["Scope"] = None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent
        self.uid = next(Scope._uids)
        self.generation = 0

    def _bump_generation(self):
        with Scope._gen_lock:
            self.generation += 1

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        return self.find_var(name) is not None

    def set_var(self, name: str, value):
        self.vars[name] = value
        self._bump_generation()

    def erase(self, name: str):
        self.vars.pop(name, None)
        self._bump_generation()

    def new_scope(self) -> "Scope":
        return Scope(parent=self)

    def local_var_names(self) -> List[str]:
        return list(self.vars)

    def get_numpy(self, name: str):
        v = self.find_var(name)
        return None if v is None else to_numpy(v)


_global_scope = Scope()
_scope_stack: List[Scope] = [_global_scope]


def global_scope() -> Scope:
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope: Scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


class _Plan:
    """What one (program version, feeds, fetches) run needs to know
    about its block, computed once."""

    def __init__(self, block: Block, feed_names: Sequence[str],
                 fetch_names: Sequence[str]):
        ops = [op for op in block.ops if op.type not in ("feed", "fetch")]
        self.ops = ops
        self.defs = [get_op_def(op.type) for op in ops]
        # the slots each op reads: its OpDef's declared input slots (an
        # automatic grad op declares only its cotangents)
        self.reads = [[(s, op.inputs[s]) for s in d.input_slots
                       if s in op.inputs] for op, d in zip(ops, self.defs)]

        def persistable(n):
            v = block._find_var_recursive(n)
            return v is not None and v.persistable

        produced = set(feed_names)
        self.state_names: List[str] = []
        self.written: List[str] = []
        last_read: Dict[str, int] = {}
        for i, (op, reads) in enumerate(zip(ops, self.reads)):
            for _, names in reads:
                for n in names:
                    last_read[n] = i
                    if n not in produced and n not in self.state_names:
                        self.state_names.append(n)
            for n in op.output_arg_names:
                produced.add(n)
                if persistable(n) and n not in self.written:
                    self.written.append(n)
        keep = set(fetch_names) | {n for n in produced if persistable(n)} \
            | set(self.state_names)
        self.live = set(last_read) | keep
        # values to drop from the environment after op i: those whose
        # last reader is i, and outputs of op i nobody reads later
        self.free_after: List[List[str]] = [[] for _ in ops]
        for n, i in last_read.items():
            if n not in keep:
                self.free_after[i].append(n)
        for i, op in enumerate(ops):
            for n in op.output_arg_names:
                if n not in keep and last_read.get(n, -1) <= i \
                        and n not in self.free_after[i]:
                    self.free_after[i].append(n)
        # forward ops to record: op_ident -> input slots their automatic
        # grad op wants gradients for
        self.record: Dict[int, set] = {}
        for op, d in zip(ops, self.defs):
            if d.auto_grad:
                want = {s[: -len("@GRAD")] for s, ns in op.outputs.items()
                        if s.endswith("@GRAD") and ns}
                self.record[int(op.attrs.get("op_ident", 0))] = want


class Executor:
    """Reference API: ``Executor(place).run(program, feed, fetch_list,
    scope)``. The place defaults to ``CUDAPlace(0)``, which raises when
    there is no GPU: the CPU runs only when the caller names
    ``CPUPlace()``."""

    # bound steps kept at once (the least recently used goes first)
    MAX_BOUND = 256

    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device()
        self._run_counter = 0
        self._lock = threading.Lock()
        self._plans: Dict[tuple, _Plan] = {}
        self._constants: Dict[int, Any] = {}
        self._bound: "collections.OrderedDict[tuple, Any]" = \
            collections.OrderedDict()
        self._stats = {"bound_hits": 0, "bound_misses": 0}

    def _next_step(self) -> int:
        """The next run's step number (seeds its ops' generators); safe
        from several threads."""
        with self._lock:
            self._run_counter += 1
            return self._run_counter

    def _plan(self, program: Program, feed_names, fetch_names) -> _Plan:
        block = program.global_block()
        key = (program.uid, program.version, len(block.ops),
               tuple(feed_names), tuple(fetch_names))
        plan = self._plans.get(key)
        if plan is None:
            plan = _Plan(block, feed_names, fetch_names)
            self._plans[key] = plan
        return plan

    @staticmethod
    def _feed_signature(feed: Dict[str, Any]) -> tuple:
        sig = []
        for n in sorted(feed):
            v = feed[n]
            if not isinstance(v, (torch.Tensor, np.ndarray)):
                v = np.asarray(v)
            sig.append((n, tuple(v.shape), str(v.dtype)))
        return tuple(sig)

    def bind(self, program: Program, feed: Dict[str, Any],
             fetch_list: Sequence, scope: Optional[Scope] = None,
             tag: Optional[str] = None):
        """The ``runtime.dispatch.BoundStep`` of this exact (program
        version, feed names with shapes and dtypes, fetch list, scope),
        resolved on the first call and cached (the reference's
        ``Executor.bind``, :764). ``feed`` gives example values: their
        shapes and dtypes bind, nothing runs. ``tag`` labels the step."""
        scope = scope or global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        block = program.global_block()
        key = (program.uid, program.version, len(block.ops),
               program.random_seed, self._feed_signature(feed),
               tuple(fetch_names), scope.uid)
        with self._lock:
            return self._bind_locked(program, feed, key, block, scope,
                                     fetch_names, tag)

    def _bind_locked(self, program, feed, key, block, scope, fetch_names,
                     tag):
        from ..runtime.dispatch import BoundStep

        bound = self._bound.get(key)
        if bound is not None:
            self._stats["bound_hits"] += 1
            self._bound.move_to_end(key)
        else:
            self._stats["bound_misses"] += 1
            feed_names = sorted(feed)
            bound = BoundStep(self, self._plan(program, feed_names,
                                               fetch_names),
                              block, scope, program.random_seed or 0,
                              feed_names, fetch_names)
            self._bound[key] = bound
            if len(self._bound) > self.MAX_BOUND:
                self._bound.popitem(last=False)
        if tag is not None:
            bound.tag = tag
        return bound

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence] = None,
        feed_var_name: str = "feed",
        fetch_var_name: str = "fetch",
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ):
        if program is None:
            program = framework.default_main_program()
        feed = dict(feed or {})
        bound = self.bind(program, feed, fetch_list, scope or global_scope())
        return bound.run(feed, return_numpy)

    def cache_stats(self) -> Dict[str, Any]:
        """The reference's counters for this executor: ``bound_hits`` /
        ``bound_misses`` of ``bind`` (every ``run`` binds), the bound
        steps held, and ``graph_captures`` / ``graph_replays``, which
        stay 0: a bound Program step runs eagerly (CUDA graphs over
        Program steps are ROADMAP A12b)."""
        out = dict(self._stats)
        out["bound_steps"] = len(self._bound)
        out["graph_captures"] = 0
        out["graph_replays"] = 0
        return out

    def close(self):
        self._plans.clear()
        self._constants.clear()
        self._bound.clear()
