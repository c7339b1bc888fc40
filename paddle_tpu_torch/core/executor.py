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
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import flags, profiler
from . import framework
from .framework import Block, Program, Variable
from .places import CUDAPlace, Place
from .registry import get_op_def
from .selected_rows import SelectedRows

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
    after one step would change with the next. A SelectedRows comes back
    as one of numpy arrays (``paddle_tpu/core/executor.py:466-472``)."""
    if isinstance(v, SelectedRows):
        return SelectedRows(to_numpy(v.rows), to_numpy(v.values), v.height)
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


# control-flow ops: op type -> (lowering ``fn(ctx, op, env)``, whether
# the sub-block's writes land in the caller's environment); registered
# by core/control_flow.py. They are not in the op registry, so
# append_backward refuses them, as the JAX package's does.
_CONTROL_FLOW: Dict[str, Any] = {}


def register_control_flow(op_type: str, carries: bool = True):
    """``carries``: the op writes what its sub-block writes of the names
    that exist before it (while, conditional_block); otherwise it writes
    only its own outputs (recompute_segment_grad)."""
    def deco(fn):
        _CONTROL_FLOW[op_type] = (fn, carries)
        return fn

    return deco


def _sub_blocks(op):
    return [v for v in op.attrs.values() if isinstance(v, Block)]


def block_reads(block: Block) -> List[str]:
    """Names the block's ops read (nested blocks too) before the block
    itself writes them: what it takes from the enclosing environment."""
    out, local = [], set()
    for op in block.ops:
        names = list(op.input_arg_names)
        for sub in _sub_blocks(op):
            names += block_reads(sub)
        for n in names:
            if n not in local and n not in out:
                out.append(n)
        local.update(op.output_arg_names)
    return out


def block_writes(block: Block) -> List[str]:
    """Names the block's ops write, nested carrying blocks included."""
    out = []
    for op in block.ops:
        names = list(op.output_arg_names)
        cf = _CONTROL_FLOW.get(op.type)
        if cf is not None and cf[1]:
            for sub in _sub_blocks(op):
                names += block_writes(sub)
        out += [n for n in names if n not in out]
    return out


def _all_reads(block: Block) -> set:
    """Every name any op of the block or of its sub-blocks reads."""
    out = set()
    for op in block.ops:
        out.update(op.input_arg_names)
        for sub in _sub_blocks(op):
            out |= _all_reads(sub)
    return out


def lower_ops(ops, env: Dict[str, Any], ctx) -> None:
    """Run ``ops`` (a sub-block's) eagerly over ``env``, updating it in
    place: the counterpart of the JAX package's ``_lower_block``. No
    tape and no lifetimes: a sub-block is short, and its caller keeps
    what it needs."""
    for op in ops:
        if op.type in ("feed", "fetch"):
            continue
        cf = _CONTROL_FLOW.get(op.type)
        if cf is not None:
            cf[0](ctx, op, env)
            continue
        opdef = get_op_def(op.type)
        ins = {}
        for slot in opdef.input_slots:
            if slot not in op.inputs:
                continue
            try:
                ins[slot] = [env[n] for n in op.inputs[slot]]
            except KeyError as e:
                raise KeyError(
                    f"op {op.type!r} input {slot}={e.args[0]!r} is not "
                    "defined; did you run the startup program / feed this "
                    "var?") from None
        outs = opdef.lower(ctx, op, ins)
        for slot, names in op.outputs.items():
            vals = outs.get(slot, [])
            for j, n in enumerate(names):
                if j < len(vals):
                    env[n] = vals[j]


class _Plan:
    """What one (program version, feeds, fetches) run needs to know
    about its block, computed once. ``ops`` runs a part of the block
    (a gradient-merge step's phases); ``keep`` names values that must
    outlive it. A control-flow op reads what its sub-block takes from
    outside (``block_reads``) and writes what it carries out
    (``block_writes``): a var only a sub-block reads stays live until
    its op has run, and a persistable the sub-block writes goes back to
    the scope."""

    def __init__(self, block: Block, feed_names: Sequence[str],
                 fetch_names: Sequence[str], ops=None, keep=()):
        if ops is None:
            ops = [op for op in block.ops if op.type not in ("feed", "fetch")]
        self.ops = ops
        self.control = [_CONTROL_FLOW.get(op.type) for op in ops]
        self.defs = [None if cf is not None else get_op_def(op.type)
                     for op, cf in zip(ops, self.control)]
        # the slots each op reads: its OpDef's declared input slots (an
        # automatic grad op declares only its cotangents); a control op
        # reads its inputs and its sub-block's outer reads as one slot
        self.retrace = self._retraced(ops)
        self.reads = []
        writes = []
        sub_reads = set()
        for i, (op, d, cf) in enumerate(zip(ops, self.defs, self.control)):
            if cf is None:
                slots = d.input_slots
                if i in self.retrace:
                    slots = slots + self.retrace[i][1].input_slots
                self.reads.append([(s, op.inputs[s]) for s in slots
                                   if s in op.inputs])
                writes.append(op.output_arg_names)
                continue
            names = list(op.input_arg_names)
            outs = list(op.output_arg_names)
            for sub in _sub_blocks(op):
                names += [n for n in block_reads(sub) if n not in names]
                sub_reads |= _all_reads(sub)
                if cf[1]:
                    outs += [n for n in block_writes(sub) if n not in outs]
            self.reads.append([("", names)])
            writes.append(outs)

        def persistable(n):
            v = block._find_var_recursive(n)
            return v is not None and v.persistable

        produced = set(feed_names)
        self.state_names: List[str] = []
        self.written: List[str] = []
        last_read: Dict[str, int] = {}
        for i, reads in enumerate(self.reads):
            for _, names in reads:
                for n in names:
                    last_read[n] = i
                    if n not in produced and n not in self.state_names:
                        self.state_names.append(n)
            for n in writes[i]:
                produced.add(n)
                if persistable(n) and n not in self.written:
                    self.written.append(n)
        keep = set(fetch_names) | set(keep) \
            | {n for n in produced if persistable(n)} | set(self.state_names)
        self.live = set(last_read) | keep | sub_reads
        # values to drop from the environment after op i: those whose
        # last reader is i, and outputs of op i nobody reads later
        self.free_after: List[List[str]] = [[] for _ in ops]
        for n, i in last_read.items():
            if n not in keep:
                self.free_after[i].append(n)
        for i in range(len(ops)):
            for n in writes[i]:
                if n not in keep and last_read.get(n, -1) <= i \
                        and n not in self.free_after[i]:
                    self.free_after[i].append(n)
        # forward ops to record: op_ident -> input slots their automatic
        # grad op wants gradients for
        self.record: Dict[int, set] = {}
        for i, (op, d) in enumerate(zip(ops, self.defs)):
            if d is not None and d.auto_grad and i not in self.retrace:
                want = {s[: -len("@GRAD")] for s, ns in op.outputs.items()
                        if s.endswith("@GRAD") and ns}
                self.record[int(op.attrs.get("op_ident", 0))] = want

    def _retraced(self, ops) -> Dict[int, tuple]:
        """Automatic grad ops whose forward op now reads other inputs
        than the grad op names: a pass that ran after
        ``append_backward`` (quantization-aware training) rewired the
        forward. The JAX package's grad op re-traces the forward on the
        inputs it names (``paddle_tpu/core/registry.py:209-271``), so
        its gradient is taken at the original values; here such a grad
        op reads those inputs and records the forward on them itself,
        just before it runs, and the forward op runs unrecorded.
        Returns {grad op index: (forward op, forward OpDef)}."""
        out, fwd = {}, {}
        for i, (op, d) in enumerate(zip(ops, self.defs)):
            if d is None:
                continue
            ident = int(op.attrs.get("op_ident", 0))
            if not d.auto_grad:
                fwd[ident] = (op, get_op_def(op.type))
                continue
            f = fwd.get(ident)
            if f is not None and any(
                    op.inputs.get(s) != f[0].inputs.get(s)
                    for s in f[1].input_slots
                    if s in op.inputs or s in f[0].inputs):
                out[i] = f
        return out


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
        # aggregated into paddle_executor_* by the metrics registry
        from ..observability import watch_executor

        watch_executor(self)

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
        version, feed names with shapes and dtypes, fetch list, scope,
        flag generation), resolved on the first call and cached (the
        reference's ``Executor.bind``, :764; a ``set_flags`` re-binds, as
        the reference's key on ``flags._generation`` does, :759).
        ``feed`` gives example values: their shapes and dtypes bind,
        nothing runs. ``tag`` labels the step and its compile event."""
        scope = scope or global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        block = program.global_block()
        key = (program.uid, program.version, len(block.ops),
               program.random_seed, self._feed_signature(feed),
               tuple(fetch_names), scope.uid, flags.generation())
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
            t0 = time.perf_counter()
            bound = BoundStep(self, self._plan(program, feed_names,
                                               fetch_names),
                              block, scope, program.random_seed or 0,
                              feed_names, fetch_names)
            profiler.record_compile(tag or f"program_{program.uid}",
                                    time.perf_counter() - t0)
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

    def run_pipelined(
        self,
        program: Optional[Program] = None,
        feeds: Optional[Any] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        depth: Optional[int] = None,
    ):
        """The overlapped step loop (the reference's :668-730): a
        generator yielding ``run``'s fetches for every feed dict of
        ``feeds`` (any iterable: a list, a generator, a
        ``GeneratorLoader``), bit-identical to ``run`` per feed, with the
        host side of step N+1 (normalizing, casting, the copy to the
        card) on a feeder thread while step N runs
        (``runtime.dispatch.BoundStep.run_pipelined``).

        A feed whose signature (shapes, dtypes) changes mid-stream drains
        the pipeline and re-binds: the stream stays correct and pays a
        bubble at each boundary. ``depth`` defaults to the
        ``dispatch_pipeline_depth`` flag (2 = double buffering)."""
        from ..runtime.dispatch import feed_signature

        if program is None:
            program = framework.default_main_program()
        scope = scope or global_scope()
        fetch_list = list(fetch_list) if fetch_list is not None else []
        it = iter(feeds if feeds is not None else ())
        end = object()
        pending = next(it, end)
        while pending is not end:
            bound = self.bind(program, pending, fetch_list, scope)
            seg_depth = (depth if depth is not None
                         else int(flags.flag("dispatch_pipeline_depth")))
            sig = feed_signature(pending)

            def segment():
                # consumed on the FEEDER thread; `pending` is read back
                # on the caller's thread only after the pipeline's end
                # sentinel, which the queue orders after this write
                nonlocal pending
                while pending is not end and feed_signature(pending) == sig:
                    f = pending
                    try:
                        pending = next(it, end)
                    except BaseException:
                        # the pull of the NEXT feed failed: the current
                        # good feed still reaches the step before the
                        # error surfaces, or an input error at feed K
                        # would cost step K-1 too
                        pending = end
                        yield f
                        raise
                    yield f

            yield from bound.run_pipelined(segment(),
                                           return_numpy=return_numpy,
                                           depth=seg_depth)

    # -- the dataset path (the reference's :1220-1238) ---------------------
    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """Train over a ``dataset.QueueDataset`` / ``InMemoryDataset``
        (``dataset_runner.run_from_dataset``): one step a batch, or
        ``thread`` > 1 Hogwild threads over one scope. Returns the last
        step's fetches."""
        from ..dataset_runner import run_from_dataset

        return run_from_dataset(self, program, dataset, scope, fetch_list,
                                fetch_info, print_period, train=True,
                                thread=thread)

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           **kw):
        from ..dataset_runner import run_from_dataset

        return run_from_dataset(self, program, dataset, scope,
                                kw.get("fetch_list"), kw.get("fetch_info"),
                                kw.get("print_period", 100), train=False)

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
