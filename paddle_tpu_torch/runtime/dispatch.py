"""The bound fast path over Programs: the port's counterpart of
``paddle_tpu/runtime/dispatch.py`` (``BoundStep``, :393).

``Executor.bind(program, feed, fetch_list, scope)`` resolves one
``BoundStep`` per (program uid, version, op count, random seed, feed
names with shapes and dtypes, fetch names, scope) and ``Executor.run``
funnels every call through it, as the reference does. A bound step
holds what the run would otherwise work out every call:

  * the ``_Plan`` of the block (live set, lifetimes, tape records);
  * the feed plan: each fed name with the torch dtype its variable
    declares (None for a name the block does not declare);
  * the resolved state tensors, read from the scope once and refreshed
    only when the scope chain's generation moves (``Scope.set_var`` /
    ``erase`` bump it). The step's own persistable writes update the
    cached refs in place and bump the generation once, so a training
    loop does not re-resolve each step while another program bound to
    the same scope (an eval clone) sees the new values.

The reference compiles the step into one XLA executable; here the bound
step runs its plan eagerly, op by op. Capturing a Program step as a
CUDA graph is ROADMAP A12b: each op's generator is seeded on the host
per step (``LoweringContext.op_generator``), so a capture would replay
one step's dropout masks, and the warm-up a capture needs would update
the parameters in place. The generation engine's fixed-shape steps are
graphed (``runtime/graphs.py``).

Bound steps are shared by the Predictor's clones (a serving worker
pool), so ``run`` may be entered from several threads at once: each run
keeps its values in its own environment, the step counter is drawn
under the executor's lock, and the cached state refs are replaced as a
whole.

``run_pipelined`` is the overlapped loop over a stream of feeds
(the reference's :620-746): a feeder thread normalizes feed N+1 and
copies it to the card on a side stream (``runtime/prefetch.py``) while
step N runs; the step itself is ``run``'s, on the resident tensors.

Also here, for the Predictor's shape bucketing: ``feed_signature`` and
``pad_to`` (the reference's :333, :352), and ``eval_shapes``, the
counterpart of ``jax.eval_shape`` over a block: the plan runs on
``meta`` tensors, which carry shapes and dtypes and compute nothing.
Inside it (``kernels._build.evaluating_shapes``) the kernel wrappers
take a meta tensor down their plain version; a CUDA tensor never goes
that way, and outside it a meta tensor raises.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..core.executor import _Plan, to_numpy, torch_dtype
from ..core.framework import Block, OpRole
from ..core.registry import LoweringContext, run_recorded
from ..flags import _flags
from ..kernels import _build
from ..observability import tracing
from ..observability.registry import overlap_telemetry
from .prefetch import DeviceStager, claim, host_tensor

__all__ = ["BoundStep", "scope_chain_generation", "feed_signature",
           "pad_to", "eval_shapes"]


def _dtype_name(dt) -> str:
    s = str(dt)
    return s[len("torch."):] if s.startswith("torch.") else s


def feed_signature(feed: Dict[str, Any]) -> tuple:
    """(name, shape, dtype name) per feed, sorted by name, from the
    values' metadata (tensors and numpy arrays give the same names);
    only a value with neither attribute (a list, a scalar) is converted
    with ``np.asarray``."""
    sig = []
    for n in sorted(feed):
        v = feed[n]
        shp = getattr(v, "shape", None)
        dt = getattr(v, "dtype", None)
        if shp is None or dt is None:
            v = np.asarray(v)
            shp, dt = v.shape, v.dtype
        sig.append((n, tuple(int(d) for d in shp), _dtype_name(dt)))
    return tuple(sig)


def pad_to(value, pads) -> Any:
    """Zero-pad one feed value by ``pads`` ((before, after) per dim): a
    tensor on its device (``F.pad``), anything else as numpy. No copy
    when nothing is padded."""
    if not any(p != (0, 0) for p in pads):
        return value
    if isinstance(value, torch.Tensor):
        flat = []
        for before, after in reversed(list(pads)):
            flat += [int(before), int(after)]
        return torch.nn.functional.pad(value, flat)
    return np.pad(np.asarray(value), pads)


def eval_shapes(program, feed: Dict[str, Any], fetch_names: Sequence[str],
                scope) -> List[tuple]:
    """The shape of each fetch when ``program`` runs on ``feed``,
    without computing anything: the block's plan runs on ``meta``
    tensors of the feeds' shapes (in the dtypes their variables
    declare) and of the scope's state."""
    block = program.global_block()
    feed_names = sorted(feed)
    plan = _Plan(block, feed_names, fetch_names)
    meta = torch.device("meta")
    env: Dict[str, Any] = {}
    for n in feed_names:
        v = feed[n]
        shp = getattr(v, "shape", None)
        if shp is None:
            v = np.asarray(v)
            shp = v.shape
        if block.has_var(n):
            dt = torch_dtype(block.var(n).dtype)
        elif isinstance(v, torch.Tensor):
            dt = v.dtype
        else:
            a = np.asarray(v)
            a = a.astype(np.float32) if a.dtype == np.float64 else a
            dt = torch.from_numpy(np.empty(0, a.dtype)).dtype
        env[n] = torch.empty(tuple(shp), dtype=dt, device=meta)
    for n in plan.state_names:
        v = scope.find_var(n)
        if v is None:
            raise RuntimeError(f"persistable var {n!r} not found in scope")
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.ascontiguousarray(v))
        env[n] = torch.empty(v.shape, dtype=v.dtype, device=meta)
    ctx = LoweringContext(meta, seed=0, step=0, live=plan.live, constants={})
    with torch.no_grad(), _build.evaluating_shapes():
        for i, (op, opdef) in enumerate(zip(plan.ops, plan.defs)):
            if opdef is None:
                plan.control[i][0](ctx, op, env)
                continue
            ins = {slot: [env[n] for n in names]
                   for slot, names in plan.reads[i]}
            outs = opdef.lower(ctx, op, ins)
            for slot, names in op.outputs.items():
                for j, n in enumerate(names):
                    vals = outs.get(slot, [])
                    if j < len(vals):
                        env[n] = vals[j]
    return [tuple(int(d) for d in env[n].shape) for n in fetch_names]


def scope_chain_generation(scope) -> int:
    """Sum of the generation counters along the parent chain: it moves
    when any scope a lookup could resolve through is mutated (the
    reference's :242)."""
    g = scope.generation
    s = scope.parent
    while s is not None:
        g += s.generation
        s = s.parent
    return g


class BoundStep:
    """One resolved (program, feed signature, fetch list, scope) step:
    ``run(feed, return_numpy)`` is the single execution path of
    ``Executor.run``."""

    __slots__ = ("executor", "plan", "block", "scope", "seed", "tag",
                 "feed_plan", "fetch_names", "state_vals", "state_pos",
                 "scope_gen", "merge", "__weakref__")

    def __init__(self, executor, plan: _Plan, block: Block, scope, seed: int,
                 feed_names: Sequence[str], fetch_names: Sequence[str],
                 tag: Optional[str] = None):
        self.executor = executor
        self.plan = plan
        self.block = block
        self.scope = scope
        self.seed = int(seed)
        self.tag = tag
        self.feed_plan = [
            (n, torch_dtype(block.var(n).dtype) if block.has_var(n) else None)
            for n in feed_names]
        self.fetch_names = list(fetch_names)
        self.state_vals: List[Any] = []
        # where each written persistable sits among the state values
        # (None: written only, read by no op of this step)
        pos = {n: i for i, n in enumerate(plan.state_names)}
        self.state_pos = [(n, pos.get(n)) for n in plan.written]
        self.scope_gen = -1      # resolve at the first run
        k = int(getattr(block.program, "_gradient_merge_k", 0) or 0)
        self.merge = (_MergePlan(plan, block, feed_names, self.fetch_names, k,
                                 bool(getattr(block.program,
                                              "_gradient_merge_avg", True)))
                      if k > 1 else None)

    # -- state resolution ---------------------------------------------------
    def _resolve_state(self):
        scope, block, device = self.scope, self.block, self.executor.device
        # read the generation BEFORE the walk: a set_var during it leaves
        # the counters unequal, and the next run resolves again
        gen = scope_chain_generation(scope)
        vals = []
        for n in self.plan.state_names:
            v = scope.find_var(n)
            if v is None:
                if block.has_var(n) and block.var(n).is_data:
                    raise RuntimeError(
                        f"data var {n!r} was not fed — add it to the feed "
                        "dict")
                raise RuntimeError(
                    f"persistable var {n!r} not found in scope — run the "
                    "startup program first")
            if not isinstance(v, torch.Tensor):
                # a host value set from outside (numpy, a list): onto the
                # device once, in the scope from now on
                v = torch.from_numpy(np.ascontiguousarray(v)).to(device)
                scope.vars[n] = v
            if v.device != device:
                raise RuntimeError(
                    f"scope var {n!r} lives on {v.device}, this executor "
                    f"runs on {device}")
            vals.append(v)
        self.state_vals = vals
        self.scope_gen = gen

    # -- the hot path -------------------------------------------------------
    def run(self, feed: Dict[str, Any], return_numpy: bool = True):
        """One step. A feed already on the executor's device in its
        variable's dtype (a ``GeneratorLoader`` batch) is used as it is,
        with no second copy."""
        t_obs = time.perf_counter()
        device = self.executor.device
        ordered = [host_tensor(feed[n], dt).to(device)
                   for n, dt in self.feed_plan]
        return self._run_ordered(ordered, return_numpy, _rows(feed), t_obs)

    def _run_ordered(self, ordered: List[torch.Tensor], return_numpy: bool,
                     rows: int, t_obs: float):
        scope, plan = self.scope, self.plan
        entry_gen = scope_chain_generation(scope)
        if entry_gen != self.scope_gen:
            self._resolve_state()
            entry_gen = self.scope_gen
        env: Dict[str, Any] = {n: t for (n, _), t in zip(self.feed_plan,
                                                         ordered)}
        env.update(zip(plan.state_names, self.state_vals))

        ex = self.executor
        step = ex._next_step()
        if self.merge is not None:
            env = self.merge.run(self, env, step)
        else:
            ctx = LoweringContext(ex.device, seed=self.seed, step=step,
                                  live=plan.live, constants=ex._constants)
            run_plan(plan, env, ctx)
        wrote = False
        sv = scope.vars
        for n, pos in self.state_pos:
            if n in env:
                v = env[n]
                sv[n] = v
                if pos is not None:
                    self.state_vals[pos] = v
                wrote = True
        if wrote:
            # written straight into the scope (no bump a name): one bump
            # so that other steps bound to this scope re-resolve; this
            # step keeps entry_gen + 1, ITS bump, so that a set_var from
            # elsewhere during the run still forces a re-resolve
            scope._bump_generation()
            self.scope_gen = entry_gen + 1
        fetched = []
        for n in self.fetch_names:
            if n not in env:
                raise KeyError(f"fetch var {n!r} was never produced")
            fetched.append(env[n])
        out = [to_numpy(v) for v in fetched] if return_numpy else fetched
        if _flags["observability_metrics"]:
            # the host-side step cadence (no device sync, as in the JAX
            # package's dispatch): the traffic estimator's step median
            record_step((time.perf_counter() - t_obs) * 1e3, rows, step)
        return out

    # -- the overlapped step ------------------------------------------------
    def run_pipelined(self, feeds: Iterable[Dict[str, Any]],
                      return_numpy: bool = True, depth: int = 2):
        """Yield ``run``'s fetches for each feed of ``feeds``, in order
        and bit-identical to ``run`` per feed (the reference's :620-746).

        A feeder thread (``pt-dispatch-feeder``) pulls feed N+1 from the
        iterable, normalizes it (``host_tensor``) and copies it to the
        card on a side stream (``prefetch.DeviceStager``) while step N
        runs, through a bounded queue of ``depth`` prepared feeds. The
        consumer (this generator, on the caller's thread) orders its
        stream after the copy (``prefetch.claim``) and runs the step on
        the resident tensors. A feed already on the device passes
        untouched.

        * ordering: results come back in feed order;
        * errors: an error raised by the iterable or by the normalizing
          of feed K surfaces here after step K-1's result; the feeder
          always exits;
        * shutdown: closing or abandoning the generator stops and joins
          the feeder and drops every prepared batch (no orphan thread,
          no staged batch left behind);
        * state: scope state flows through ``_run_ordered`` exactly as
          in ``run`` (the feeder touches feeds only).

        The overlap goes to ``paddle_step_overlap_*``: host feed ms per
        step, how much of it the consumer waited for, and the hidden
        fraction."""
        depth = max(1, int(depth))
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()
        end = object()
        overlap = (overlap_telemetry() if _flags["observability_metrics"]
                   else None)
        stager = DeviceStager(self.executor.device)
        plan = self.feed_plan

        def feeder():
            err = None
            try:
                it = iter(feeds)
                while True:
                    if stop.is_set():
                        return
                    # the timed span starts BEFORE next(): the iterable
                    # IS the input pipeline, and its latency is the host
                    # work the overlap hides
                    t0 = time.perf_counter()
                    try:
                        feed = next(it)
                    except StopIteration:
                        break
                    if stop.is_set():
                        # the consumer shut down while next() blocked:
                        # stage no more batches on the way out
                        return
                    with tracing.span("dispatch/feed"):
                        staged = stager.stage(
                            [host_tensor(feed[n], dt) for n, dt in plan])
                    item = ((staged, _rows(feed)),
                            (time.perf_counter() - t0) * 1e3)
                    while True:
                        if stop.is_set():
                            return
                        try:
                            q.put(item, timeout=0.05)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # noqa: BLE001 — raised at the yield
                err = e
            while not stop.is_set():
                try:
                    q.put((end, err), timeout=0.05)
                    return
                except queue.Full:
                    continue

        t = threading.Thread(target=feeder, name="pt-dispatch-feeder",
                             daemon=True)
        t.start()
        try:
            while True:
                try:
                    payload, extra = q.get_nowait()
                    waited_ms = 0.0
                except queue.Empty:
                    t0 = time.perf_counter()
                    payload, extra = q.get()
                    waited_ms = (time.perf_counter() - t0) * 1e3
                if payload is end:
                    if extra is not None:
                        raise extra
                    return
                (tensors, event), rows = payload
                with tracing.span("dispatch/step"):
                    t_obs = time.perf_counter()
                    fetched = self._run_ordered(claim(tensors, event),
                                                return_numpy, rows, t_obs)
                if overlap is not None:
                    overlap.record(extra, waited_ms)
                yield fetched
        finally:
            stop.set()
            # unblock a feeder parked in q.put, then reap it
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)


def _rows(feed: Dict[str, Any]) -> int:
    """dim 0 of the feed's first value: the examples a step counts."""
    first = next(iter(feed.values()), None)
    shape = getattr(first, "shape", None)
    return int(shape[0]) if shape else 0


def record_step(ms: float, rows: int, step: Optional[int] = None) -> None:
    """One bound step's wall time into the process-wide step telemetry
    (``paddle_step_*``)."""
    from ..observability.registry import step_telemetry

    step_telemetry().record(ms, rows, step=step)


def run_plan(plan: _Plan, env: Dict[str, Any], ctx: LoweringContext) -> None:
    """Run the plan's ops over ``env``, in place: forward ops with an
    automatic grad op recorded on the tape, control-flow ops through
    their lowering, each value dropped after its last reader. The tape
    must be empty at the end."""
    with torch.no_grad():
        for i, (op, opdef) in enumerate(zip(plan.ops, plan.defs)):
            if opdef is None:
                plan.control[i][0](ctx, op, env)
            else:
                ins = {}
                for slot, names in plan.reads[i]:
                    try:
                        ins[slot] = [env[n] for n in names]
                    except KeyError as e:
                        raise KeyError(
                            f"op {op.type!r} input {slot}={e.args[0]!r} is "
                            "not defined; did you run the startup program / "
                            "feed this var?") from None
                ident = int(op.attrs.get("op_ident", 0))
                if i in plan.retrace:
                    _record_retraced(ctx, op, ins, *plan.retrace[i])
                    outs = opdef.lower(ctx, op, ins)
                elif not opdef.auto_grad and ident in plan.record:
                    outs = run_recorded(ctx, opdef, op, ins,
                                        plan.record[ident])
                else:
                    outs = opdef.lower(ctx, op, ins)
                for slot, names in op.outputs.items():
                    vals = outs.get(slot, [])
                    for j, n in enumerate(names):
                        if j < len(vals):
                            env[n] = vals[j]
            for n in plan.free_after[i]:
                env.pop(n, None)
    if ctx.tape:
        raise RuntimeError(
            f"{len(ctx.tape)} forward record(s) were never consumed by "
            f"a grad op (op_idents {sorted(ctx.tape)})")


class _Retraced:
    """The forward op as its grad op names its inputs."""

    def __init__(self, fwd, grad):
        self.type = fwd.type
        self.attrs = fwd.attrs
        self.outputs = fwd.outputs
        self.inputs = {s: grad.inputs[s] for s in fwd.inputs
                       if s in grad.inputs}


def _record_retraced(ctx, grad, ins, fwd, fwd_def) -> None:
    """Record ``fwd`` on the inputs its grad op names (``_Plan.
    _retraced``), for the grad op to consume at once."""
    want = {s[: -len("@GRAD")] for s, ns in grad.outputs.items()
            if s.endswith("@GRAD") and ns}
    fins = {s: ins[s] for s in fwd_def.input_slots if s in ins}
    run_recorded(ctx, fwd_def, _Retraced(fwd, grad), fins, want)


def _is_opt(op) -> bool:
    return bool(int(op.attrs.get("op_role", 0))
                & (OpRole.Optimize | OpRole.LRSched))


class _MergePlan:
    """A ``GradientMergeOptimizer`` step (the JAX package's
    ``_build_gradient_merge_fn``, ``core/executor.py:307-400``): each
    feed splits into k microbatches along dim 0; the forward and
    backward ops run once a microbatch, in order, each microbatch with
    its own generators (``LoweringContext.fold``), the persistables they
    write threaded from one microbatch to the next; the values the
    optimizer ops read (and the fetches they produce) accumulate as
    ``acc + a`` in microbatch order and are divided by k with ``avg``;
    then the optimizer and learning-rate ops run once."""

    def __init__(self, plan: _Plan, block: Block, feed_names, fetch_names,
                 k: int, avg: bool):
        self.k, self.avg = k, avg
        self.feed_names = list(feed_names)
        body = [op for op in plan.ops if not _is_opt(op)]
        opt = [op for op in plan.ops if _is_opt(op)]
        produced = {n for op in body for n in op.output_arg_names}
        opt_needed = {n for op in opt for n in op.input_arg_names
                      if n in produced}
        self.acc_names = sorted(opt_needed | (set(fetch_names) & produced))
        self.body_written = [n for n in plan.written if n in produced]
        self.body = _Plan(block, feed_names, (), ops=body,
                          keep=self.acc_names + self.body_written)
        self.opt = _Plan(block, list(feed_names) + self.acc_names,
                         fetch_names, ops=opt)

    def run(self, bound: "BoundStep", env: Dict[str, Any], step: int):
        k, ex = self.k, bound.executor
        feeds = {}
        for n in self.feed_names:
            v = env[n]
            if v.shape[0] % k:
                raise ValueError(f"gradient merge k={k} does not divide batch "
                                 f"{v.shape[0]} of feed {n!r}")
            feeds[n] = v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))
        base = {n: v for n, v in env.items() if n not in feeds}
        written: Dict[str, Any] = {}
        acc: Optional[Dict[str, Any]] = None
        for i in range(k):
            mb = dict(base)
            mb.update(written)
            mb.update({n: v[i] for n, v in feeds.items()})
            run_plan(self.body, mb, LoweringContext(
                ex.device, seed=bound.seed, step=step, live=self.body.live,
                constants=ex._constants, fold=i))
            written = {n: mb[n] for n in self.body_written if n in mb}
            if acc is None:
                acc = {n: mb[n] for n in self.acc_names}
            else:
                # one name at a time: a merged set of gradients is as large
                # as the model, so no second copy of the whole set lives
                for n in self.acc_names:
                    acc[n] = acc[n] + mb[n]
            del mb
        if self.avg:
            for n, v in acc.items():
                acc[n] = v / torch.tensor(k, dtype=v.dtype, device=v.device)
        out = dict(base)       # the optimizer ops see no feed, as in JAX
        out.update(written)
        out.update(acc)
        run_plan(self.opt, out, LoweringContext(
            ex.device, seed=bound.seed, step=step, live=self.opt.live,
            constants=ex._constants, fold=k))
        return out
