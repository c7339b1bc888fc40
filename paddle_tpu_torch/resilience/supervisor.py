"""Fault-tolerant training supervisor: owns the step loop's whole
fault lifecycle (the port's copy of
``paddle_tpu/resilience/supervisor.py``).

``Supervisor.run_loop`` wraps ``Executor.run`` with, in order of
escalation:

* **auto-resume** — on start, the latest COMMITTED checkpoint under
  ``checkpoint_dir`` is loaded (uncommitted/truncated dirs are never
  selected — io.latest_checkpoint's commit-marker contract) and the
  loop continues from its step. Resume is BIT-EXACT: the commit marker
  carries the step counter, the Executor's run counter (the step
  every op's ``torch.Generator`` is seeded from — dropout/random ops
  replay identically) and the reader position, so the recovered loss trajectory matches an
  uninterrupted run bitwise;
* **bounded retry** — a step that raises is retried with exponential
  backoff, up to ``max_retries`` times;
* **NaN/Inf loss guard** — a non-finite loss rolls the scope back to
  the last committed checkpoint (restoring the run counter too, so the
  replay stays bit-exact) and fires the ``on_nan`` hook — the place to
  drop the loss scale or LR — at most ``max_rollbacks`` times;
* **hang watchdog** — with ``watchdog_timeout_s`` > 0 each step runs
  on a persistent worker thread, on the caller's CUDA device and
  stream; a step that exceeds the timeout
  raises ``WatchdogTimeout`` in the supervisor (feeding the retry
  path) and the stuck worker is abandoned. A python thread cannot be
  killed, so if the abandoned step later UNWEDGES and completes, it
  mutates the scope behind the retry's back — the supervisor detects
  this (``stats()["zombie_steps"]``) and rolls back to the last
  commit, discarding the corruption. (Residual risk: a zombie
  completing exactly during a checkpoint save can tear that one
  commit; the manifest check rejects torn directories only when files
  are missing/resized, not same-size rewrites.);
* **preemption handling** — SIGTERM sets a flag; at the next step
  boundary a final checkpoint is flushed and the loop exits cleanly
  (``stats()["preempted"]``), so a preempted run resumes exactly where
  it stopped.

Feeds come from either ``feed_fn(step) -> dict`` (preferred: any step
is re-derivable, rollback replays for free) or a ``data`` iterable —
a ``GeneratorLoader`` is fast-forwarded on resume via its resumable
position, and feeds consumed since the last checkpoint are buffered so
rollback can replay them.

Checkpoint save/restore paths are wrapped in structured
``observability.tracing`` spans (``resilience/checkpoint`` etc. —
plain ``torch.profiler.record_function`` ranges when tracing is off),
so they show up in profiler traces. Every fault-lifecycle event (retry, rollback, NaN, watchdog,
zombie) also lands in the crash-time flight recorder, and the recorder
dumps a JSON snapshot on NaN rollback, watchdog hang, any exception
that escapes the loop, and the SIGTERM preemption flush
(``stats()["flight_dumps"]`` lists the paths).

The counters export through the metrics registry
(``watch_supervisor``: ``paddle_resilience_*{sup=}``). A
``reader.GeneratorLoader`` as ``data`` resumes through its
``set_resume_position`` (the marker's ``reader_position``: the step
count, never the loader's prefetched position); a plain iterable is
fast-forwarded by consuming it. The pre-save barrier of a distributed
world is ROADMAP A10.
"""

from __future__ import annotations

import os
import queue
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..observability import flight, tracing
from .checkpoint import CheckpointPolicy
from .faults import FaultInjector

__all__ = ["Supervisor", "WatchdogTimeout", "NonFiniteLossError"]

# the exit code an elastic launcher reads as "re-form the world and
# auto-resume" (paddle_tpu/distributed/coordinator.py:70)
RESTART_EXIT_CODE = 75


class WatchdogTimeout(RuntimeError):
    """A supervised step exceeded the watchdog timeout."""


class NonFiniteLossError(RuntimeError):
    """The NaN/Inf loss guard tripped and no recovery was possible."""


class _StepWorker:
    """Persistent worker thread the watchdog path runs steps on (a
    thread per step would cost ~100us/step; two queue hops cost ~10us).
    On timeout the worker is abandoned — its in-flight result is
    discarded via the cancellation token — and the next step gets a
    fresh worker."""

    def __init__(self):
        self._req: "queue.Queue" = queue.Queue(1)
        self._resp: "queue.Queue" = queue.Queue(1)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            fn, token = self._req.get()
            if fn is None:
                return
            try:
                out = ("ok", fn(token))
            except BaseException as e:  # noqa: BLE001 — marshalled to caller
                out = ("err", e)
            finally:
                # visible to the supervisor even after abandonment: an
                # orphaned step that eventually COMPLETED has mutated
                # the scope behind the retry's back (zombie detection)
                token["finished"] = True
            if not token["cancelled"]:
                self._resp.put(out)

    def call(self, fn, timeout: float):
        token = {"cancelled": False, "finished": False, "ran": False}
        self._req.put((fn, token))
        try:
            kind, val = self._resp.get(timeout=timeout)
        except queue.Empty:
            token["cancelled"] = True
            err = WatchdogTimeout(
                f"step exceeded watchdog timeout of {timeout}s; worker "
                "thread abandoned")
            err.token = token
            raise err from None
        if kind == "err":
            raise val
        return val

    def stop(self):
        try:
            self._req.put_nowait((None, {"cancelled": True}))
        except queue.Full:
            pass  # worker is wedged mid-step; it is a daemon thread


class Supervisor:
    """Wraps an Executor's step loop with the full fault lifecycle.

    Minimal usage::

        sup = resilience.Supervisor(
            exe, train_prog, checkpoint_dir="ckpts/run0",
            feed_fn=lambda step: feeds[step % len(feeds)],
            fetch_list=[loss])
        stats = sup.run_loop(num_steps=1000)

    ``program`` may be a Program or CompiledProgram (checkpointing uses
    the underlying main Program's persistables either way). The first
    entry of ``fetch_list`` is the loss the NaN/Inf guard watches
    (``loss_index`` overrides).
    """

    def __init__(self, exe, program, checkpoint_dir: str,
                 feed_fn: Optional[Callable[[int], Dict[str, Any]]] = None,
                 data=None, fetch_list=None, loss_index: int = 0,
                 scope=None, policy: Optional[CheckpointPolicy] = None,
                 max_retries: Optional[int] = None,
                 retry_backoff_s: Optional[float] = None,
                 max_rollbacks: Optional[int] = None,
                 watchdog_timeout_s: Optional[float] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 on_step: Optional[Callable[[int, List[Any]], None]] = None,
                 on_nan: Optional[Callable[[int, float], None]] = None,
                 on_retry: Optional[Callable[[int, BaseException], None]] = None,
                 on_checkpoint: Optional[Callable[[int, str], None]] = None):
        from ..core.executor import global_scope
        from ..flags import flag

        if (feed_fn is None) == (data is None):
            raise ValueError(
                "Supervisor needs exactly one feed source: feed_fn(step) "
                "OR a data iterable")
        self.exe = exe
        self.program = program
        # CompiledProgram wraps the Program whose persistables we save
        self._main = getattr(program, "_program", program)
        self.feed_fn = feed_fn
        self.data = data
        self.fetch_list = list(fetch_list or [])
        self.loss_index = loss_index
        self.scope = scope or global_scope()
        self.policy = policy or CheckpointPolicy(checkpoint_dir)
        if policy is not None and checkpoint_dir and \
                os.path.abspath(checkpoint_dir) != policy.dirname:
            raise ValueError("checkpoint_dir disagrees with policy.dirname")
        self.max_retries = int(
            flag("resilience_max_retries") if max_retries is None
            else max_retries)
        self.retry_backoff_s = float(
            flag("resilience_retry_backoff_s") if retry_backoff_s is None
            else retry_backoff_s)
        self.max_rollbacks = int(
            flag("resilience_max_rollbacks") if max_rollbacks is None
            else max_rollbacks)
        self.watchdog_timeout_s = float(
            flag("resilience_watchdog_timeout_s") if watchdog_timeout_s is None
            else watchdog_timeout_s)
        self.fault = fault_injector or FaultInjector.from_flags()
        self.on_step = on_step
        self.on_nan = on_nan
        self.on_retry = on_retry
        self.on_checkpoint = on_checkpoint
        self._worker: Optional[_StepWorker] = None
        self._preempted = threading.Event()
        self._data_iter = None
        self._replay: Dict[int, Dict[str, Any]] = {}
        self._data_consumed = 0  # next fresh index the iterator serves
        # rollback can only target a committed checkpoint, so feeds are
        # buffered only once one exists AND the cadence keeps creating
        # pruning points (each commit drops everything before it) —
        # bounded by the checkpoint cadence. With the cadence disabled
        # nothing is buffered, and a rollback that would need an
        # unbuffered feed fails loudly instead of silently feeding the
        # wrong batch (use feed_fn for unbounded replay).
        self._last_commit_step: Optional[int] = None
        self._abandoned: List[Dict[str, Any]] = []  # watchdog-orphaned tokens
        self._data_exhausted = False
        self._flight_dumps: List[str] = []
        self._stats: Dict[str, Any] = {
            "steps_completed": 0,
            "checkpoints_written": 0,
            "checkpoints_loaded": 0,
            "retries": 0,
            "rollbacks": 0,
            "watchdog_fires": 0,
            "zombie_steps": 0,
            "nan_events": 0,
            "faults_injected": 0,
            "preempted": False,
            "resumed_from": None,
        }
        # the counters export as paddle_resilience_*{sup=}
        from ..observability import watch_supervisor

        watch_supervisor(self)

    # -- introspection ------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Counter snapshot (copies; safe to mutate)."""
        out = dict(self._stats)
        out["faults_injected"] = len(self.fault.fired())
        out["flight_dumps"] = list(self._flight_dumps)
        return out

    def _flight_dump(self, reason: str, **extra) -> None:
        path = flight.dump(reason, extra=extra or None)
        if path is not None:
            self._flight_dumps.append(path)

    def request_preempt(self):
        """What the SIGTERM handler does — callable directly (tests,
        external schedulers): flush a final checkpoint at the next step
        boundary and exit the loop cleanly."""
        self._preempted.set()

    # -- resume -------------------------------------------------------------
    def resume(self) -> int:
        """Load the latest committed checkpoint (if any) and return the
        step index to continue from."""
        with tracing.span("resilience/restore",
                          {"dir": self.policy.dirname}):
            restored = self.policy.restore(main_program=self._main,
                                           scope=self.scope,
                                           mesh=self._strict_mesh())
        if restored is None:
            return 0
        step, extra = restored
        start = int(extra.get("step", step))
        if "run_counter" in extra:
            # every op's generator is seeded from (seed, run counter,
            # op_ident): restoring it replays dropout bit for bit
            self.exe._run_counter = int(extra["run_counter"])
        self._stats["checkpoints_loaded"] += 1
        self._stats["resumed_from"] = start
        self._last_commit_step = start
        if self.data is not None:
            pos = int(extra.get("reader_position", start))
            self._data_consumed = start
            if hasattr(self.data, "set_resume_position"):
                self.data.set_resume_position(pos)
            else:
                # plain iterable: fast-forward by consuming
                self._data_iter = iter(self.data)
                for _ in range(pos):
                    if next(self._data_iter, None) is None:
                        break
        return start

    def _strict_mesh(self):
        """The mesh to hold a restore to. Multi-host resume is strict —
        a trajectory committed on a foreign mesh shape must be refused
        by name, not die as a shard-count mismatch mid-assembly —
        while single-host resume stays elastic (sharding is a
        property of the placement, any topology restores)."""
        from .. import io

        _, world = io._dist_info()
        if world <= 1:
            return None
        mesh = getattr(self.program, "_mesh", None)
        return mesh if hasattr(mesh, "shape") else None

    # -- checkpointing ------------------------------------------------------
    def _save(self, completed_steps: int, reason: str) -> str:
        extra = {
            "run_counter": int(self.exe._run_counter),
            "random_seed": int(getattr(self._main, "random_seed", 0) or 0),
            "reason": reason,
            # the loop consumes exactly one batch per step, so the
            # position a FRESH process must fast-forward to is the step
            # counter itself — NOT data.position(), which runs ahead of
            # the step during post-rollback replay (replayed feeds come
            # from the buffer while the loader's count still includes
            # the rolled-back pulls)
            "reader_position": int(completed_steps),
        }
        # mesh-bound runs stamp the mesh shape into the commit marker:
        # resume on ANY topology stays supported (arrays land whole and
        # are placed afresh), but the marker records which mesh
        # produced the trajectory being resumed
        mesh = getattr(self.program, "_mesh", None)
        if mesh is not None and hasattr(mesh, "shape"):
            extra["mesh"] = {str(k): int(v)
                             for k, v in dict(mesh.shape).items()}
        from .. import io as _io

        _, world = _io._dist_info()
        if world > 1:
            # the marker records which world committed this trajectory
            # (and how many restarts deep the run was) — the restore
            # side's strict check and the chaos report both read it
            extra["world"] = world
            extra["restart_count"] = int(
                os.environ.get("PADDLE_RESTART_COUNT", "0"))
        with tracing.span(
                "resilience/checkpoint",
                {"step": completed_steps, "reason": reason}):
            path = self.policy.save(completed_steps,
                                    main_program=self._main,
                                    scope=self.scope, extra=extra)
        self._stats["checkpoints_written"] += 1
        self._last_commit_step = completed_steps
        # feeds before this point can never be replayed again
        self._replay = {s: f for s, f in self._replay.items()
                        if s >= completed_steps}
        if self.on_checkpoint is not None:
            self.on_checkpoint(completed_steps, path)
        return path

    def _rollback(self) -> Optional[int]:
        """Reload the last checkpoint THIS RUN committed or resumed
        from; returns the step to re-run from, or None when there is
        nothing to roll back to. Deliberately never "latest on disk":
        a fresh run (resume=False) pointed at a dir holding a previous
        run's commits must not silently restore foreign state."""
        if self._last_commit_step is None:
            return None
        with tracing.span("resilience/rollback",
                          {"dir": self.policy.dirname}):
            restored = self.policy.restore(main_program=self._main,
                                          scope=self.scope,
                                          step=self._last_commit_step,
                                          mesh=self._strict_mesh())
        if restored is None:
            return None
        step, extra = restored
        if "run_counter" in extra:
            self.exe._run_counter = int(extra["run_counter"])
        self._stats["checkpoints_loaded"] += 1
        self._stats["rollbacks"] += 1
        self._last_commit_step = int(extra.get("step", step))
        flight.note("event", what="rollback",
                    to_step=self._last_commit_step)
        return self._last_commit_step

    # -- feeds --------------------------------------------------------------
    def _feed_for(self, step: int) -> Optional[Dict[str, Any]]:
        if self.feed_fn is not None:
            return self.feed_fn(step)
        if step in self._replay:
            return self._replay[step]
        if step < self._data_consumed:
            # rollback reached a step whose feed was never buffered
            # (cadence disabled) — pulling the iterator here would
            # silently train on the WRONG batch
            raise RuntimeError(
                f"cannot replay step {step}: its feed is no longer "
                "available from the data iterator — enable a checkpoint "
                "cadence (which bounds the replay buffer) or supply "
                "feed_fn(step) so any step is re-derivable")
        if self._data_iter is None:
            self._data_iter = iter(self.data)
        try:
            feed = next(self._data_iter)
        except StopIteration:
            self._data_exhausted = True
            return None
        self._data_consumed = step + 1
        # buffer until the next checkpoint commits: rollback re-runs
        # these steps and an iterator cannot rewind. Before the first
        # commit there is nothing to roll back TO, and without a
        # cadence there is no pruning point — in both cases nothing is
        # buffered, keeping the buffer bounded by the cadence.
        if self._last_commit_step is not None and (
                self.policy.every_steps > 0 or self.policy.every_secs > 0):
            self._replay[step] = feed
        return feed

    # -- the step itself ----------------------------------------------------
    def _run_step(self, step: int, feed: Dict[str, Any]) -> List[Any]:
        def attempt(token=None):
            self.fault.before_step(step)
            if token is not None and token["cancelled"]:
                # the watchdog already gave up on this attempt (the
                # fault hang outlived the timeout); running the step
                # now would mutate the scope behind the retry's back
                return None
            if token is not None:
                # state mutation starts here: only attempts that got
                # this far count as zombies if abandoned (a cancelled
                # attempt that parked above never touched the scope)
                token["ran"] = True
            return self.exe.run(self.program, feed=feed,
                                fetch_list=self.fetch_list,
                                scope=self.scope)

        if self.watchdog_timeout_s > 0:
            if self._worker is None:
                self._worker = _StepWorker()
            run = attempt
            device = getattr(self.exe, "device", None)
            if device is not None and device.type == "cuda":
                # the worker launches on the caller's device and stream,
                # so a step is ordered with the caller's work as if the
                # caller ran it
                stream = torch.cuda.current_stream(device)

                def run(token):
                    with torch.cuda.device(device), torch.cuda.stream(stream):
                        return attempt(token)
            try:
                out = self._worker.call(run, self.watchdog_timeout_s)
            except WatchdogTimeout as e:
                self._stats["watchdog_fires"] += 1
                self._worker = None  # abandoned; next attempt gets a fresh one
                token = getattr(e, "token", None)
                if token is not None:
                    self._abandoned.append(token)
                flight.note("event", what="watchdog_fire", step=step,
                            timeout_s=self.watchdog_timeout_s)
                self._flight_dump("watchdog_hang", step=step,
                                  timeout_s=self.watchdog_timeout_s)
                raise
            if out is None:
                raise WatchdogTimeout("step cancelled by watchdog")
            return out
        return attempt()

    def _zombie_completed(self) -> bool:
        """True when a watchdog-abandoned step has since COMPLETED —
        its exe.run mutated the scope (and bumped the run counter)
        behind the retry's back, so the live state can no longer be
        trusted and the caller must roll back to the last commit.
        Tokens that finish WITHOUT having reached exe.run (parked in
        the cancellation check before it) never touched the scope —
        they are discarded, not treated as corruption. Tokens whose
        step never finishes (hung forever) stay pending and are
        harmless."""
        finished = [t for t in self._abandoned if t.get("finished")]
        if not finished:
            return False
        self._abandoned = [t for t in self._abandoned
                           if not t.get("finished")]
        zombies = [t for t in finished if t.get("ran")]
        self._stats["zombie_steps"] += len(zombies)
        return bool(zombies)

    def _absorb_zombies(self) -> Optional[int]:
        """Checked at every point that trusts the live scope (loop top,
        and immediately BEFORE every checkpoint save — committing
        zombie-corrupted state would poison the very checkpoint a later
        rollback restores). Returns the step to re-run from after
        rolling back, or None when the state is clean."""
        if not self._abandoned or not self._zombie_completed():
            return None
        rolled = self._rollback()
        if rolled is None:
            raise WatchdogTimeout(
                "a watchdog-abandoned step completed after its timeout "
                "and mutated training state, and no committed checkpoint "
                "exists to restore from")
        return rolled

    # -- the loop -----------------------------------------------------------
    def run_loop(self, num_steps: int, resume: bool = True,
                 final_checkpoint: bool = True) -> Dict[str, Any]:
        """Run (up to) ``num_steps`` supervised steps; returns
        ``stats()``. Safe to call again after a clean exit."""
        old_handler = None
        # a preempt flag from a PREVIOUS run_loop (external
        # request_preempt that was then rescinded) must not wedge this
        # call into flushing 0 steps forever. Cleared BEFORE the
        # handler installs so a SIGTERM landing in between is kept.
        self._preempted.clear()
        in_main = threading.current_thread() is threading.main_thread()
        # cleared BEFORE the handler installs (same discipline as
        # _preempted above): a SIGTERM landing mid-install must keep
        # its dump request, not have it wiped by a late reset
        self._dump_on_preempt = False
        if in_main:
            def _on_sigterm(signum, frame):
                # flag-set ONLY: the handler runs on the main thread,
                # which may hold the flight/telemetry locks mid-step —
                # dumping here would self-deadlock on those
                # non-reentrant locks. The loop body dumps at the next
                # step boundary (safe context) before the flush.
                self._dump_on_preempt = True
                self.request_preempt()

            old_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        try:
            step = self.resume() if resume else 0
            rollbacks_left = self.max_rollbacks
            while True:
                # zombie absorption comes before ANYTHING that trusts
                # or commits the live state; a rollback re-enters the
                # loop so the discarded tail steps are re-run
                rolled = self._absorb_zombies()
                if rolled is not None:
                    step = rolled
                    continue
                if step >= num_steps:
                    # end of budget. step == num_steps guards the
                    # resumed-past-the-budget case (resume() beyond
                    # num_steps): saving there would label later-step
                    # state with num_steps metadata
                    if final_checkpoint and step == num_steps and \
                            self.policy._last_saved_step != num_steps:
                        self._save(num_steps, reason="final")
                    break
                if self._preempted.is_set():
                    self._stats["preempted"] = True
                    if getattr(self, "_dump_on_preempt", False):
                        # evidence of what was in flight when the
                        # reclaim landed, captured BEFORE the flush
                        self._flight_dump("sigterm", step=step)
                    if final_checkpoint:
                        # best-effort in a multi-host teardown: when a
                        # peer is already dead the flush CANNOT commit
                        # (two-phase needs every rank) — exit cleanly
                        # on the last committed checkpoint instead of
                        # stalling into the launcher's SIGKILL
                        from .. import io as _io

                        try:
                            self._save(step, reason="preempt")
                        except _io.CheckpointCommitTimeout as e:
                            self._stats["preempt_flush_failed"] = True
                            flight.note(
                                "event", what="preempt_flush_failed",
                                step=step, error=repr(e))
                    break
                feed = self._feed_for(step)
                if feed is None:
                    # data exhausted: flush what was actually reached
                    if final_checkpoint and \
                            self.policy._last_saved_step != step:
                        self._save(step, reason="final")
                    break
                fetched, nan_loss = self._attempt(step, feed,
                                                  rollbacks_left)
                if nan_loss is not None:
                    # the NaN guard tripped with rollback budget left:
                    # restore OUTSIDE the retry try/except — a failing
                    # restore must propagate, not be retried as a
                    # transient step fault. The flight dump happens
                    # BEFORE the rollback: the evidence of interest is
                    # the state that produced the NaN, not the restored
                    # one.
                    flight.note("event", what="nan_loss", step=step,
                                loss=repr(nan_loss))
                    self._flight_dump("nan_rollback", step=step,
                                      loss=repr(nan_loss))
                    if self.on_nan is not None:
                        self.on_nan(step, nan_loss)
                    rolled = self._rollback()
                    if rolled is None:
                        raise NonFiniteLossError(
                            f"loss is {nan_loss} at step {step} and no "
                            "committed checkpoint exists to roll back to")
                    rollbacks_left -= 1
                    step = rolled
                    continue
                self._stats["steps_completed"] += 1
                if self.on_step is not None:
                    self.on_step(step, fetched)
                step += 1
                if self.policy.should_save(step):
                    # a zombie completing DURING the step just run must
                    # not be committed — absorb before the save
                    rolled = self._absorb_zombies()
                    if rolled is not None:
                        step = rolled
                        continue
                    self._save(step, reason="policy")
            return self.stats()
        except SystemExit:
            raise
        except BaseException as e:
            # an exception escaping the supervisor IS the crash the
            # flight recorder exists for: dump before propagating
            # (retryable faults never reach here — _attempt absorbed
            # them — so this fires once per terminal failure)
            self._flight_dump(f"exception:{type(e).__name__}",
                              error=repr(e))
            # multi-host: a stall (a hung step under the watchdog, or a
            # commit a dead peer never finished) is not a crash to
            # debug, it is a world to restart — exit with the code the
            # elastic launcher treats as "re-form the world and
            # auto-resume" instead of an arbitrary traceback status
            from .. import io as _io

            _, world = _io._dist_info()
            if world > 1 and isinstance(
                    e, (WatchdogTimeout, _io.CheckpointCommitTimeout)):
                raise SystemExit(RESTART_EXIT_CODE) from e
            raise
        finally:
            if in_main and old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)
            if self._worker is not None:
                self._worker.stop()
                self._worker = None

    def _attempt(self, step: int, feed: Dict[str, Any], rollbacks_left: int):
        """One logical step with retry handling. Returns (fetched,
        None) on success, or (None, nan_loss) when the NaN guard
        tripped and the caller should roll back (the restore itself
        happens in run_loop, outside this retry scope)."""
        attempts = 0
        while True:
            try:
                if tracing.enabled():
                    # per-attempt span: a retried step renders as two
                    # sibling ranges, each carrying its attempt index
                    with tracing.span("resilience/step",
                                      {"step": step, "attempt": attempts}):
                        fetched = self._run_step(step, feed)
                else:
                    fetched = self._run_step(step, feed)
                fetched = self.fault.after_step(step, fetched,
                                                self.loss_index)
                loss = self._loss_of(fetched)
                if loss is not None and not np.isfinite(loss):
                    self._stats["nan_events"] += 1
                    if rollbacks_left <= 0:
                        if self.on_nan is not None:
                            self.on_nan(step, loss)
                        raise NonFiniteLossError(
                            f"loss is {loss} at step {step} and the "
                            f"rollback budget ({self.max_rollbacks}) is "
                            "exhausted — the run is diverging")
                    return None, loss
                return fetched, None
            except (KeyboardInterrupt, SystemExit, NonFiniteLossError):
                raise
            except Exception as e:  # noqa: BLE001 — transient step faults
                attempts += 1
                if attempts > self.max_retries:
                    raise
                self._stats["retries"] += 1
                flight.note("event", what="retry", step=step,
                            attempt=attempts, error=repr(e))
                if self.on_retry is not None:
                    self.on_retry(step, e)
                time.sleep(self.retry_backoff_s * (2 ** (attempts - 1)))

    def _loss_of(self, fetched) -> Optional[float]:
        if not fetched or self.loss_index >= len(fetched):
            return None
        v = fetched[self.loss_index]
        try:
            return float(np.asarray(v).reshape(-1)[0])
        except (TypeError, ValueError):
            return None
