"""Checkpoint cadence + atomic commit + retention for supervised runs
(the port's copy of ``paddle_tpu/resilience/checkpoint.py``).

The commit protocol (the part a crash can never corrupt):

1. persistables are saved into a STAGING directory
   (``<dir>/.staging.<step>.<pid>``) by io.save_checkpoint, which
   stamps the commit marker — a manifest of every file plus the
   supervisor's resume metadata — as its last write;
2. the staging dir is published as ``<dir>/<step>`` via
   ``LocalFS.atomic_rename`` (os.replace + parent-dir fsync), so
   ``io.latest_checkpoint`` observes either nothing or a complete,
   committed checkpoint;
3. retention GC then deletes committed checkpoints beyond ``keep_last``
   (newest kept) and any stale staging dirs a previous crash left
   behind.

A checkpoint directory name is the number of COMPLETED steps — i.e.
the step index the resumed run starts at.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

from .. import io
from ..fs import LocalFS

__all__ = ["CheckpointPolicy"]

_STAGING_PREFIX = ".staging."


class CheckpointPolicy:
    """every-N-steps / every-T-seconds cadence + keep_last retention.

    ``every_steps`` / ``every_secs`` / ``keep_last`` default from the
    ``resilience_*`` flags; 0 disables that trigger (both disabled =
    only final/preemption flushes are written).
    """

    def __init__(self, dirname: str, every_steps: Optional[int] = None,
                 every_secs: Optional[float] = None,
                 keep_last: Optional[int] = None):
        from ..flags import flag

        self.dirname = os.path.abspath(dirname)
        self.every_steps = int(
            flag("resilience_ckpt_every_steps")
            if every_steps is None else every_steps)
        self.every_secs = float(
            flag("resilience_ckpt_every_secs")
            if every_secs is None else every_secs)
        self.keep_last = int(
            flag("resilience_keep_last") if keep_last is None else keep_last)
        self._fs = LocalFS()
        self._last_save_time = time.time()
        self._last_saved_step: Optional[int] = None

    # -- cadence ------------------------------------------------------------
    def should_save(self, completed_steps: int) -> bool:
        if completed_steps == self._last_saved_step:
            return False
        if self.every_steps > 0 and completed_steps > 0 \
                and completed_steps % self.every_steps == 0:
            return True
        if self.every_secs > 0 \
                and time.time() - self._last_save_time >= self.every_secs:
            return True
        return False

    # -- commit -------------------------------------------------------------
    def save(self, completed_steps: int, main_program=None, scope=None,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Atomically commit a checkpoint for ``completed_steps`` and
        run retention GC. Returns the committed directory.

        Multi-host: every rank saves into ONE shared staging directory
        (``.staging.<step>.shared`` — the pid suffix would split the
        world across directories); io.save_checkpoint runs the
        two-phase shard-done/marker protocol inside it, and process 0
        alone publishes (atomic_rename) and GCs. Non-zero ranks return
        once they have SEEN the commit marker — a collective save, like
        every multi-host checkpoint format's."""
        step = int(completed_steps)
        rank, world = io._dist_info()
        staging = os.path.join(
            self.dirname,
            f"{_STAGING_PREFIX}{step}."
            f"{'shared' if world > 1 else os.getpid()}")
        final = os.path.join(self.dirname, str(step))
        meta = {"step": step}
        meta.update(extra or {})
        if self._same_trajectory_commit(final, meta):
            # a committed dir for this step already exists AND its
            # resume metadata (run counter, seed, step) matches ours —
            # i.e. a post-rollback replay re-reached a cadence point,
            # where the replay is bit-exact and the content identical.
            # Skipping avoids moving a live committed checkpoint aside.
            # A mismatching commit is a FOREIGN run's (reused dir):
            # fall through and replace it with this run's state.
            # (Multi-host: the metadata is deterministic-identical
            # across ranks, so every rank takes this branch together.)
            self._last_save_time = time.time()
            self._last_saved_step = step
            if rank == 0:
                self.gc()
            return final
        self._fs.mkdirs(self.dirname)
        if world == 1:
            self._fs.delete(staging)
        # multi-host: deleting the SHARED staging here would race the
        # other ranks' writes — io's stage-ready handshake (rank 0
        # clears debris, then posts the attempt token) owns cleanup
        io.save_checkpoint(staging, main_program=main_program, scope=scope,
                           extra=meta, publish_path=final)
        if rank == 0:
            # dst, if present, is an uncommitted leftover or a foreign
            # run's commit (checked above) — atomic_rename's aside
            # protocol replaces it with the narrowest possible
            # destruction window
            self._fs.atomic_rename(staging, final)
        self._last_save_time = time.time()
        self._last_saved_step = step
        if rank == 0:
            self.gc()
        return final

    @staticmethod
    def _same_trajectory_commit(path: str, meta: Dict[str, Any]) -> bool:
        """True when ``path`` holds a committed checkpoint whose resume
        metadata matches ``meta`` — the signature of a bit-exact replay
        re-committing its own step (run counter + RNG seed + step pin
        the trajectory; ``reason`` may legitimately differ)."""
        if not io.is_committed_checkpoint(path):
            return False
        existing = (io.read_commit_marker(path) or {}).get("extra", {})
        return all(existing.get(k) == v for k, v in meta.items()
                   if k != "reason")

    # -- restore ------------------------------------------------------------
    def latest(self) -> Optional[int]:
        return io.latest_checkpoint(self.dirname)

    def committed_steps(self):
        return io.committed_checkpoint_steps(self.dirname)

    def restore(self, main_program=None, scope=None,
                step: Optional[int] = None, mesh=None
                ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """Load the latest (or a specific) committed checkpoint into
        ``scope``; returns (completed_steps, marker extra) or None when
        no committed checkpoint exists. ``mesh`` forwards to
        ``io.load_checkpoint``'s strict topology check (multi-host
        resume refuses a foreign-mesh trajectory by name)."""
        if step is None:
            step = self.latest()
            if step is None:
                return None
        path = os.path.join(self.dirname, str(int(step)))
        io.load_checkpoint(self.dirname, main_program=main_program,
                           scope=scope, step=step, mesh=mesh)
        marker = io.read_commit_marker(path) or {}
        return int(step), dict(marker.get("extra", {}))

    # -- retention ----------------------------------------------------------
    def gc(self) -> int:
        """Delete committed checkpoints beyond keep_last (newest kept;
        keep_last <= 0 keeps everything), uncommitted numeric dirs, and
        stale staging / rename-aside debris. Returns the number of
        directories removed.

        Foreign-pid staging dirs are only collected once older than
        ``stale_after_s`` (15 min): a second live writer sharing the
        directory — or a recycled pid — must not have its in-progress
        save deleted from under it. Single-writer-per-dir remains the
        supported deployment; the staleness window just bounds the
        damage of a violation."""
        stale_after_s = 15 * 60.0
        if not os.path.isdir(self.dirname):
            return 0

        def stale(path):
            try:
                return time.time() - os.path.getmtime(path) > stale_after_s
            except OSError:
                return False  # vanished concurrently

        removed = 0
        committed = self.committed_steps()
        drop = set(committed[:-self.keep_last]) if self.keep_last > 0 else set()
        # never collect the commit THIS policy wrote last: in a reused
        # dir, foreign higher-step commits would otherwise outrank and
        # immediately delete a fresh run's only checkpoint (the
        # foreigners get dropped progressively by later saves instead)
        drop.discard(self._last_saved_step)
        for entry in os.listdir(self.dirname):
            full = os.path.join(self.dirname, entry)
            if entry.startswith(_STAGING_PREFIX) or ".old." in entry:
                # a LIVE staging dir only exists inside save() in this
                # process (deleted/renamed before save returns); a
                # foreign-pid one that stopped changing is the debris
                # of a crashed writer. ".old." dirs are atomic_rename
                # asides a crash stranded.
                if not entry.endswith(f".{os.getpid()}") and stale(full):
                    self._fs.delete(full)
                    removed += 1
            elif entry.isdigit():
                s = int(entry)
                if s in drop or (s not in committed and stale(full)):
                    self._fs.delete(full)
                    removed += 1
        return removed
