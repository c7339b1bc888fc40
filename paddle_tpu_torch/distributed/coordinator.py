"""Multi-process coordination: rendezvous, the mesh, heartbeats, and
barriers with restartable-exit semantics. The port's counterpart of
``paddle_tpu/distributed/coordinator.py``.

* ``initialize()`` forms the world from the ``PADDLE_*`` contract the
  launcher exports (``parallel.env.init_parallel_env``) and starts the
  heartbeat the launcher's failure detector reads;
* ``build_mesh()`` arranges the world's ranks process-major into a
  ``parallel.mesh.Mesh`` (one process a device, so rank order);
* ``barrier()`` is a named barrier over the world's ``TCPStore`` with a
  timeout: a dead or wedged peer becomes ``BarrierTimeout``, and
  ``restartable_exit()`` turns that into ``RESTART_EXIT_CODE``, which
  the launcher reads as "restart the world";
* ``host_allreduce()`` averages small named host arrays through the
  same store (no device collective);
* ``make_global_array()`` checks this rank's local batch and puts it on
  the rank's device: in the port's one-process-a-device model, the
  local batch IS the rank's feed.

Everything is a no-op in a world of one. Gauges: ``paddle_dist_*``
(world size, rank, restarts, live ranks, the oldest heartbeat, barrier
counts and their cumulative wait).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

__all__ = [
    "Coordinator", "BarrierTimeout", "RESTART_EXIT_CODE",
    "initialize", "get_coordinator", "spans_processes",
]

_log = logging.getLogger("paddle_tpu_torch.distributed")

# "this failure is restartable: re-form the world and resume from the
# last committed checkpoint" (EX_TEMPFAIL)
RESTART_EXIT_CODE = 75

_HB_PREFIX = "hb.rank"


class BarrierTimeout(RuntimeError):
    """A coordination barrier timed out: some rank died or wedged. The
    clean recovery is a world restart (``restartable_exit``)."""


class Coordinator:
    """One process's view of the world: rank, world size and restart
    count, the heartbeat thread, and the barrier sequence numbers
    (every rank runs the same barrier calls, so a per-name counter
    keeps the store's keys aligned)."""

    def __init__(self, rank: int, world_size: int,
                 heartbeat_dir: Optional[str] = None,
                 heartbeat_interval_s: float = 2.5, store=None):
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.restart_count = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
        self.heartbeat_dir = heartbeat_dir
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self._store = store
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self._progress_fn = None
        self._progress_stall_s = 0.0
        self._progress_last: Any = None
        self._progress_changed = time.time()
        self._barrier_seq: Dict[str, int] = {}
        self._stats_lock = threading.Lock()
        self._stats: Dict[str, float] = {
            "barriers_total": 0,
            "barrier_wait_ms_total": 0.0,
            "barrier_timeouts_total": 0,
            "heartbeats_total": 0,
        }
        from ..observability import watch_coordinator

        watch_coordinator(self)

    @property
    def is_distributed(self) -> bool:
        return self.world_size > 1

    def __repr__(self):
        return (f"Coordinator(rank={self.rank}/{self.world_size}, "
                f"restarts={self.restart_count})")

    # -- heartbeats ----------------------------------------------------------
    def _hb_path(self, rank: Optional[int] = None) -> Optional[str]:
        if not self.heartbeat_dir:
            return None
        return os.path.join(
            self.heartbeat_dir,
            f"{_HB_PREFIX}{self.rank if rank is None else rank}")

    def start_heartbeat(self) -> bool:
        """Touch this rank's heartbeat file every
        ``heartbeat_interval_s``; the launcher declares a rank whose
        heartbeat is older than its ``--heartbeat_timeout_s`` hung. A
        no-op without a heartbeat dir."""
        if self._hb_thread is not None or not self.heartbeat_dir:
            return self._hb_thread is not None
        os.makedirs(self.heartbeat_dir, exist_ok=True)
        self._hb_stop = stop = threading.Event()
        self._beat()

        def loop():
            while not stop.wait(self.heartbeat_interval_s):
                if self._progress_stalled():
                    continue  # alive but not working: let it go stale
                try:
                    self._beat()
                except OSError:
                    return

        self._hb_thread = threading.Thread(
            target=loop, daemon=True, name=f"pt-dist-hb-{self.rank}")
        self._hb_thread.start()
        return True

    def attach_progress(self, fn, stall_after_s: float = 60.0):
        """Make the heartbeat progress-based: once ``fn()`` stops
        changing for ``stall_after_s`` the heartbeat goes silent, so a
        rank wedged in a dead peer's collective reads as hung."""
        self._progress_fn = fn
        self._progress_stall_s = float(stall_after_s)
        self._progress_last = None
        self._progress_changed = time.time()

    def _progress_stalled(self) -> bool:
        fn = self._progress_fn
        if fn is None or self._progress_stall_s <= 0:
            return False
        try:
            v = fn()
        except Exception:  # noqa: BLE001 — the probe must never kill the beat
            return False
        if v != self._progress_last:
            self._progress_last = v
            self._progress_changed = time.time()
            return False
        return time.time() - self._progress_changed > self._progress_stall_s

    def _beat(self):
        path = self._hb_path()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(time.time()))
        os.replace(tmp, path)
        with self._stats_lock:
            self._stats["heartbeats_total"] += 1

    def stop_heartbeat(self):
        self._hb_stop.set()
        self._hb_thread = None

    def heartbeat_ages(self) -> Dict[int, float]:
        """rank -> seconds since its last heartbeat, for every rank
        that has beaten."""
        out: Dict[int, float] = {}
        if not self.heartbeat_dir or not os.path.isdir(self.heartbeat_dir):
            return out
        now = time.time()
        for entry in os.listdir(self.heartbeat_dir):
            if not entry.startswith(_HB_PREFIX) or ".tmp." in entry:
                continue
            try:
                rank = int(entry[len(_HB_PREFIX):])
                out[rank] = max(0.0, now - os.path.getmtime(
                    os.path.join(self.heartbeat_dir, entry)))
            except (ValueError, OSError):
                continue
        return out

    def live_ranks(self, stale_after_s: Optional[float] = None) -> int:
        """Ranks whose heartbeat is fresher than ``stale_after_s``
        (default 4x the interval); without a heartbeat dir, 1."""
        ages = self.heartbeat_ages()
        if not ages:
            return 1
        cutoff = (4.0 * self.heartbeat_interval_s
                  if stale_after_s is None else float(stale_after_s))
        return sum(1 for a in ages.values() if a <= cutoff)

    # -- barrier -------------------------------------------------------------
    def _need_store(self, what: str):
        if self._store is None:
            raise BarrierTimeout(
                f"{what}: no world in this process — call "
                "distributed.initialize() first")
        return self._store

    def barrier(self, name: str, timeout_s: Optional[float] = None) -> float:
        """Named barrier across every process with a timeout (default
        the ``dist_barrier_timeout_s`` flag): each rank adds one to the
        store key of this barrier's use and waits until it reads the
        world size. Returns the seconds waited; a stall raises
        ``BarrierTimeout``. A no-op in a world of one."""
        if self.world_size <= 1:
            return 0.0
        from ..flags import flag

        timeout_s = (float(flag("dist_barrier_timeout_s"))
                     if timeout_s is None else float(timeout_s))
        store = self._need_store(f"barrier {name!r}")
        seq = self._barrier_seq.get(name, 0)
        self._barrier_seq[name] = seq + 1
        key = f"paddle:{name}:{seq}"
        t0 = time.perf_counter()
        deadline = time.time() + timeout_s
        count = store.add(key, 1)
        while count < self.world_size:
            if time.time() >= deadline:
                with self._stats_lock:
                    self._stats["barrier_timeouts_total"] += 1
                raise BarrierTimeout(
                    f"barrier {name!r} (key {key}) did not complete within "
                    f"{timeout_s:.0f}s ({count}/{self.world_size} ranks "
                    "arrived) — a peer rank likely died or wedged; exit "
                    f"with RESTART_EXIT_CODE ({RESTART_EXIT_CODE}) so the "
                    "launcher restarts the world")
            time.sleep(0.005)
            count = store.add(key, 0)
        waited = time.perf_counter() - t0
        with self._stats_lock:
            self._stats["barriers_total"] += 1
            self._stats["barrier_wait_ms_total"] += waited * 1e3
        return waited

    # -- host-side collective ----------------------------------------------
    def host_allreduce(self, arrays: Dict[str, Any], tag: str,
                       timeout_s: Optional[float] = None,
                       op: str = "mean") -> Dict[str, Any]:
        """Average (or sum) small named float arrays across every
        process through the store: for KBs, not gradients. Floats are
        summed in float64 in rank order, so every rank gets the same
        bits; other dtypes keep rank 0's value. A rank that never
        publishes turns into ``BarrierTimeout``."""
        if self.world_size <= 1:
            return {k: np.asarray(v) for k, v in arrays.items()}
        if op not in ("mean", "sum"):
            raise ValueError(f"host_allreduce: op must be 'mean' or "
                             f"'sum', got {op!r}")
        import datetime
        import io as _io

        from ..flags import flag

        timeout_s = (float(flag("dist_barrier_timeout_s"))
                     if timeout_s is None else float(timeout_s))
        store = self._need_store(f"host_allreduce {tag!r}")
        buf = _io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
        store.set(f"paddle:ar:{tag}:{self.rank}", buf.getvalue())
        total: Dict[str, Any] = {}
        t0 = time.perf_counter()
        old = store.timeout
        store.set_timeout(datetime.timedelta(seconds=timeout_s))
        try:
            for rank in range(self.world_size):
                key = f"paddle:ar:{tag}:{rank}"
                try:
                    store.wait([key])
                except Exception as e:  # noqa: BLE001 — the store's timeout
                    with self._stats_lock:
                        self._stats["barrier_timeouts_total"] += 1
                    raise BarrierTimeout(
                        f"host_allreduce {tag!r}: rank {rank} never "
                        f"published its payload within {timeout_s:.0f}s — "
                        "a peer likely died; exit restartably so the "
                        f"launcher re-forms the world ({type(e).__name__})"
                    ) from e
                with np.load(_io.BytesIO(store.get(key))) as z:
                    for k in z.files:
                        if z[k].dtype.kind != "f":
                            total.setdefault(k, z[k])
                            continue
                        v = z[k].astype(np.float64)
                        total[k] = v if k not in total else total[k] + v
        finally:
            store.set_timeout(old)
        with self._stats_lock:
            self._stats["barriers_total"] += 1
            self._stats["barrier_wait_ms_total"] += \
                (time.perf_counter() - t0) * 1e3
        out = {}
        for k, v in total.items():
            ref = np.asarray(arrays[k])
            if ref.dtype.kind == "f":
                if op == "mean":
                    v = v / self.world_size
                v = v.astype(ref.dtype)
            out[k] = v
        return out

    # -- mesh ------------------------------------------------------------------
    def build_mesh(self, mesh_axes, devices=None):
        """A ``parallel.mesh.Mesh`` of ``mesh_axes`` ("dp=2" or a dict)
        over the world's ranks, process-major."""
        from ..parallel.mesh import make_mesh
        from ..partition.rules import parse_mesh

        axes = parse_mesh(mesh_axes)
        if not axes:
            raise ValueError("build_mesh needs at least one axis, e.g. "
                             "'dp=2'")
        total = int(np.prod(list(axes.values())))
        if total > self.world_size:
            raise ValueError(
                f"mesh {dict(axes)} needs {total} devices, the world has "
                f"{self.world_size} ({self.world_size} process(es) x 1 "
                "local)")
        return make_mesh(axes)

    # -- feeds -------------------------------------------------------------
    def make_global_array(self, sharding, local_batch, device=None):
        """This rank's LOCAL batch as its feed tensor: in a world of one
        process a device, the global batch is the ranks' local batches
        in rank order, and each rank feeds its own. ``sharding`` (a spec
        or a (mesh, spec) pair) is checked to split only dim 0."""
        import torch

        from ..device import resolve_device

        spec = sharding[1] if isinstance(sharding, tuple) and len(
            sharding) == 2 and not isinstance(sharding[0], str) else sharding
        if spec is not None:
            for d, e in enumerate(tuple(spec)):
                if d > 0 and e is not None:
                    raise ValueError(
                        f"make_global_array: spec {tuple(spec)} splits dim "
                        f"{d}; a rank's feed splits only the batch dim")
        if isinstance(local_batch, torch.Tensor):
            t = local_batch
        else:
            t = torch.from_numpy(np.ascontiguousarray(local_batch))
        return t.to(resolve_device(device))

    # -- exits -------------------------------------------------------------
    def restartable_exit(self, reason: str) -> "SystemExit":
        """Log and flight-note ``reason``; return the SystemExit with
        ``RESTART_EXIT_CODE`` for the caller to raise."""
        _log.error("restartable exit (rank %d): %s", self.rank, reason)
        try:
            from ..observability import flight

            flight.note("event", what="restartable_exit", rank=self.rank,
                        reason=reason)
        except Exception:  # noqa: BLE001 — exiting anyway
            pass
        return SystemExit(RESTART_EXIT_CODE)

    # -- telemetry -----------------------------------------------------------
    def stats_numeric(self) -> Dict[str, float]:
        ages = self.heartbeat_ages()
        with self._stats_lock:
            out = dict(self._stats)
        out.update(
            world_size=self.world_size,
            rank=self.rank,
            restarts=self.restart_count,
            live_ranks=self.live_ranks() if ages else self.world_size,
            heartbeat_age_s=round(max(ages.values()), 3) if ages else 0.0,
        )
        return out


_COORD: Optional[Coordinator] = None
_COORD_LOCK = threading.Lock()


def initialize(coordinator_address: Optional[str] = None,
               heartbeat: bool = True, backend: Optional[str] = None
               ) -> Coordinator:
    """Rendezvous and heartbeat from the launcher's contract: forms the
    world (``init_parallel_env``), then starts the heartbeat thread when
    the launcher exported ``PADDLE_HEARTBEAT_DIR``. Idempotent."""
    global _COORD
    with _COORD_LOCK:
        if _COORD is not None:
            return _COORD
        from ..parallel.env import (default_store, get_rank, get_world_size,
                                    init_parallel_env)

        init_parallel_env(coordinator_address, backend=backend)
        coord = Coordinator(
            get_rank(), get_world_size(),
            heartbeat_dir=os.environ.get("PADDLE_HEARTBEAT_DIR") or None,
            heartbeat_interval_s=float(
                os.environ.get("PADDLE_HEARTBEAT_INTERVAL_S", "2.5")),
            store=default_store())
        if heartbeat:
            coord.start_heartbeat()
        _COORD = coord
        _log.info("coordinator up: rank %d/%d restart=%d heartbeat=%s",
                  coord.rank, coord.world_size, coord.restart_count,
                  coord.heartbeat_dir or "off")
        return coord


def get_coordinator() -> Optional[Coordinator]:
    """The live Coordinator, or None before ``initialize()``."""
    return _COORD


def spans_processes(mesh) -> bool:
    """True when ``mesh`` places more than one process: its collectives
    cross processes (the planner's per-axis bucket choice keys on it)."""
    if mesh is None or not hasattr(mesh, "devices"):
        return False
    return int(np.asarray(mesh.devices).size) > 1
