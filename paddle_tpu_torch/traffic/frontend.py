"""Scale-out front: multi-process workers, rolling restart, router
(the counterpart of ``paddle_tpu/traffic/frontend.py``).

One serving process is one GIL: the engine's batcher coalesces well,
but request parsing, JSON, and HTTP all contend a single interpreter.
The production shape is N worker PROCESSES behind one port:

* **SO_REUSEPORT** (Linux): every worker binds the SAME host:port and
  the kernel load-balances new connections across listeners — no
  userspace router, no extra hop. This is the default when the
  platform supports it.
* **ThinRouter fallback**: a stdlib TCP splice (accept -> pick a
  backend round-robin -> pump bytes both ways) in front of per-worker
  ports, for platforms without SO_REUSEPORT and for tests that need
  deterministic routing. Backends can be swapped live
  (``set_backends``) — that is the drain hook.
* **Warm start**: each worker is a spawned process with a CUDA context
  of its own (``device`` in the worker spec, the card by default; the
  CPU tests pass ``device="cpu"``). It loads the kernel library that an
  earlier build left under ``kernels/build/``, found by the hash of its
  sources, so no worker recompiles. The JAX package's persistent
  compile cache (``compile_cache_dir``) and ``JAX_PLATFORMS`` have no
  counterpart. Workers report their boot and warmup times.
* **Rolling restart** (``WorkerPool.rolling_restart``): for each
  worker, in order — spawn the replacement, wait until it reports
  ready (listening + warmed), flip the old worker to drain (stop
  accepting, flush the traffic queues and the engine, wait for
  in-flight HTTP responses to finish writing), then let it exit. At
  no point is the port unserved, and no accepted request is dropped.

Worker control runs over a ``multiprocessing.Pipe`` per worker (the
front port is shared, so per-worker HTTP control is impossible under
SO_REUSEPORT): parent sends ``("drain", None)`` / ``("stop", None)``,
child reports ``("ready", info)`` / ``("drained", stats)``.
"""

from __future__ import annotations

import multiprocessing as _mp
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["WorkerPool", "ThinRouter", "reuseport_supported"]


def reuseport_supported() -> bool:
    return hasattr(socket, "SO_REUSEPORT")


def _free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (bind to 0, read, release)."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- the worker process ------------------------------------------------------


def _worker_main(spec: Dict[str, Any], conn) -> None:
    """Entry point of one worker process (spawned, so this re-imports
    the stack from scratch, as a fleet rollout does)."""
    t_boot = time.perf_counter()
    # fleet identity + the parent's trace context, stamped at spawn:
    # PADDLE_WORKER_ID labels every span this process records (the
    # process-lane key in assembled traces) and PADDLE_TRACE_CONTEXT
    # parents the boot span under the parent's rollout trace
    if spec.get("worker_id"):
        os.environ["PADDLE_WORKER_ID"] = str(spec["worker_id"])
    for k, v in (spec.get("trace_env") or {}).items():
        os.environ[k] = str(v)
    import numpy as np

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.observability import propagate, tracing
    from paddle_tpu_torch.serving import ServingEngine, ServingServer
    from paddle_tpu_torch.traffic import TrafficConfig, TrafficController

    try:
        if spec.get("flags"):
            fluid.set_flags(dict(spec["flags"]))
        with tracing.attach(propagate.from_env()), \
             tracing.span("traffic/worker_boot",
                          {"worker": spec.get("worker_id") or ""}):
            cfg = Config(spec["model_dir"])
            if spec.get("batch_buckets"):
                cfg.enable_shape_bucketing(
                    batch_buckets=tuple(spec["batch_buckets"]))
            pred = create_predictor(cfg, device=spec.get("device"))
            # measured warmup: one run per batch bucket (the first run
            # on the card also loads the kernel library)
            shapes = spec.get("warmup_shapes") or {}
            t0 = time.perf_counter()
            if shapes:
                for b in (spec.get("batch_buckets") or [1]):
                    feed = {name: np.zeros([b] + list(shape[1:]),
                                           np.float32)
                            for name, shape in shapes.items()}
                    pred.run([feed[n] for n in pred.get_input_names()])
            warmup_ms = (time.perf_counter() - t0) * 1e3
            engine = ServingEngine(pred, **(spec.get("engine_kwargs")
                                            or {}))
            controller = None
            if spec.get("traffic", True):
                controller = TrafficController(
                    engine,
                    config=TrafficConfig.from_flags(
                        **(spec.get("traffic_kwargs") or {})))
            server = ServingServer(
                engine, host=spec["host"], port=spec["port"],
                traffic=controller,
                reuse_port=bool(spec.get("reuse_port")),
                phase=spec.get("phase"))
        conn.send(("ready", {
            "pid": os.getpid(),
            "port": server.port,
            "worker_id": spec.get("worker_id"),
            "warmup_ms": round(warmup_ms, 2),
            "boot_s": round(time.perf_counter() - t_boot, 3),
            "device": str(pred.device),
            "phase": spec.get("phase"),
        }))
    except Exception as e:  # noqa: BLE001 — the parent must see the failure
        try:
            conn.send(("error", repr(e)))
        finally:
            os._exit(1)
        return

    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            msg = ("stop", None)
        kind = msg[0] if isinstance(msg, tuple) else msg
        if kind == "drain":
            # the rolling-restart drain protocol, in order:
            # 1. stop accepting (listening socket closes; established
            #    connections and their handler threads live on)
            server.close()
            # 2. grace: an accepted-but-not-yet-submitted request must
            #    reach the engine before admission stops
            time.sleep(float(spec.get("drain_grace_s", 0.3)))
            # 3. flush the traffic queues into the engine, then the
            #    engine's own queue through the workers
            if controller is not None:
                controller.close(drain=True)
            engine.close(drain=True)
            # 4. in-flight HTTP responses finish writing before the
            #    process exits (exiting earlier severs their sockets)
            t_end = time.monotonic() + 10.0
            while server.active_requests() and time.monotonic() < t_end:
                time.sleep(0.01)
            snap = engine.metrics.snapshot()
            conn.send(("drained", {
                "responses_total": snap["responses_total"],
                "errors_total": snap["errors_total"],
                "active_at_exit": server.active_requests(),
            }))
            return
        if kind == "ping":
            conn.send(("pong", engine.metrics.snapshot()["requests_total"]))
            continue
        if kind == "trace":
            # live trace re-stamp over the control pipe (the front
            # port is shared under SO_REUSEPORT, so per-worker HTTP
            # is impossible): the parent pushes fresh PADDLE_TRACE_*
            # values and the child acks with the trace id it now holds
            for k, v in (msg[1] or {}).items():
                os.environ[k] = str(v)
            conn.send(("traced",
                       os.environ.get(propagate.ENV_TRACE_ID)))
            continue
        if kind == "stop":
            server.close()
            if controller is not None:
                controller.close(drain=False)
            engine.close(drain=False)
            return


class _Worker:
    __slots__ = ("proc", "conn", "port", "info")

    def __init__(self, proc, conn, port: int, info: Dict[str, Any]):
        self.proc = proc
        self.conn = conn
        self.port = port
        self.info = info


class ThinRouter:
    """Stdlib TCP splice for platforms without SO_REUSEPORT (and for
    deterministic tests): accepts on the front port, connects each
    client to a backend (round-robin over the LIVE set), pumps bytes
    both ways. ``set_backends`` swaps the set atomically — a draining
    worker is removed BEFORE it stops accepting, so no new connection
    ever lands on it."""

    def __init__(self, host: str, port: int,
                 backends: List[Tuple[str, int]], start: bool = True):
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.host, self.port = self._sock.getsockname()[:2]
        self._lock = threading.Lock()
        self._backends = list(backends)
        self._rr = 0
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    def set_backends(self, backends: List[Tuple[str, int]]) -> None:
        with self._lock:
            self._backends = list(backends)

    def backends(self) -> List[Tuple[str, int]]:
        with self._lock:
            return list(self._backends)

    def _pick(self) -> Optional[Tuple[str, int]]:
        with self._lock:
            if not self._backends:
                return None
            b = self._backends[self._rr % len(self._backends)]
            self._rr += 1
            return b

    @staticmethod
    def _pump(src: socket.socket, dst: socket.socket) -> None:
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s, how in ((dst, socket.SHUT_WR), (src, socket.SHUT_RD)):
                try:
                    s.shutdown(how)
                except OSError:
                    pass

    def _handle(self, client: socket.socket) -> None:
        """Per-connection: pick a backend, connect, splice. Runs OFF
        the accept loop — a hung backend must only stall its own
        client, never head-of-line-block every new connection."""
        backend = self._pick()
        if backend is None:
            client.close()
            return
        try:
            upstream = socket.create_connection(backend, timeout=5)
        except OSError:
            client.close()
            return
        threading.Thread(target=self._pump, args=(upstream, client),
                         name="pt-router-pump", daemon=True).start()
        self._pump(client, upstream)

    def _serve(self) -> None:
        while not self._closed:
            try:
                client, _addr = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(client,),
                             name="pt-router-conn", daemon=True).start()

    def start(self) -> "ThinRouter":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._serve, name="pt-traffic-router", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class WorkerPool:
    """N serving worker processes behind one front port.

        pool = traffic.WorkerPool(model_dir, num_workers=2, port=8500,
                                  warmup_shapes={"x": [1, 16]})
        pool.address            # http://host:port (shared)
        report = pool.rolling_restart()   # zero-downtime, warm starts
        pool.close()

    ``use_reuseport=None`` auto-selects: kernel SO_REUSEPORT when
    available, else the ThinRouter in front of per-worker ports.
    ``device`` is where every worker's predictor runs (CUDA when None).
    """

    def __init__(self, model_dir: str, num_workers: int = 2,
                 host: str = "127.0.0.1", port: int = 0, *,
                 use_reuseport: Optional[bool] = None,
                 device: Optional[str] = None,
                 batch_buckets: Optional[List[int]] = None,
                 warmup_shapes: Optional[Dict[str, List[int]]] = None,
                 engine_kwargs: Optional[Dict[str, Any]] = None,
                 traffic: bool = True,
                 traffic_kwargs: Optional[Dict[str, Any]] = None,
                 flags: Optional[Dict[str, Any]] = None,
                 drain_grace_s: float = 0.3,
                 ready_timeout_s: float = 120.0,
                 phase: Optional[str] = None,
                 start: bool = True):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.model_dir = model_dir
        self.num_workers = int(num_workers)
        self.host = host
        self.use_reuseport = (reuseport_supported()
                              if use_reuseport is None else bool(use_reuseport))
        self.port = port or _free_port(host)
        self.ready_timeout_s = float(ready_timeout_s)
        self._spec_base: Dict[str, Any] = {
            "model_dir": model_dir, "host": host,
            # where each worker's predictor runs: the card unless the
            # caller names the CPU
            "device": device,
            "batch_buckets": list(batch_buckets or []),
            "warmup_shapes": dict(warmup_shapes or {}),
            "engine_kwargs": dict(engine_kwargs or {}),
            "traffic": bool(traffic),
            "traffic_kwargs": dict(traffic_kwargs or {}),
            "flags": dict(flags or {}),
            "drain_grace_s": float(drain_grace_s),
            # disagg: which inference phase this pool serves — stamped
            # on every worker's /healthz so the router can tell tiers
            # apart ("prefill" / "decode" / None for a unified pool)
            "phase": phase,
        }
        self._ctx = _mp.get_context("spawn")
        self.workers: List[_Worker] = []
        self.router: Optional[ThinRouter] = None
        self._closed = False
        self._spawn_n = 0
        if start:
            self.start()

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- spawning ------------------------------------------------------------
    def _launch(self):
        """Start one worker process; ``_ready`` waits for its report."""
        from ..observability import propagate, tracing

        spec = dict(self._spec_base)
        # fleet identity + the spawner's ambient trace: a worker
        # spawned inside a rolling_restart span boots INSIDE that
        # trace (its traffic/worker_boot span parents there), and its
        # PADDLE_WORKER_ID labels every span it ever records
        phase = spec.get("phase")
        spec["worker_id"] = (f"{phase}-{self._spawn_n}" if phase
                             else f"worker-{self._spawn_n}")
        self._spawn_n += 1
        spec["trace_env"] = propagate.to_env(tracing.current())
        if self.use_reuseport:
            spec["port"] = self.port
            spec["reuse_port"] = True
        else:
            spec["port"] = _free_port(self.host)
            spec["reuse_port"] = False
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_worker_main, args=(spec, child_conn),
            name="pt-traffic-worker", daemon=True)
        proc.start()
        child_conn.close()
        return proc, parent_conn, spec["port"]

    def _ready(self, proc, parent_conn, port: int) -> _Worker:
        if not parent_conn.poll(self.ready_timeout_s):
            proc.terminate()
            raise TimeoutError(
                f"worker did not report ready in {self.ready_timeout_s}s")
        kind, info = parent_conn.recv()
        if kind != "ready":
            proc.join(5)
            raise RuntimeError(f"worker failed to start: {info}")
        return _Worker(proc, parent_conn, port, info)

    def _spawn(self) -> _Worker:
        return self._ready(*self._launch())

    def start(self) -> "WorkerPool":
        if self.workers:
            return self
        # the first workers boot side by side (each its own interpreter
        # and CUDA context); a rolling restart replaces one at a time
        launched = [self._launch() for _ in range(self.num_workers)]
        self.workers = [self._ready(*w) for w in launched]
        if not self.use_reuseport:
            self.router = ThinRouter(
                self.host, self.port,
                [(self.host, w.port) for w in self.workers])
        return self

    # -- fleet observability ---------------------------------------------------
    def stamp_trace(self, ctx=None) -> List[Optional[str]]:
        """Push a trace context (default: the caller's ambient span)
        into every live worker's ``PADDLE_TRACE_*`` environment over
        the control pipe; returns each worker's acked trace id (None
        for a worker that did not answer)."""
        from ..observability import propagate, tracing

        env = propagate.to_env(
            ctx if ctx is not None else tracing.current())
        out: List[Optional[str]] = []
        for w in self.workers:
            try:
                w.conn.send(("trace", env))
                if w.conn.poll(5.0):
                    kind, tid = w.conn.recv()
                    out.append(tid if kind == "traced" else None)
                else:
                    out.append(None)
            except (BrokenPipeError, EOFError, OSError):
                out.append(None)
        return out

    def metrics_endpoints(self) -> List[Dict[str, Any]]:
        """The FleetAggregator discovery hook
        (``aggregator.watch_pool(pool)``): one scrape endpoint per
        worker, labeled with its worker id and the pool's phase. Under
        SO_REUSEPORT all workers share ONE front address (the kernel
        picks a listener per scrape connection), so the pool exposes a
        single shared endpoint; router mode exposes each worker's own
        port."""
        phase = self._spec_base.get("phase")
        if self.use_reuseport:
            ep: Dict[str, Any] = {
                "url": f"http://{self.host}:{self.port}", "worker": "pool"}
            if phase:
                ep["phase"] = phase
            return [ep]
        out = []
        for w in self.workers:
            wid = (w.info or {}).get("worker_id") or f"worker-{w.port}"
            ep = {"url": f"http://{self.host}:{w.port}", "worker": wid}
            if phase:
                ep["phase"] = phase
            out.append(ep)
        return out

    # -- drain + restart ------------------------------------------------------
    def _drain(self, worker: _Worker,
               timeout: float = 60.0) -> Dict[str, Any]:
        if self.router is not None:
            # router mode: route-away FIRST, so no new connection can
            # land on the draining worker
            self.router.set_backends(
                [(self.host, w.port) for w in self.workers
                 if w is not worker])
        try:
            worker.conn.send(("drain", None))
        except (BrokenPipeError, OSError):
            pass
        stats: Dict[str, Any] = {}
        if worker.conn.poll(timeout):
            try:
                kind, stats = worker.conn.recv()
            except (EOFError, OSError):
                stats = {}
        worker.proc.join(timeout)
        if worker.proc.is_alive():
            worker.proc.terminate()
            worker.proc.join(5)
            stats["forced"] = True
        return stats

    def rolling_restart(self) -> Dict[str, Any]:
        """Replace every worker, one at a time: spawn replacement ->
        replacement warm + listening -> drain old -> old exits. The
        port never goes unserved; the report carries each generation's
        warmup_ms so warm start is checkable
        (``replacements[i]["warmup_ms"]`` vs ``cold[i]``)."""
        report: Dict[str, Any] = {"cold": [w.info for w in self.workers],
                                  "replacements": [], "drained": []}
        for i in range(len(self.workers)):
            old = self.workers[i]
            new = self._spawn()
            self.workers[i] = new
            if self.router is not None:
                self.router.set_backends(
                    [(self.host, w.port) for w in self.workers])
            drained = self._drain(old)
            report["replacements"].append(new.info)
            report["drained"].append(drained)
        return report

    def close(self, timeout: float = 60.0) -> None:
        if self._closed:
            return
        self._closed = True
        if self.router is not None:
            self.router.close()
        for w in self.workers:
            self._drain(w, timeout=timeout)
        self.workers = []
