"""Parameter server: holds param shards, applies updates (the port's
copy of ``paddle_tpu/ps/server.py``: host numpy, no device).

Reference: operators/distributed_ops/listen_and_serv_op.cc (event loop,
RunSyncLoop barrier semantics / RunAsyncLoop per-grad), request
handlers (distributed/request_handler_impl.cc), heartbeat monitor
(distributed/heart_beat_monitor.h:54).

Implementation: a threaded TCP server. Each shard var has an update
rule from its optimizer op spec (SGD, Adam, Momentum, Adagrad; dense,
or lazy over the rows a sparse push names), in numpy on the host, as
pservers are CPU machines in the reference too. Adam keeps its beta
powers per shard. Sync mode: grads accumulate per barrier round and the
update applies when all trainers reported. A heartbeat monitor flags
trainers silent for > 2x the expected interval (reference behavior).
"""

from __future__ import annotations

import threading
import time
import socketserver
from collections import deque
from typing import Any, Dict, Optional, Tuple

import numpy as np

from . import protocol as P


class _ShardState:
    def __init__(self, name: str, value: np.ndarray, optimizer_spec: Dict[str, Any]):
        self.name = name
        self.value = value.astype(np.float32)
        self.spec = optimizer_spec
        self.state: Dict[str, np.ndarray] = {}
        # sync rounds: trainer_id -> pending grad (dict keying makes
        # client retries idempotent)
        self.pending: Dict[int, Any] = {}

    def _acc(self, key: str) -> np.ndarray:
        """The shard's accumulator ``key``, zeros of the value's shape the
        first time (made once: a table shard's moments are hundreds of
        MB, which ``setdefault``'s default would fill on every update)."""
        acc = self.state.get(key)
        if acc is None:
            acc = self.state[key] = np.zeros_like(self.value)
        return acc

    def apply(self, grad: np.ndarray):
        kind = self.spec.get("type", "sgd")
        lr = float(self.spec.get("lr", 0.01))
        if kind == "sgd":
            self.value -= lr * grad
        elif kind == "adam":
            beta1 = self.spec.get("beta1", 0.9)
            beta2 = self.spec.get("beta2", 0.999)
            eps = self.spec.get("epsilon", 1e-8)
            m1 = self._acc("m1")
            m2 = self._acc("m2")
            b1p = self.state.setdefault("b1p", np.array(beta1, np.float64))
            b2p = self.state.setdefault("b2p", np.array(beta2, np.float64))
            m1[:] = beta1 * m1 + (1 - beta1) * grad
            m2[:] = beta2 * m2 + (1 - beta2) * grad * grad
            lr_t = lr * np.sqrt(1 - b2p) / (1 - b1p)
            self.value -= (lr_t * m1 / (np.sqrt(m2) + eps)).astype(np.float32)
            self.state["b1p"] = b1p * beta1
            self.state["b2p"] = b2p * beta2
        elif kind == "momentum":
            mu = self.spec.get("mu", 0.9)
            v = self._acc("v")
            v[:] = mu * v + grad
            self.value -= lr * v
        elif kind == "adagrad":
            eps = self.spec.get("epsilon", 1e-6)
            acc = self._acc("acc")
            acc += grad * grad
            self.value -= lr * grad / (np.sqrt(acc) + eps)
        else:
            raise NotImplementedError(f"pserver optimizer {kind!r}")

    def apply_sparse(self, rows: np.ndarray, grad: np.ndarray):
        """Row-sliced update (reference sparse optimizer kernels,
        operators/optimizers/*_op.cc SelectedRows specializations; adam
        uses lazy_mode semantics — untouched rows' moments stay put)."""
        kind = self.spec.get("type", "sgd")
        lr = float(self.spec.get("lr", 0.01))
        # dedup rows so stateful updates see each row once (rows a
        # trainer already merged are unique: no scatter-add needed)
        uniq, first, inv = np.unique(rows, return_index=True,
                                     return_inverse=True)
        if len(uniq) == len(rows):
            merged = grad[first]
        else:
            merged = np.zeros((len(uniq),) + grad.shape[1:], grad.dtype)
            np.add.at(merged, inv, grad)
        if kind == "sgd":
            self.value[uniq] -= lr * merged
        elif kind == "adam":
            beta1 = self.spec.get("beta1", 0.9)
            beta2 = self.spec.get("beta2", 0.999)
            eps = self.spec.get("epsilon", 1e-8)
            m1 = self._acc("m1")
            m2 = self._acc("m2")
            b1p = self.state.setdefault("b1p", np.array(beta1, np.float64))
            b2p = self.state.setdefault("b2p", np.array(beta2, np.float64))
            m1[uniq] = beta1 * m1[uniq] + (1 - beta1) * merged
            m2[uniq] = beta2 * m2[uniq] + (1 - beta2) * merged * merged
            lr_t = lr * np.sqrt(1 - b2p) / (1 - b1p)
            self.value[uniq] -= (lr_t * m1[uniq] / (np.sqrt(m2[uniq]) + eps)).astype(
                np.float32
            )
            self.state["b1p"] = b1p * beta1
            self.state["b2p"] = b2p * beta2
        elif kind == "momentum":
            mu = self.spec.get("mu", 0.9)
            v = self._acc("v")
            v[uniq] = mu * v[uniq] + merged
            self.value[uniq] -= lr * v[uniq]
        elif kind == "adagrad":
            eps = self.spec.get("epsilon", 1e-6)
            acc = self._acc("acc")
            acc[uniq] += merged * merged
            self.value[uniq] -= lr * merged / (np.sqrt(acc[uniq]) + eps)
        else:
            raise NotImplementedError(f"pserver sparse optimizer {kind!r}")


class ParameterServer:
    def __init__(self, endpoint: str, shards: Dict[str, np.ndarray],
                 optimizer_specs: Dict[str, Dict[str, Any]], trainers: int = 1,
                 sync_mode: bool = True):
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self._shards = {
            name: _ShardState(name, val, optimizer_specs.get(name, {"type": "sgd"}))
            for name, val in shards.items()
        }
        self._trainers = trainers
        self._sync = sync_mode
        self._lock = threading.Lock()
        self._barrier_arrived: set = set()
        self._barrier_generation = 0
        self._barrier_cond = threading.Condition(self._lock)
        self._last_seen: Dict[int, float] = {}
        self._shutdown = threading.Event()
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._checkpoint_dir: Optional[str] = None
        # idempotency table for the sync-sensitive verbs (barrier /
        # send_grad / push_sparse): at-least-once retries mean a reply
        # lost AFTER a round completed resends the request into the
        # NEXT round — per-round tid-keying alone can't catch that
        # (the retry would register in, and possibly release, a round
        # the trainer never reached). Clients stamp each such request
        # with a unique seq; completed ok-responses are cached per
        # (trainer_id, seq) and replayed verbatim on a duplicate.
        self._idem: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self._idem_order: deque = deque()
        # own lock: _idem_put is called while holding _lock (the
        # barrier releases under _barrier_cond, which wraps _lock)
        self._idem_lock = threading.Lock()

    def _idem_get(self, msg):
        if "seq" not in msg:
            return None, None
        key = (int(msg.get("trainer_id", 0)), int(msg["seq"]))
        with self._idem_lock:
            return key, self._idem.get(key)

    def _idem_put(self, key, resp):
        # only successful responses are replayable; an error (e.g.
        # barrier timeout) must stay retryable
        if key is not None and resp.get("ok"):
            with self._idem_lock:
                if key not in self._idem:
                    self._idem[key] = resp
                    self._idem_order.append(key)
                    while len(self._idem_order) > 4096:
                        self._idem.pop(self._idem_order.popleft(), None)
        return resp

    # -- request handling -----------------------------------------------------
    def _handle(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        verb = msg["verb"]
        idem_key, cached = self._idem_get(msg)
        if cached is not None:
            return cached
        if verb == P.GET_PARAM:
            with self._lock:
                sh = self._shards[msg["name"]]
                # copy under the lock: serialization happens after the
                # lock is released and must not race in-place updates
                return {"ok": True, "value": sh.value.copy()}
        if verb == P.SEND_GRAD:
            tid = int(msg.get("trainer_id", 0))
            self._last_seen[tid] = time.time()
            name = msg["name"]
            grad = msg["grad"]
            with self._lock:
                sh = self._shards[name]
                if self._sync:
                    # keyed by trainer_id, not arrival-counted: a
                    # client RETRY (ps/protocol.py request backoff)
                    # replaces the same trainer's entry instead of
                    # double-counting it
                    sh.pending[tid] = grad
                    if len(sh.pending) >= self._trainers:
                        mean_grad = np.mean(list(sh.pending.values()),
                                            axis=0)
                        sh.apply(mean_grad)
                        sh.pending.clear()
                else:
                    sh.apply(grad)
            return self._idem_put(idem_key, {"ok": True})
        if verb == P.PREFETCH:
            # sparse row lookup (reference parameter_prefetch.cc)
            with self._lock:
                sh = self._shards[msg["name"]]
                rows = msg["rows"].astype(np.int64)
                return {"ok": True, "value": sh.value[rows]}
        if verb == P.PUSH_SPARSE:
            tid = int(msg.get("trainer_id", 0))
            self._last_seen[tid] = time.time()
            with self._lock:
                sh = self._shards[msg["name"]]
                rows = msg["rows"].astype(np.int64)
                grad = msg["grad"]
                if self._sync and self._trainers > 1:
                    # per-trainer (rows, grad) for the round, keyed by
                    # trainer_id so a client retry replaces rather than
                    # double-counts; apply once all trainers reported
                    # (mean semantics, matching the dense sync path)
                    sh.pending[tid] = (rows, grad / self._trainers)
                    if len(sh.pending) >= self._trainers:
                        all_rows = np.concatenate(
                            [r for r, _ in sh.pending.values()])
                        all_grads = np.concatenate(
                            [g for _, g in sh.pending.values()])
                        sh.apply_sparse(all_rows, all_grads)
                        sh.pending.clear()
                else:
                    sh.apply_sparse(rows, grad)
            return self._idem_put(idem_key, {"ok": True})
        if verb == P.BARRIER:
            tid = int(msg.get("trainer_id", 0))
            deadline = time.time() + 300.0
            with self._barrier_cond:
                # arrivals tracked per trainer_id: a retried barrier
                # request from the same trainer must not release the
                # round early (ps/protocol.py request backoff)
                self._barrier_arrived.add(tid)
                my_gen = self._barrier_generation
                if len(self._barrier_arrived) >= self._trainers:
                    self._barrier_arrived.clear()
                    self._barrier_generation += 1
                    self._barrier_cond.notify_all()
                    return self._idem_put(idem_key, {"ok": True})
                # wait on a generation predicate: spurious wakeups and
                # timeouts must not release the barrier early
                while self._barrier_generation == my_gen:
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        return {"ok": False, "error": "barrier timeout"}
                    self._barrier_cond.wait(timeout=remaining)
            return self._idem_put(idem_key, {"ok": True})
        if verb == P.CHECKPOINT:
            self.save(msg["dirname"])
            return {"ok": True}
        if verb == P.SHUTDOWN:
            self._shutdown.set()

            def _stop(server=self._server):
                server.shutdown()
                server.server_close()  # release the LISTEN socket — a
                # leaked listener makes later binds EADDRINUSE and
                # clients hang against the dead port

            threading.Thread(target=_stop, daemon=True).start()
            return {"ok": True}
        return {"ok": False, "error": f"unknown verb {verb}"}

    # -- checkpoint (reference checkpoint_notify_op.cc:28) --------------------
    def save(self, dirname: str):
        import os

        os.makedirs(dirname, exist_ok=True)
        with self._lock:
            np.savez(
                os.path.join(dirname, f"pserver_{self._addr[1]}.npz"),
                **{n: s.value for n, s in self._shards.items()},
            )

    # -- lifecycle ------------------------------------------------------------
    def serve_forever(self):
        ps = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    msg = P.recv_msg(self.request)
                    resp = ps._handle(msg)
                    P.send_msg(self.request, resp)
                except (ConnectionError, OSError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(self._addr, Handler)
        self._monitor = threading.Thread(target=self._heartbeat_loop, daemon=True)
        self._monitor.start()
        self._server.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        time.sleep(0.1)
        return t

    def _heartbeat_loop(self, interval: float = 10.0):
        # reference HeartBeatMonitor::LostWorkerMonitor (.cc:57): warn on
        # workers silent > 2x interval
        while not self._shutdown.wait(interval):
            now = time.time()
            for tid, ts in list(self._last_seen.items()):
                if now - ts > 2 * interval:
                    print(f"[pserver {self._addr}] trainer {tid} silent "
                          f"{now - ts:.0f}s (possible failure)")


def run_pserver(endpoint, shards, optimizer_specs, trainers=1, sync_mode=True):
    ps = ParameterServer(endpoint, shards, optimizer_specs, trainers, sync_mode)
    ps.serve_forever()
    return ps
