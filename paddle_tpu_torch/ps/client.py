"""PS client: trainer-side send/recv (the port's copy of
``paddle_tpu/ps/client.py``; host numpy over ``protocol``).

Reference: operators/distributed/ RPCClient (grpc_client.cc async
completion queue), parameter_send.cc / parameter_recv.cc (split a
param's slices across endpoints and scatter/gather them).
"""

from __future__ import annotations

import concurrent.futures
import itertools
import socket
import time
from typing import Sequence, Tuple

import numpy as np

from . import protocol as P


def _addr(endpoint: str) -> Tuple[str, int]:
    h, p = endpoint.rsplit(":", 1)
    return (h, int(p))


def wait_server_ready(endpoints: Sequence[str], timeout: float = 120.0
                      ) -> None:
    """Block until every endpoint accepts a connection (reference
    transpiler/details wait_server_ready): a trainer started beside its
    pservers waits here rather than spending its request retries on a
    server still importing. Raises TimeoutError naming the silent
    endpoints."""
    deadline = time.time() + timeout
    waiting = list(endpoints)
    while waiting:
        still = []
        for ep in waiting:
            try:
                with socket.create_connection(_addr(ep), timeout=1.0):
                    pass
            except OSError:
                still.append(ep)
        waiting = still
        if waiting:
            if time.time() > deadline:
                raise TimeoutError(f"pservers not ready: {waiting}")
            time.sleep(0.1)


class PSClient:
    def __init__(self, endpoints: Sequence[str], trainer_id: int = 0):
        self.endpoints = list(endpoints)
        self.trainer_id = trainer_id
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(4, len(self.endpoints))
        )
        # unique per sync-sensitive REQUEST (not per step): the server
        # replays its cached response when a lost-reply retry resends a
        # (trainer_id, seq) it already completed — without this, a
        # retry landing after its barrier/grad round released would
        # register into the NEXT round and break the sync fence.
        # Seeded with time_ns so a RESTARTED trainer's fresh requests
        # can never collide with its previous incarnation's entries in
        # the server's TTL-less cache. itertools.count: atomic under
        # CPython, shared by pool threads
        self._seq = itertools.count(time.time_ns())
        # array bytes this client put on the wire and took off it (the
        # parameter server's traffic a step, read by a caller that
        # differences two snapshots)
        self.stats = {"bytes_pushed": 0, "bytes_pulled": 0}

    # shard_map: var name -> list of (endpoint, row_begin, row_end)
    def send_grad(self, shard_map, name: str, grad: np.ndarray):
        futs = []
        for ep, lo, hi in shard_map[name]:
            piece = grad[lo:hi]
            self.stats["bytes_pushed"] += piece.nbytes
            futs.append(
                self._pool.submit(
                    P.request,
                    _addr(ep),
                    {"verb": P.SEND_GRAD, "name": f"{name}@{lo}",
                     "grad": piece, "trainer_id": self.trainer_id,
                     "seq": next(self._seq)},
                )
            )
        for f in futs:
            resp = f.result()
            assert resp.get("ok"), resp

    def get_param(self, shard_map, name: str) -> np.ndarray:
        futs = [
            self._pool.submit(
                P.request, _addr(ep), {"verb": P.GET_PARAM, "name": f"{name}@{lo}"}
            )
            for ep, lo, hi in shard_map[name]
        ]
        pieces = [f.result()["value"] for f in futs]
        self.stats["bytes_pulled"] += sum(p.nbytes for p in pieces)
        return np.concatenate(pieces, axis=0) if len(pieces) > 1 else pieces[0]

    def prefetch_rows(self, shard_map, name: str, rows: np.ndarray) -> np.ndarray:
        """Sparse row fetch for distributed embedding lookup (reference
        parameter_prefetch.cc + distributed_lookup_table_op)."""
        segs = shard_map[name]
        out = None
        for ep, lo, hi in segs:
            mask = (rows >= lo) & (rows < hi)
            if not mask.any():
                continue
            local = rows[mask] - lo
            resp = P.request(
                _addr(ep), {"verb": P.PREFETCH, "name": f"{name}@{lo}", "rows": local}
            )
            vals = resp["value"]
            self.stats["bytes_pushed"] += local.nbytes
            self.stats["bytes_pulled"] += vals.nbytes
            if out is None:
                out = np.zeros((rows.shape[0], vals.shape[1]), vals.dtype)
            out[mask] = vals
        return out

    def push_sparse(self, shard_map, name: str, rows: np.ndarray, grad: np.ndarray):
        for ep, lo, hi in shard_map[name]:
            mask = (rows >= lo) & (rows < hi)
            if not mask.any():
                continue
            self.stats["bytes_pushed"] += (rows[mask].nbytes
                                           + grad[mask].nbytes)
            P.request(
                _addr(ep),
                {"verb": P.PUSH_SPARSE, "name": f"{name}@{lo}",
                 "rows": rows[mask] - lo, "grad": grad[mask],
                 "trainer_id": self.trainer_id, "seq": next(self._seq)},
            )

    def close(self):
        """Release the request threads."""
        self._pool.shutdown(wait=True)

    def barrier(self):
        for ep in self.endpoints:
            resp = P.request(_addr(ep), {"verb": P.BARRIER, "trainer_id": self.trainer_id,
                                        "seq": next(self._seq)})
            if not resp.get("ok"):
                raise RuntimeError(f"barrier failed at {ep}: {resp.get('error')}")

    def checkpoint_notify(self, dirname: str):
        for ep in self.endpoints:
            P.request(_addr(ep), {"verb": P.CHECKPOINT, "dirname": dirname})

    def shutdown_servers(self):
        for ep in self.endpoints:
            try:
                # no retry: an already-gone server IS a shutdown
                P.request(_addr(ep), {"verb": P.SHUTDOWN}, retries=0)
            except ConnectionError:
                pass
