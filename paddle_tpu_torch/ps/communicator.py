"""Async communicator: background grad-send / param-recv threads (the
port's counterpart of ``paddle_tpu/ps/communicator.py``).

Reference: operators/distributed/communicator.h:176 (AsyncCommunicator
:237 — per-var send queues merged by batch, independent recv thread),
HalfAsync :299, Sync :365, GeoCommunicator :383 (delta sync every K
steps). python wrapper fluid/communicator.py.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict

import numpy as np

from .transpile import _host, put_param


class Communicator:
    def __init__(self, artifacts, scope, mode: str = "async",
                 send_queue_size: int = 20, merge_batch: int = 4,
                 geo_need_push_nums: int = 100):
        from .client import PSClient

        self.art = artifacts
        self.scope = scope
        self.mode = mode  # async | half_async | sync | geo
        self.client = PSClient(artifacts.endpoints)
        self._queues: Dict[str, "queue.Queue"] = {
            g: queue.Queue(maxsize=send_queue_size) for g in artifacts.grad_to_param
        }
        self._merge_batch = merge_batch
        self._running = False
        self._threads = []
        # per-var counters (reference GeoSgdCommunicator keeps per-var
        # push queues; a shared counter would starve some params)
        self._geo_counters: Dict[str, int] = {}
        self._geo_push_nums = geo_need_push_nums
        self._geo_anchor: Dict[str, np.ndarray] = {}

    # -- reference API: start/stop/send ---------------------------------------
    def start(self):
        self._running = True
        for gname in self._queues:
            t = threading.Thread(target=self._send_loop, args=(gname,), daemon=True)
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._recv_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self):
        """Stop the send and recv threads and wait for them."""
        self._running = False
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []

    def send(self, grad_name: str, value: np.ndarray):
        if self.mode == "geo":
            self._geo_send(grad_name)
            return
        try:
            self._queues[grad_name].put_nowait(np.asarray(value))
        except queue.Full:
            pass  # async mode drops when saturated (backpressure)

    # -- internals ------------------------------------------------------------
    def _send_loop(self, gname: str):
        pname = self.art.grad_to_param[gname]
        q = self._queues[gname]
        while self._running:
            try:
                first = q.get(timeout=0.2)
            except queue.Empty:
                continue
            merged = [first]
            while len(merged) < self._merge_batch:
                try:
                    merged.append(q.get_nowait())
                except queue.Empty:
                    break
            grad = np.mean(merged, axis=0) if len(merged) > 1 else merged[0]
            self.client.send_grad(self.art.shard_map, pname, grad)

    def _recv_loop(self, interval: float = 0.2):
        while self._running:
            for pname in self.art.shard_map:
                try:
                    fresh = self.client.get_param(self.art.shard_map, pname)
                    put_param(self.scope, pname, fresh)
                except ConnectionError:
                    pass
            time.sleep(interval)

    def _geo_send(self, gname: str):
        """Geo-SGD: every K local steps push the param DELTA since the
        last sync (reference GeoSgdCommunicator)."""
        pname = self.art.grad_to_param[gname]
        cnt = self._geo_counters.get(gname, 0) + 1
        self._geo_counters[gname] = cnt
        if cnt % self._geo_push_nums:
            return
        cur = _host(self.scope.find_var(pname))
        anchor = self._geo_anchor.get(pname)
        if anchor is not None:
            delta = anchor - cur  # pserver applies p -= lr*grad; lr=1 delta
            self.client.send_grad(self.art.shard_map, pname, delta)
            fresh = self.client.get_param(self.art.shard_map, pname)
            put_param(self.scope, pname, fresh)
            cur = fresh
        self._geo_anchor[pname] = np.array(cur, copy=True)
