"""Host-RAM KV page store + the length-prefixed TCP wire between
prefill and decode workers (the counterpart of
``paddle_tpu/disagg/pagestore.py``).

The store is a trie of serialized PAGE RUNS keyed exactly like the
radix cache's trie (``PagedKVCache._page_key``): each edge is one full
page identified by the page_size-token tuple it holds. A prefill
worker ``put_run``s the finished pages of a prompt; a decode worker
``match``es its queued prompt and pulls back the longest stored
prefix, splices it into its own pool (``PagedKVCache.ingest_run``)
and resumes at ``lengths=matched`` — cross-engine prefix persistence
with the store as the rendezvous.

Wire encoding (``encode_page``/``decode_page``): the blockwise-int8
unit is ``block = head_dim`` — one fp32 scale per (head, token slot),
which is EXACTLY the int8 KV pool's scale-plane layout
(``kernels/quant.py``'s ``blockwise_quantize``, the one function both
the wire and the int8 pools quantize through; it divides by a tensor,
so the device and the host round alike). Consequences:

* int8 pool pages + their scale planes ship VERBATIM in both
  directions — the split topology is bit-identical to co-located
  int8 serving (the token-identity gate);
* fp32 pool pages quantize on encode at ``(hd + 4) / (4 * hd)`` of
  the fp32 bytes (0.281x at head_dim 32, 0.258x at 128: the <= 0.3x
  wire gate), with the round-trip error bounded by
  ``blockwise_error_bound``; ``encode_pages`` quantizes a whole
  exported run where it lies (on the card) and crosses to the host
  once;
* ``encoding="raw"`` ships fp32 pages untouched when bitwise fidelity
  matters more than bytes.

The TCP wire (``PageStoreServer`` / ``PageStoreClient``) is stdlib
socket + struct: every frame is ``!I`` length + JSON header + binary payload;
the client is a drop-in for ``HostPageStore`` (duck-typed put_run /
match / match_pages / stats), so engines and roles never care whether
the store is in-process or remote. ``discover_store`` resolves the
store endpoint from the coordinator env contract
(``PADDLE_PAGESTORE_ENDPOINT``, falling back to the first
``PADDLE_TRAINER_ENDPOINTS`` host + the ``disagg_store_port`` flag).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.quant import blockwise_dequantize, blockwise_quantize

__all__ = [
    "encode_page", "encode_pages", "decode_page", "run_for_pool",
    "fp32_page_bytes",
    "HostPageStore", "PageStoreServer", "PageStoreClient",
    "discover_store", "store_endpoint_from_env",
]

_HDR = struct.Struct("!I")


# -- page wire encoding ------------------------------------------------------

def fp32_page_bytes(num_layers: int, num_kv_heads: int, page_size: int,
                    head_dim: int) -> int:
    """fp32 bytes of one K+V page across layers — the denominator of
    the wire-bytes-vs-fp32 gauge/gate."""
    return 2 * num_layers * num_kv_heads * page_size * head_dim * 4


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    x = np.ascontiguousarray(x)
    # a decoded blob is a read-only view of its bytes
    return torch.from_numpy(x if x.flags.writeable else x.copy())


def _quantize_body(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 [..., hd] -> (int8 same shape, float32 scales [...]) with
    block = head_dim, where ``x`` lies: ``kernels/quant.py``'s
    ``blockwise_quantize``, the int8 pools' own rounding."""
    x = _tensor(x)
    shape = x.shape
    q, sc = blockwise_quantize(x.reshape(-1, shape[-1]).float())
    return q.reshape(shape), sc.reshape(shape[:-1])


def _dequantize_body(q, sc) -> np.ndarray:
    q, sc = _tensor(q), _tensor(sc).float()
    shape = q.shape
    out = blockwise_dequantize(q.reshape(-1, shape[-1]), sc.reshape(-1))
    return out.reshape(shape).numpy()


def _host(x) -> np.ndarray:
    return (x.cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def _wire_form(k, v, k_scales, v_scales, encoding: str):
    """(enc, kq, vq, ks, vs) of a run, as tensors where the inputs lie
    (the scale planes empty for ``raw``)."""
    k, v = _tensor(k), _tensor(v)
    if k.dtype == torch.int8:
        if k_scales is None or v_scales is None:
            raise ValueError("encode_page: int8 pages need scale planes")
        return ("int8_block", k, v, _tensor(k_scales).float(),
                _tensor(v_scales).float())
    if encoding == "raw":
        empty = torch.zeros(0, dtype=torch.float32)
        return "raw", k.float(), v.float(), empty, empty
    if encoding == "int8_block":
        kq, ks = _quantize_body(k)
        vq, vs = _quantize_body(v)
        return "int8_block", kq, vq, ks, vs
    raise ValueError(f"unknown wire encoding {encoding!r}")


def encode_page(k, v, k_scales=None, v_scales=None, *,
                encoding: str = "int8_block") -> bytes:
    """Serialize ONE page (k/v ``[L, KVH, ps, hd]``, pool dtype, numpy
    or tensors) into a self-describing blob. int8 inputs (+ scale
    planes ``[L, KVH, ps]``) ship verbatim regardless of ``encoding``;
    float32 inputs quantize blockwise (``int8_block``) or ship raw
    (``raw``)."""
    def one(x):
        return None if x is None else _tensor(x)[None]

    return encode_pages(one(k), one(v), one(k_scales), one(v_scales),
                        encoding=encoding)[0]


def encode_pages(k_run, v_run, k_scales=None, v_scales=None, *,
                 encoding: str = "int8_block") -> List[bytes]:
    """``encode_page`` over a run (``[n, L, KVH, ps, hd]``, as
    ``PagedKVCache.export_run`` gives it): the run is encoded where it
    lies (quantized on the card for ``int8_block``) and copied to the
    host once; the blobs equal ``encode_page``'s page by page."""
    enc, *arrs = _wire_form(k_run, v_run, k_scales, v_scales, encoding)
    kq, vq, ks, vs = (_host(a) for a in arrs)
    L, kvh, ps, hd = (int(d) for d in kq.shape[1:])
    out = []
    for i in range(kq.shape[0]):
        parts = [np.ascontiguousarray(a[i]).tobytes() for a in (kq, vq)]
        parts += ([b"", b""] if enc == "raw" else
                  [np.ascontiguousarray(a[i]).tobytes() for a in (ks, vs)])
        head = json.dumps({
            "enc": enc, "L": L, "kvh": kvh, "ps": ps, "hd": hd,
            "sizes": [len(p) for p in parts],
        }).encode("utf-8")
        out.append(b"".join([_HDR.pack(len(head)), head] + parts))
    return out


def decode_page(blob: bytes) -> Dict[str, Any]:
    """Inverse of ``encode_page``: blob -> dict with ``enc``, dims and
    the k/v (+ scale) arrays in their WIRE dtype."""
    (hlen,) = _HDR.unpack_from(blob, 0)
    head = json.loads(blob[_HDR.size:_HDR.size + hlen].decode("utf-8"))
    L, kvh, ps, hd = head["L"], head["kvh"], head["ps"], head["hd"]
    off = _HDR.size + hlen
    parts = []
    for n in head["sizes"]:
        parts.append(blob[off:off + n])
        off += n
    body = (L, kvh, ps, hd)
    if head["enc"] == "raw":
        k = np.frombuffer(parts[0], np.float32).reshape(body)
        v = np.frombuffer(parts[1], np.float32).reshape(body)
        ks = vs = None
    else:
        k = np.frombuffer(parts[0], np.int8).reshape(body)
        v = np.frombuffer(parts[1], np.int8).reshape(body)
        ks = np.frombuffer(parts[2], np.float32).reshape(body[:3])
        vs = np.frombuffer(parts[3], np.float32).reshape(body[:3])
    return {"enc": head["enc"], "L": L, "kvh": kvh, "ps": ps, "hd": hd,
            "k": k, "v": v, "k_scales": ks, "v_scales": vs}


def run_for_pool(blobs: List[bytes], pool_dtype: str):
    """Decode a matched run of page blobs into the arrays
    ``PagedKVCache.ingest_run`` wants for a pool of ``pool_dtype``:
    ``(n, k_run, v_run, k_scales, v_scales)``. int8 blobs splice into
    int8 pools verbatim (bit-identical handoff); the mixed cases
    convert through the blockwise codec (raw->int8 quantizes,
    int8->fp32 dequantizes — bounded, not bitwise)."""
    if not blobs:
        return 0, None, None, None, None
    int8_pool = np.dtype(pool_dtype) == np.int8
    pages = [decode_page(b) for b in blobs]
    ks, vs, ksc, vsc = [], [], [], []
    for pg in pages:
        if int8_pool:
            if pg["enc"] == "raw":
                kq, kb = (t.numpy() for t in _quantize_body(pg["k"]))
                vq, vb = (t.numpy() for t in _quantize_body(pg["v"]))
            else:
                kq, kb = pg["k"], pg["k_scales"]
                vq, vb = pg["v"], pg["v_scales"]
            ks.append(kq), vs.append(vq), ksc.append(kb), vsc.append(vb)
        else:
            if pg["enc"] == "raw":
                ks.append(pg["k"]), vs.append(pg["v"])
            else:
                ks.append(_dequantize_body(pg["k"], pg["k_scales"]))
                vs.append(_dequantize_body(pg["v"], pg["v_scales"]))
    k_run = np.stack(ks)
    v_run = np.stack(vs)
    if int8_pool:
        return len(pages), k_run, v_run, np.stack(ksc), np.stack(vsc)
    return len(pages), k_run, v_run, None, None


# -- the host-RAM store ------------------------------------------------------

class _StoreNode:
    __slots__ = ("key", "blob", "parent", "children", "last_used")

    def __init__(self, key, blob, parent):
        self.key = key
        self.blob = blob
        self.parent = parent
        self.children: Dict[tuple, "_StoreNode"] = {}
        self.last_used = 0


class HostPageStore:
    """The in-process store: a trie of page blobs keyed by exact
    page_size-token tuples, LRU-leaf-evicted against ``max_bytes``.
    Thread-safe; also the backing object behind ``PageStoreServer``."""

    def __init__(self, page_size: int, *, max_bytes: int = 0):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = int(page_size)
        self.max_bytes = max(0, int(max_bytes))
        self._lock = threading.Lock()
        self._root = _StoreNode(None, None, None)
        self._tick = 0
        self._pages = 0
        self._bytes = 0
        # counters behind the paddle_disagg_* store gauges
        self.put_runs_total = 0
        self.put_pages_total = 0
        self.dup_pages_total = 0
        self.lookups_total = 0
        self.hits_total = 0
        self.served_pages_total = 0
        self.evictions_total = 0
        self.wire_bytes_total = 0       # actual blob bytes accepted
        self.fp32_bytes_total = 0       # what the same pages cost in fp32
        self.served_wire_bytes_total = 0
        from ..observability import watch_disagg

        watch_disagg(self)

    def _keys(self, tokens) -> List[tuple]:
        toks = np.asarray(tokens).reshape(-1)
        ps = self.page_size
        return [tuple(int(t) for t in toks[i * ps:(i + 1) * ps])
                for i in range(int(toks.size) // ps)]

    def _touch(self, node: _StoreNode) -> None:
        self._tick += 1
        node.last_used = self._tick

    def _evict_lru_leaf_locked(self) -> bool:
        best: Optional[_StoreNode] = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.children:
                    stack.append(child)
                elif best is None or child.last_used < best.last_used:
                    best = child
        if best is None:
            return False
        del best.parent.children[best.key]
        self._pages -= 1
        self._bytes -= len(best.blob)
        self.evictions_total += 1
        return True

    def put_run(self, tokens, blobs: List[bytes]) -> int:
        """Store ``blobs`` (one encoded page each) along ``tokens``'
        page-aligned path; pages already present are touched, not
        rewritten (the first publisher wins, like the radix trie).
        Returns newly stored pages."""
        keys = self._keys(tokens)
        with self._lock:
            node = self._root
            new = 0
            for key, blob in zip(keys, blobs):
                child = node.children.get(key)
                if child is None:
                    child = _StoreNode(key, bytes(blob), node)
                    node.children[key] = child
                    self._pages += 1
                    self._bytes += len(blob)
                    self.wire_bytes_total += len(blob)
                    try:
                        hd = decode_page(blob)
                        self.fp32_bytes_total += fp32_page_bytes(
                            hd["L"], hd["kvh"], hd["ps"], hd["hd"])
                    except Exception:
                        pass
                    new += 1
                else:
                    self.dup_pages_total += 1
                self._touch(child)
                node = child
            self.put_runs_total += 1
            self.put_pages_total += new
            while (self.max_bytes and self._bytes > self.max_bytes
                   and self._evict_lru_leaf_locked()):
                pass
            return new

    def match_pages(self, tokens) -> int:
        """Pure peek: pages the store would serve for this prompt.
        No counters, no LRU touch — the traffic tier's pricing probe."""
        keys = self._keys(tokens)
        with self._lock:
            node, n = self._root, 0
            for key in keys:
                node = node.children.get(key)
                if node is None:
                    break
                n += 1
            return n

    def match(self, tokens, max_pages: int = 0) -> List[bytes]:
        """Longest stored page run along ``tokens``; returns the blobs
        in order (empty list = miss)."""
        keys = self._keys(tokens)
        if max_pages:
            keys = keys[:max_pages]
        with self._lock:
            self.lookups_total += 1
            node = self._root
            out: List[bytes] = []
            for key in keys:
                child = node.children.get(key)
                if child is None:
                    break
                self._touch(child)
                out.append(child.blob)
                node = child
            if out:
                self.hits_total += 1
                self.served_pages_total += len(out)
                self.served_wire_bytes_total += sum(len(b) for b in out)
            return out

    def clear(self) -> None:
        with self._lock:
            self._root.children.clear()
            self._pages = 0
            self._bytes = 0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lk = self.lookups_total
            fp = self.fp32_bytes_total
            return {
                "pages": self._pages,
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "put_runs_total": self.put_runs_total,
                "put_pages_total": self.put_pages_total,
                "dup_pages_total": self.dup_pages_total,
                "lookups_total": lk,
                "hits_total": self.hits_total,
                "hit_rate": round(self.hits_total / lk, 4) if lk else 0.0,
                "served_pages_total": self.served_pages_total,
                "served_wire_bytes_total": self.served_wire_bytes_total,
                "evictions_total": self.evictions_total,
                "wire_bytes_total": self.wire_bytes_total,
                "fp32_bytes_total": fp,
                "wire_ratio": (round(self.wire_bytes_total / fp, 4)
                               if fp else 0.0),
            }

    def stats_numeric(self) -> Dict[str, Any]:
        return self.stats()


# -- the TCP wire ------------------------------------------------------------

def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("page store peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def _send_frame(conn: socket.socket, head: Dict[str, Any],
                payload: bytes = b"") -> None:
    hb = json.dumps(head).encode("utf-8")
    conn.sendall(_HDR.pack(len(hb) + len(payload) + _HDR.size)
                 + _HDR.pack(len(hb)) + hb + payload)


def _recv_frame(conn: socket.socket) -> Tuple[Dict[str, Any], bytes]:
    (total,) = _HDR.unpack(_recv_exact(conn, _HDR.size))
    body = _recv_exact(conn, total)
    (hlen,) = _HDR.unpack_from(body, 0)
    head = json.loads(body[_HDR.size:_HDR.size + hlen].decode("utf-8"))
    return head, body[_HDR.size + hlen:]


class PageStoreServer:
    """Serve a ``HostPageStore`` over the length-prefixed TCP wire.
    One thread per connection (workers hold one connection each);
    ops: put / match / probe / stats / clear."""

    def __init__(self, store: Optional[HostPageStore] = None, *,
                 page_size: int = 0, host: str = "127.0.0.1",
                 port: int = 0, max_bytes: int = 0, start: bool = True):
        if store is None:
            if page_size < 1:
                raise ValueError("PageStoreServer needs a store or a "
                                 "page_size")
            store = HostPageStore(page_size, max_bytes=max_bytes)
        self.store = store
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(32)
        self.host, self.port = self._sock.getsockname()[:2]
        self._closed = False
        self._conns: List[socket.socket] = []
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="pagestore-accept",
                                        daemon=True)
        if start:
            self._thread.start()

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             name="pagestore-conn", daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        from ..observability import propagate, tracing

        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._closed:
                head, payload = _recv_frame(conn)
                # the caller's trace context rides the frame head
                # ("trace": traceparent, stamped by PageStoreClient) —
                # the RPC's span joins the caller's trace across the
                # TCP hop instead of starting an orphan root
                ctx = propagate.parse_traceparent(head.pop("trace", None))
                try:
                    with tracing.attach(ctx), \
                         tracing.span(
                             f"pagestore/{head.get('op', 'unknown')}",
                             {"payload_bytes": len(payload)}):
                        self._dispatch(conn, head, payload)
                except Exception as exc:   # noqa: BLE001 — wire-reported
                    _send_frame(conn, {"ok": 0, "error": str(exc)})
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, conn, head, payload) -> None:
        op = head.get("op")
        if op == "put":
            blobs, off = [], 0
            for n in head["sizes"]:
                blobs.append(payload[off:off + n])
                off += n
            new = self.store.put_run(head["tokens"], blobs)
            _send_frame(conn, {"ok": 1, "new": new})
        elif op == "match":
            blobs = self.store.match(head["tokens"],
                                     int(head.get("max_pages", 0)))
            _send_frame(conn, {"ok": 1, "sizes": [len(b) for b in blobs]},
                        b"".join(blobs))
        elif op == "probe":
            _send_frame(conn, {"ok": 1,
                               "pages": self.store.match_pages(
                                   head["tokens"])})
        elif op == "stats":
            _send_frame(conn, {"ok": 1, "stats": self.store.stats()})
        elif op == "clear":
            self.store.clear()
            _send_frame(conn, {"ok": 1})
        else:
            _send_frame(conn, {"ok": 0, "error": f"unknown op {op!r}"})

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)


class PageStoreClient:
    """One persistent connection to a ``PageStoreServer`` — the same
    duck surface as ``HostPageStore`` (put_run / match / match_pages /
    stats / clear), plus client-side wire-byte counters so a worker's
    gauges report ITS traffic, not the whole store's."""

    def __init__(self, host: str, port: int, *, timeout_s: float = 5.0,
                 page_size: int = 0):
        self.host, self.port = host, int(port)
        self.page_size = int(page_size)
        self._timeout = float(timeout_s)
        self._lock = threading.Lock()
        self._conn: Optional[socket.socket] = None
        self.bytes_sent_total = 0
        self.bytes_received_total = 0
        self.rpc_errors_total = 0
        from ..observability import watch_disagg

        watch_disagg(self)

    def _ensure_conn(self) -> socket.socket:
        if self._conn is None:
            conn = socket.create_connection((self.host, self.port),
                                            timeout=self._timeout)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conn = conn
        return self._conn

    def _rpc(self, head: Dict[str, Any],
             payload: bytes = b"") -> Tuple[Dict[str, Any], bytes]:
        from ..observability import propagate

        tp = propagate.current_traceparent()
        if tp is not None:
            # propagate the ambient trace over the wire: the server
            # side attaches it, so its pagestore/<op> span parents
            # under the prefill/decode worker's span
            head.setdefault("trace", tp)
        with self._lock:
            try:
                conn = self._ensure_conn()
                _send_frame(conn, head, payload)
                self.bytes_sent_total += len(payload)
                resp, body = _recv_frame(conn)
                self.bytes_received_total += len(body)
            except (ConnectionError, OSError):
                self.rpc_errors_total += 1
                if self._conn is not None:
                    try:
                        self._conn.close()
                    except OSError:
                        pass
                    self._conn = None
                raise
        if not resp.get("ok"):
            raise RuntimeError(
                f"page store error: {resp.get('error', 'unknown')}")
        return resp, body

    @staticmethod
    def _token_list(tokens) -> List[int]:
        return [int(t) for t in np.asarray(tokens).reshape(-1)]

    def put_run(self, tokens, blobs: List[bytes]) -> int:
        resp, _ = self._rpc({"op": "put",
                             "tokens": self._token_list(tokens),
                             "sizes": [len(b) for b in blobs]},
                            b"".join(blobs))
        return int(resp["new"])

    def match(self, tokens, max_pages: int = 0) -> List[bytes]:
        resp, body = self._rpc({"op": "match",
                                "tokens": self._token_list(tokens),
                                "max_pages": int(max_pages)})
        blobs, off = [], 0
        for n in resp["sizes"]:
            blobs.append(body[off:off + n])
            off += n
        return blobs

    def match_pages(self, tokens) -> int:
        resp, _ = self._rpc({"op": "probe",
                             "tokens": self._token_list(tokens)})
        return int(resp["pages"])

    def stats(self) -> Dict[str, Any]:
        resp, _ = self._rpc({"op": "stats"})
        return resp["stats"]

    def clear(self) -> None:
        self._rpc({"op": "clear"})

    def stats_numeric(self) -> Dict[str, Any]:
        return {
            "client_bytes_sent_total": self.bytes_sent_total,
            "client_bytes_received_total": self.bytes_received_total,
            "client_rpc_errors_total": self.rpc_errors_total,
        }

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = None


# -- discovery (coordinator env contract) ------------------------------------

def store_endpoint_from_env() -> Optional[str]:
    """Resolve the page store endpoint the way distributed workers
    resolve each other (distributed/coordinator.py env contract):
    ``PADDLE_PAGESTORE_ENDPOINT`` wins; otherwise the store is assumed
    co-located with trainer 0 (first ``PADDLE_TRAINER_ENDPOINTS``
    host) on the ``disagg_store_port`` flag; otherwise the
    ``disagg_store_endpoint`` flag."""
    ep = os.environ.get("PADDLE_PAGESTORE_ENDPOINT", "").strip()
    if ep:
        return ep
    peers = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").strip()
    if peers:
        from ..flags import flag

        host = peers.split(",")[0].rsplit(":", 1)[0]
        return f"{host}:{int(flag('disagg_store_port'))}"
    from ..flags import flag

    ep = str(flag("disagg_store_endpoint")).strip()
    return ep or None


def discover_store(*, page_size: int = 0,
                   timeout_s: Optional[float] = None
                   ) -> Optional[PageStoreClient]:
    """Connect to the env-discovered page store; None when the env
    names no store (co-located deployment — disagg stays off)."""
    ep = store_endpoint_from_env()
    if not ep:
        return None
    host, port = ep.rsplit(":", 1)
    if timeout_s is None:
        from ..flags import flag

        timeout_s = float(flag("disagg_fetch_timeout_s"))
    return PageStoreClient(host, int(port), timeout_s=timeout_s,
                           page_size=page_size)
