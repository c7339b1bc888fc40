"""Wire protocol: length-prefixed pickled messages over TCP, byte for
byte the JAX package's ``paddle_tpu/ps/protocol.py`` (a copy: the port
imports nothing of that package), so a port client and a JAX server,
or the other way round, talk to each other.

Verbs mirror reference send_recv.proto:19-34 (SendVariable,
GetVariable, Prefetch, Barrier, CheckpointNotify) plus Shutdown. A
message is an 8-byte big-endian header length, a pickle (protocol 4)
of the non-array fields and each array's (dtype, shape), then each
array's raw buffer behind its own 8-byte length, in sorted key order.
"""

from __future__ import annotations

import pickle
import socket
import struct
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

_HDR = struct.Struct("!Q")

# verbs
SEND_GRAD = "send_grad"
GET_PARAM = "get_param"
BARRIER = "barrier"
CHECKPOINT = "checkpoint"
SHUTDOWN = "shutdown"
PREFETCH = "prefetch"  # sparse row lookup
PUSH_SPARSE = "push_sparse"


def _encode(msg: Dict[str, Any]) -> bytes:
    arrays = {}
    clean = {}
    for k, v in msg.items():
        if isinstance(v, np.ndarray):
            arrays[k] = v
        else:
            clean[k] = v
    header = pickle.dumps(
        {
            "msg": clean,
            "arrays": {
                k: (str(a.dtype), a.shape) for k, a in arrays.items()
            },
        },
        protocol=4,
    )
    parts = [_HDR.pack(len(header)), header]
    for k in sorted(arrays):
        buf = np.ascontiguousarray(arrays[k]).tobytes()
        parts.append(_HDR.pack(len(buf)))
        parts.append(buf)
    return b"".join(parts)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _decode(sock: socket.socket) -> Dict[str, Any]:
    (hlen,) = _HDR.unpack(_read_exact(sock, _HDR.size))
    meta = pickle.loads(_read_exact(sock, hlen))
    msg = dict(meta["msg"])
    for k in sorted(meta["arrays"]):
        dtype, shape = meta["arrays"][k]
        (blen,) = _HDR.unpack(_read_exact(sock, _HDR.size))
        buf = _read_exact(sock, blen)
        msg[k] = np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
    return msg


def send_msg(sock: socket.socket, msg: Dict[str, Any]):
    sock.sendall(_encode(msg))


def recv_msg(sock: socket.socket) -> Dict[str, Any]:
    return _decode(sock)


def request(addr: Tuple[str, int], msg: Dict[str, Any], retries: int = 5,
            backoff: float = 0.2, timeout: float = 60.0) -> Dict[str, Any]:
    """One request/response with bounded reconnect-and-backoff
    (reference grpc_client.cc retries through its completion queue).
    Connection-per-request makes a retry a
    clean resend; like the reference this is at-least-once — a reply
    lost AFTER the server applied a send_grad re-applies it, the same
    async-SGD noise the PS design already tolerates."""
    last: Optional[Exception] = None
    for attempt in range(retries + 1):
        try:
            with socket.create_connection(addr, timeout=timeout) as s:
                send_msg(s, msg)
                return recv_msg(s)
        except (ConnectionError, socket.timeout, OSError) as e:
            last = e
            if attempt < retries:
                time.sleep(backoff * (2 ** attempt))
    raise ConnectionError(
        f"PS request to {addr} failed after {retries + 1} attempts: {last!r}")
