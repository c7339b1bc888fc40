"""HTTP front end over the ServingEngine and the GenerationEngine
(counterpart of ``paddle_tpu/serving/server.py``, :108-744), on the
standard library's ``http.server``:

    POST /v1/predict   {"inputs": {name: nested list} | [..],
                        "deadline_ms": n, "timeout_s": s}
                       -> 200 {"outputs": {name: nested list}}
                          400 malformed, 503 overloaded (Retry-After) or
                          closed, 504 deadline
    POST /v1/generate  {"tokens": [..], "max_new_tokens": n, "eos_id": id,
                        "deadline_ms": n, "stream": true,
                        "adapter" | "model": id}  (or an X-Adapter header)
                       -> 200 chunked application/x-ndjson, one
                          {"index": i, "token": t} line per token as it
                          is sampled, then {"done": true, "finish_reason",
                          "n_tokens", "usage"}; "stream": false answers
                          one JSON object. 404 without a GenerationEngine
                          or for an adapter that is not resident, 409 for
                          another adapter error, 400, 503 (Retry-After),
                          504.
    POST /v1/admin/adapters        {"adapter_id", "alpha", "tenant",
                        "factors": {target: {"a": [[..]], "b": [[..]]}}}
                        -> 200 {"uploaded": residency row}; 409 pinned,
                        429 over the tenant quota, 503 pool full.
    POST /v1/admin/adapters/evict  {"adapter_id", "force"}
                        -> 200 {"evicted": row}; 404 not resident, 409
                        pinned by live rows unless forced.
    GET  /healthz      -> 200 {"status": "ok", ...} while serving, 503
                          "draining" once the engine is closed; with a
                          GenerationEngine, its ``models_fragment()``.
    GET  /metrics      -> Prometheus text: this server's serving
                          metrics, the predictor bucket stats
                          (``paddle_serving_predictor_*``) and the
                          generation engine's numbers
                          (``paddle_serving_generation_*``).

Every request adopts the client's ``X-Request-Id`` (or mints one) and
echoes it in the reply's headers, in error bodies, and on the first and
last NDJSON lines of a stream. A streamed ``/v1/generate`` whose client
stops reading for ``traffic_stream_write_timeout_s`` seconds (or hangs
up) cancels its sequence, whose pages free at the next step.

Left out with the reference's host tiers (ROADMAP A9): the traffic
controller (``ServingServer(traffic=...)``) and its sheds, the fleet
exposition (``fleet=``, ``/metrics/fleet``), the disaggregated phase
(``phase=``), the trace and flight endpoints (``/v1/admin/trace/<id>``,
``/v1/admin/flight/dump``), trace-context propagation, the in-flight
count the rolling-restart drain waits on (``active_requests``) and the
unified process-wide ``/metrics`` registry. The constructor arguments raise
``NotImplementedError`` and the endpoints answer 501, naming A9.
"""

from __future__ import annotations

import json
import math
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from ..flags import flag
from .engine import DeadlineExceeded, EngineClosed, Overloaded, ServingEngine

__all__ = ["ServingServer"]

VERSION = "0.1.0"     # paddle_tpu/version.py full_version
REQUEST_ID_HEADER = "X-Request-Id"
_A9 = "ROADMAP queue A9 (host tiers: traffic, fleet observability, tracing)"


def new_request_id() -> str:
    """A fresh 22-hex-digit correlation id for a request that arrives
    without an ``X-Request-Id``."""
    return os.urandom(11).hex()


def _clamp_retry(s: float) -> float:
    return min(30.0, max(0.05, float(s)))


def engine_retry_after(engine) -> float:
    """Retry-After for a ServingEngine 503: the queued work over the
    engine's best-case drain rate (max_batch rows a median batch
    latency, across the worker pool). Coarse by design
    (``paddle_tpu/traffic/controller.py:83``)."""
    try:
        snap = engine.metrics.snapshot()
        depth = snap.get("queue_depth")
        if depth is None:
            depth = engine.queue_capacity
        lat_ms = snap["latency_ms"]["p50"] or 0.0
        per_batch_s = (lat_ms / 1e3) if lat_ms > 0 else 0.1
        bandwidth = engine.max_batch_size * engine.num_workers / per_batch_s
        return _clamp_retry((depth + 1) / max(bandwidth, 1e-6))
    except Exception:  # noqa: BLE001 — a 503 must never become a 500
        return 1.0


def generation_retry_after(gen_engine) -> float:
    """Retry-After for a GenerationEngine 503: the queued prompts over
    the admission rate (median TTFT per lane, :101 there)."""
    try:
        depth = gen_engine.queue_depth()
        snap = gen_engine.metrics.snapshot()
        ttft_ms = snap["ttft_ms"]["p50"] or 100.0
        lanes = max(1, int(getattr(gen_engine, "lanes", 1)))
        return _clamp_retry((depth + 1) * (ttft_ms / 1e3) / lanes)
    except Exception:  # noqa: BLE001 — a 503 must never become a 500
        return 1.0


def _retry_after_header(seconds: float) -> str:
    # whole seconds on the wire; the JSON body keeps the fraction
    return str(max(1, int(math.ceil(seconds))))


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def _flat_numbers(prefix: str, obj, out: Dict[str, Any]) -> None:
    """Nested dicts flattened into ``prefix_key_sub`` -> number."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flat_numbers(f"{prefix}_{k}", v, out)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[prefix] = obj


class _Handler(BaseHTTPRequestHandler):
    engine: ServingEngine = None  # set by the subclass ServingServer makes
    gen_engine = None             # generation.GenerationEngine (optional)
    started_at: float = 0.0
    stream_timeout_s: float = 0.0
    sndbuf: int = 0               # test hook: shrink SO_SNDBUF
    server_version = "paddle_tpu_torch_serving/1.0"
    protocol_version = "HTTP/1.1"
    _rid = None
    _body = b""

    # -- plumbing ------------------------------------------------------------
    def log_message(self, fmt, *args):  # noqa: A003 — quiet by default
        pass

    def setup(self):
        super().setup()
        if self.sndbuf:
            self.connection.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                       int(self.sndbuf))

    def _begin_request(self):
        self._rid = self.headers.get(REQUEST_ID_HEADER) or new_request_id()

    def _reply(self, code: int, body: bytes, ctype: str, headers=None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if self._rid:
            self.send_header(REQUEST_ID_HEADER, self._rid)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj, headers=None):
        if code >= 400 and isinstance(obj, dict) and self._rid:
            obj.setdefault("request_id", self._rid)
        self._reply(code, json.dumps(obj, default=_json_default).encode(),
                    "application/json", headers=headers)

    def _not_ported(self):
        self._reply_json(501, {"error": f"{self.path} is not ported to "
                                        f"paddle_tpu_torch yet: {_A9}",
                               "kind": "not_ported"})

    def _payload(self):
        payload = json.loads(self._body or b"{}")
        if not isinstance(payload, dict):
            raise ValueError("the request body must be a JSON object")
        return payload

    def _adapter(self, payload) -> Optional[str]:
        """The adapter a request names (header first, then ``adapter``
        or its alias ``model``); "", "base" or the engine's base version
        mean none."""
        adapter = (self.headers.get("X-Adapter") or payload.get("adapter")
                   or payload.get("model"))
        if adapter is not None:
            adapter = str(adapter)
            base = getattr(self.gen_engine, "model_version", "base")
            if adapter in ("", "base", base):
                adapter = None
        return adapter

    # -- endpoints -----------------------------------------------------------
    def do_GET(self):  # noqa: N802 — http.server contract
        self._begin_request()
        if self.path == "/healthz":
            draining = self.engine.closed
            body = {"status": "draining" if draining else "ok",
                    "uptime_s": round(time.monotonic() - self.started_at, 3),
                    "version": VERSION}
            gen = self.gen_engine
            if gen is not None and hasattr(gen, "models_fragment"):
                try:
                    body["models"] = gen.models_fragment()
                except Exception:  # noqa: BLE001 — a closing engine
                    pass
            self._reply_json(503 if draining else 200, body)
        elif self.path == "/metrics":
            extra: Dict[str, Any] = {}
            _flat_numbers("predictor", self.engine.predictor_stats_numeric(),
                          extra)
            if self.gen_engine is not None:
                _flat_numbers("generation", self.gen_engine.stats_numeric(),
                              extra)
            text = self.engine.metrics.to_prometheus_text(extra)
            self._reply(200, text.encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
        elif (self.path == "/metrics/fleet"
              or self.path.startswith("/v1/admin/trace/")):
            self._not_ported()
        else:
            self._reply_json(404, {"error": f"no such endpoint {self.path}"})

    def do_POST(self):  # noqa: N802
        self._begin_request()
        # the body is read whatever the answer, so that a keep-alive
        # connection's next request starts where this one ends
        try:
            self._body = self.rfile.read(
                int(self.headers.get("Content-Length") or 0))
        except ValueError:
            self._body = b""
            self.close_connection = True
        if self.path == "/v1/generate":
            self._generate()
        elif self.path == "/v1/predict":
            self._predict()
        elif self.path == "/v1/admin/adapters/evict":
            self._adapter_admin(evict=True)
        elif self.path == "/v1/admin/adapters":
            self._adapter_admin(evict=False)
        elif self.path == "/v1/admin/flight/dump":
            self._not_ported()
        else:
            self._reply_json(404, {"error": f"no such endpoint {self.path}"})

    def _predict(self):
        try:
            payload = self._payload()
            inputs = payload["inputs"]
            deadline_ms = payload.get("deadline_ms")
            timeout = payload.get("timeout_s")
        except (ValueError, KeyError, TypeError) as e:
            self._reply_json(400, {"error": f"malformed request: {e!r}"})
            return
        for name, v in (("deadline_ms", deadline_ms), ("timeout_s", timeout)):
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, (int, float))):
                self._reply_json(
                    400, {"error": f"{name} must be a number, got {v!r}"})
                return
        try:
            outs = self.engine.predict(inputs, deadline_ms=deadline_ms,
                                       timeout=timeout)
        except Overloaded as e:
            ra = engine_retry_after(self.engine)
            self._reply_json(
                503, {"error": str(e), "kind": "overloaded",
                      "retry_after_s": round(ra, 3)},
                headers={"Retry-After": _retry_after_header(ra)})
        except (DeadlineExceeded, TimeoutError) as e:
            self._reply_json(504, {"error": str(e), "kind": "deadline"})
        except EngineClosed as e:
            self._reply_json(503, {"error": str(e), "kind": "closed"})
        except (ValueError, KeyError) as e:
            self._reply_json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — the server survives any request
            self._reply_json(500, {"error": repr(e)})
        else:
            names = self.engine._fetch_names
            self._reply_json(200, {"outputs": {
                n: np.asarray(o) for n, o in zip(names, outs)}})

    # -- adapter lifecycle (admin) -------------------------------------------
    def _adapter_admin(self, evict: bool):
        """Upload or evict LoRA adapters of the GenerationEngine's
        AdapterStore; factors are plain JSON nested lists."""
        store = getattr(self.gen_engine, "adapter_store", None)
        if store is None:
            self._reply_json(404, {
                "error": "no AdapterStore attached — construct the "
                         "GenerationEngine with adapter_store= or set the "
                         "adapter_pool_max_bytes flag"})
            return
        try:
            payload = self._payload()
            adapter_id = str(payload["adapter_id"])
        except (ValueError, KeyError, TypeError) as e:
            self._reply_json(400, {"error": f"malformed request: {e!r}"})
            return
        from ..adapters import (AdapterError, AdapterInUse, AdapterMissing,
                                AdapterPoolFull, AdapterQuotaExceeded)

        try:
            if evict:
                row = store.evict(adapter_id,
                                  force=bool(payload.get("force", False)))
                self._reply_json(200, {"evicted": row})
                return
            raw = payload["factors"]
            if not isinstance(raw, dict) or not raw:
                raise ValueError("factors must be a non-empty object "
                                 "{target: {'a': [[..]], 'b': [[..]]}}")
            factors = {}
            for t, ab in raw.items():
                a, b = (ab["a"], ab["b"]) if isinstance(ab, dict) else ab
                factors[str(t)] = (np.asarray(a, np.float32),
                                   np.asarray(b, np.float32))
            alpha = payload.get("alpha")
            row = store.upload(adapter_id, factors,
                               alpha=float(alpha) if alpha is not None
                               else None, tenant=payload.get("tenant"))
            self._reply_json(200, {"uploaded": row})
        except AdapterQuotaExceeded as e:
            self._reply_json(429, {"error": str(e), "kind": "quota"})
        except AdapterPoolFull as e:
            self._reply_json(503, {"error": str(e), "kind": "pool_full"})
        except AdapterInUse as e:
            self._reply_json(409, {"error": str(e), "kind": "in_use"})
        except AdapterMissing as e:
            self._reply_json(404, {"error": str(e), "kind": "missing"})
        except (AdapterError, ValueError, KeyError, TypeError) as e:
            self._reply_json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — the server survives
            self._reply_json(500, {"error": repr(e)})

    # -- autoregressive generation (streamed) -------------------------------
    def _write_chunk(self, data: bytes):
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _generate(self):
        if self.gen_engine is None:
            self._reply_json(404, {
                "error": "no GenerationEngine attached — construct "
                         "ServingServer(engine, generation_engine=...)"})
            return
        try:
            payload = self._payload()
            tokens = payload["tokens"]
            if (not isinstance(tokens, list) or not tokens
                    or not all(isinstance(t, int) for t in tokens)):
                raise ValueError("tokens must be a non-empty int list")
            max_new = payload.get("max_new_tokens")
            eos_id = payload.get("eos_id")
            deadline_ms = payload.get("deadline_ms")
            do_stream = bool(payload.get("stream", True))
            for name, v in (("max_new_tokens", max_new), ("eos_id", eos_id),
                            ("deadline_ms", deadline_ms)):
                if v is not None and (isinstance(v, bool)
                                      or not isinstance(v, (int, float))):
                    raise ValueError(f"{name} must be a number, got {v!r}")
        except (ValueError, KeyError, TypeError) as e:
            self._reply_json(400, {"error": f"malformed request: {e!r}"})
            return
        from ..adapters import AdapterError, AdapterMissing

        adapter = self._adapter(payload)
        try:
            kw = {"adapter": adapter} if adapter is not None else {}
            stream = self.gen_engine.submit(
                tokens, max_new_tokens=max_new,
                eos_id=eos_id if eos_id is not None else "default",
                deadline_ms=deadline_ms, **kw)
        except AdapterMissing as e:
            # not resident: the router uploads it or places the request
            # elsewhere (a 503 would read as "retry here")
            self._reply_json(404, {"error": str(e), "kind": "adapter"})
            return
        except AdapterError as e:
            self._reply_json(409, {"error": str(e), "kind": "adapter"})
            return
        except Overloaded as e:
            ra = generation_retry_after(self.gen_engine)
            self._reply_json(
                503, {"error": str(e), "kind": "overloaded",
                      "retry_after_s": round(ra, 3)},
                headers={"Retry-After": _retry_after_header(ra)})
            return
        except EngineClosed as e:
            self._reply_json(503, {"error": str(e), "kind": "closed"})
            return
        except (DeadlineExceeded, TimeoutError) as e:
            self._reply_json(504, {"error": str(e), "kind": "deadline"})
            return
        except ValueError as e:
            self._reply_json(400, {"error": str(e)})
            return

        def usage_fragment():
            u = stream.usage()
            u["prompt_tokens"] = len(tokens)
            return u

        if not do_stream:
            try:
                out = stream.result()
            except (DeadlineExceeded, TimeoutError) as e:
                self._reply_json(504, {"error": str(e), "kind": "deadline"})
                return
            except Exception as e:  # noqa: BLE001
                self._reply_json(500, {"error": repr(e)})
                return
            self._reply_json(200, {"tokens": out,
                                   "finish_reason": stream.finish_reason,
                                   "usage": usage_fragment()})
            return
        # streamed: chunked NDJSON, a line per token as it is sampled
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        if self._rid:
            self.send_header(REQUEST_ID_HEADER, self._rid)
        self.end_headers()
        # a client that stops reading fills the socket buffers and
        # blocks the next write: the timeout turns the stall into a
        # cancel (the sequence retires at the next step)
        if self.stream_timeout_s and self.stream_timeout_s > 0:
            self.connection.settimeout(float(self.stream_timeout_s))
        n = 0
        try:
            for tok in stream:
                line = {"index": n, "token": int(tok)}
                if n == 0 and self._rid:
                    line["request_id"] = self._rid
                self._write_chunk(json.dumps(line).encode() + b"\n")
                n += 1
            tail = {"done": True, "finish_reason": stream.finish_reason,
                    "n_tokens": n, "usage": usage_fragment()}
        except OSError:   # a stalled (socket.timeout) or hung-up client
            stream.cancel()
            self.close_connection = True
            return
        except Exception as e:  # noqa: BLE001 — deadline/cancel mid-stream
            tail = {"done": True,
                    "finish_reason": stream.finish_reason or "error",
                    "n_tokens": n, "error": str(e),
                    "usage": usage_fragment()}
        if self._rid:
            tail.setdefault("request_id", self._rid)
        try:
            self._write_chunk(json.dumps(tail).encode() + b"\n")
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except OSError:
            stream.cancel()
            self.close_connection = True


class _QuietThreadingServer(ThreadingHTTPServer):
    daemon_threads = True

    def handle_error(self, request, client_address):
        import sys

        et = sys.exc_info()[0]
        if et is not None and issubclass(et, (ConnectionError, TimeoutError)):
            return  # the client hung up mid-request: routine
        super().handle_error(request, client_address)


class ServingServer:
    """Owns the HTTP listener; the engines' lifecycles stay the
    caller's. ``port=0`` binds a free port; ``.port`` and ``.address``
    report it. ``stream_write_timeout_s`` overrides the
    ``traffic_stream_write_timeout_s`` flag (the slow-reader cancel);
    ``sndbuf`` shrinks each connection's send buffer (a test hook).

    A GenerationEngine on the card captures its CUDA graph in its
    constructor, so build every engine before the server: the server
    takes engines that exist, and no capture runs while it serves."""

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 0, start: bool = True, generation_engine=None,
                 traffic=None, reuse_port: bool = False,
                 stream_write_timeout_s: Optional[float] = None,
                 sndbuf: int = 0, phase: Optional[str] = None, fleet=None):
        for what, val in (("traffic", traffic), ("fleet", fleet),
                          ("phase", phase)):
            if val is not None:
                raise NotImplementedError(
                    f"ServingServer({what}=...) is not ported to "
                    f"paddle_tpu_torch yet: {_A9}")
        if reuse_port:
            raise NotImplementedError(
                "ServingServer(reuse_port=True) (the multi-process worker "
                f"pool's listener) is not ported yet: {_A9}")
        if stream_write_timeout_s is None:
            stream_write_timeout_s = float(
                flag("traffic_stream_write_timeout_s"))
        self.engine = engine
        self.generation_engine = generation_engine
        handler = type("_BoundHandler", (_Handler,),
                       {"engine": engine, "gen_engine": generation_engine,
                        "stream_timeout_s": float(stream_write_timeout_s),
                        "sndbuf": int(sndbuf),
                        "started_at": time.monotonic()})
        self._httpd = _QuietThreadingServer((host, port), handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServingServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="pt-torch-serving-http", daemon=True)
            self._thread.start()
        return self

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(10)
            self._thread = None

    def __enter__(self) -> "ServingServer":
        return self

    def __exit__(self, *exc):
        self.close()
