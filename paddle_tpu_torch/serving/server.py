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
                          "draining" once the engine (or the traffic
                          controller) is closed; with a GenerationEngine,
                          its ``models_fragment()``; with a phase, its
                          ``phase`` and the disaggregated service's
                          per-worker ``phases``; with a traffic
                          controller, its ``health()``.
    GET  /metrics      -> the unified process-wide exposition
                          (``observability.to_prometheus_text()``):
                          every live engine's ``paddle_serving_*``,
                          ``paddle_serving_predictor_*``,
                          ``paddle_generation_*``, ``paddle_traffic_*``,
                          ``paddle_disagg_*``, ``paddle_adapter_*`` and
                          ``paddle_step_*`` series, labeled per instance.
    GET  /metrics/fleet -> the merged fleet exposition (every worker
                          scraped and relabeled {worker=,phase=,rank=},
                          plus the ``paddle_slo_*`` gauges); needs
                          ``ServingServer(..., fleet=FleetAggregator())``
                          (404 without one).
    GET  /v1/admin/trace/<id> -> this process's completed spans of one
                          trace (from the flight ring), pid-stamped; 404
                          when it holds none.
    POST /v1/admin/flight/dump -> dump the local flight ring now.

Every request adopts the client's ``X-Request-Id`` (or mints one) and
its ``traceparent`` / ``X-Trace`` trace context, so the handler's spans
join the caller's trace; replies echo both ids in headers, in error
bodies, and on the first and last NDJSON lines of a stream. A streamed
``/v1/generate`` whose client stops reading for
``traffic_stream_write_timeout_s`` seconds (or hangs up) cancels its
sequence, whose pages free at the next step.

With ``traffic=TrafficController(...)`` both POST endpoints route
through the traffic tier: tenant and priority class come from the
``X-Tenant`` / ``X-Priority`` headers (or the payload's ``tenant`` /
``priority``), and a shed answers 503 (429 for a tenant quota) with a
``Retry-After`` from the measured drain rate. ``reuse_port=True`` binds
with SO_REUSEPORT so the worker processes of a ``traffic.WorkerPool``
share the port; ``active_requests()`` is the in-flight count its
rolling-restart drain waits on.
"""

from __future__ import annotations

import json
import math
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..flags import flag
from .engine import DeadlineExceeded, EngineClosed, Overloaded, ServingEngine

__all__ = ["ServingServer"]

VERSION = "0.1.0"     # paddle_tpu/version.py full_version
REQUEST_ID_HEADER = "X-Request-Id"
TRACE_HEADER = "X-Trace"
# the observability and traffic modules import the serving package (its
# histogram), so this module imports them where it uses them


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


class _Handler(BaseHTTPRequestHandler):
    engine: ServingEngine = None  # set by the subclass ServingServer makes
    gen_engine = None             # generation.GenerationEngine (optional)
    traffic = None                # traffic.TrafficController (optional)
    fleet = None                  # observability.FleetAggregator (optional)
    phase = None                  # disaggregated worker phase (optional)
    started_at: float = 0.0
    stream_timeout_s: float = 0.0
    sndbuf: int = 0               # test hook: shrink SO_SNDBUF
    active = None                 # {"n": int} shared with ServingServer
    active_lock = None
    server_version = "paddle_tpu_torch_serving/1.0"
    protocol_version = "HTTP/1.1"
    # per-request correlation state (set by _begin_request)
    _rid = None
    _ctx = None
    _trace_id = None
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
        """Adopt the client's ``X-Request-Id`` (or mint one) and its trace
        context (``traceparent`` / ``X-Trace``)."""
        from ..observability import propagate

        self._rid = (self.headers.get(REQUEST_ID_HEADER)
                     or propagate.new_request_id())
        self._ctx = propagate.extract(self.headers)
        self._trace_id = (self._ctx.trace_id
                          if self._ctx is not None else None)

    def _reply(self, code: int, body: bytes, ctype: str, headers=None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if self._rid:
            self.send_header(REQUEST_ID_HEADER, self._rid)
        if self._trace_id:
            self.send_header(TRACE_HEADER, self._trace_id)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj, headers=None):
        if code >= 400 and isinstance(obj, dict):
            # every error body names the request and its trace
            if self._rid:
                obj.setdefault("request_id", self._rid)
            if self._trace_id:
                obj.setdefault("trace_id", self._trace_id)
        self._reply(code, json.dumps(obj, default=_json_default).encode(),
                    "application/json", headers=headers)

    def _reply_shed(self, e) -> None:
        """A traffic-tier shed: 503 (429 for a quota) with a Retry-After
        from the measured drain rate or the token-bucket refill."""
        code = 429 if e.kind == "quota" else 503
        self._reply_json(code, {
            "error": str(e), "kind": f"shed:{e.kind}",
            "retry_after_s": round(e.retry_after_s, 3),
        }, headers={"Retry-After": _retry_after_header(e.retry_after_s)})

    def _payload(self):
        payload = json.loads(self._body or b"{}")
        if not isinstance(payload, dict):
            raise ValueError("the request body must be a JSON object")
        return payload

    def _meta(self, payload) -> tuple:
        """(tenant, priority, adapter), headers first, the payload second.
        ``model`` is an alias of ``adapter``; "", "base" or the engine's
        base version mean no adapter."""
        tenant = self.headers.get("X-Tenant") or payload.get("tenant")
        priority = self.headers.get("X-Priority") or payload.get("priority")
        adapter = (self.headers.get("X-Adapter") or payload.get("adapter")
                   or payload.get("model"))
        if adapter is not None:
            adapter = str(adapter)
            base = getattr(self.gen_engine, "model_version", "base")
            if adapter in ("", "base", base):
                adapter = None
        return tenant, priority, adapter

    # -- endpoints -----------------------------------------------------------
    def do_GET(self):  # noqa: N802 — http.server contract
        self._begin_request()
        if self.path == "/healthz":
            draining = self.engine.closed or (
                self.traffic is not None and self.traffic.draining)
            body = {"status": "draining" if draining else "ok",
                    "uptime_s": round(time.monotonic() - self.started_at, 3),
                    "version": VERSION, "tpu": "OFF"}
            if self.phase:
                # which phase this worker serves, on the probe a router
                # already polls
                body["phase"] = self.phase
            gen = self.gen_engine
            if gen is not None and hasattr(gen, "phase_health"):
                try:
                    body["phases"] = gen.phase_health()
                except Exception:  # noqa: BLE001 — a closing service
                    pass
            if gen is not None and hasattr(gen, "models_fragment"):
                try:
                    body["models"] = gen.models_fragment()
                except Exception:  # noqa: BLE001 — a closing engine
                    pass
            if self.traffic is not None:
                body["traffic"] = self.traffic.health()
            self._reply_json(503 if draining else 200, body)
        elif self.path == "/metrics":
            from .. import observability

            # the unified registry: every live engine, controller and
            # store of the process in one scrape
            text = observability.to_prometheus_text()
            self._reply(200, text.encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
        elif self.path == "/metrics/fleet":
            if self.fleet is None:
                self._reply_json(404, {
                    "error": "no FleetAggregator attached: construct "
                             "ServingServer(..., fleet=FleetAggregator())"})
                return
            try:
                text = self.fleet.to_prometheus_text()
            except Exception as e:  # noqa: BLE001 — a scrape must not 500 loop
                self._reply_json(500, {"error": repr(e)})
                return
            self._reply(200, text.encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
        elif self.path.startswith("/v1/admin/trace/"):
            # this process's slice of one trace, pid-stamped;
            # fleet.assemble_trace merges the workers' slices
            from ..observability import propagate

            tid = self.path.rsplit("/", 1)[-1].strip().lower()
            payload = propagate.local_trace(tid, phase=self.phase)
            self._reply_json(200 if payload["spans"] else 404, payload)
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
        # in-flight accounting: the rolling-restart drain waits for this
        # to reach zero before the process exits
        with self.active_lock:
            self.active["n"] += 1
        try:
            if self.path == "/v1/generate":
                self._generate()
            elif self.path == "/v1/predict":
                self._predict()
            elif self.path == "/v1/admin/adapters/evict":
                self._adapter_admin(evict=True)
            elif self.path == "/v1/admin/adapters":
                self._adapter_admin(evict=False)
            elif self.path == "/v1/admin/flight/dump":
                self._flight_dump()
            else:
                self._reply_json(404,
                                 {"error": f"no such endpoint {self.path}"})
        finally:
            with self.active_lock:
                self.active["n"] -= 1

    def _flight_dump(self):
        """Dump this process's flight ring now (the SLO monitor's
        sustained-burn trigger posts this to every worker)."""
        from ..observability import flight

        try:
            path = flight.dump(f"admin:{self._rid}")
            self._reply_json(200, {"path": path, "request_id": self._rid})
        except Exception as e:  # noqa: BLE001 — the server must survive
            self._reply_json(500, {"error": repr(e)})

    def _predict(self):
        from ..observability import tracing
        from ..traffic.controller import TrafficShed, engine_retry_after

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
            # the handler thread is the trace root, or a child of the
            # caller's span when it sent a traceparent
            with tracing.attach(self._ctx), \
                 tracing.span("serving/http_predict",
                              {"request_id": self._rid}) as sctx:
                if sctx is not None:
                    self._trace_id = sctx.trace_id
                if self.traffic is not None:
                    tenant, priority, _ = self._meta(payload)
                    outs = self.traffic.predict(
                        inputs, tenant=tenant, priority=priority,
                        deadline_ms=deadline_ms, timeout=timeout)
                else:
                    outs = self.engine.predict(inputs,
                                               deadline_ms=deadline_ms,
                                               timeout=timeout)
        except TrafficShed as e:
            self._reply_shed(e)
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
        from ..observability import tracing
        from ..traffic.controller import TrafficShed, generation_retry_after

        ticket = None
        tenant, priority, adapter = self._meta(payload)
        try:
            with tracing.attach(self._ctx), \
                 tracing.span("serving/http_generate",
                              {"request_id": self._rid}) as sctx:
                if sctx is not None:
                    self._trace_id = sctx.trace_id
                if self.traffic is not None:
                    ticket = self.traffic.submit_generation(
                        tokens, tenant=tenant, priority=priority,
                        deadline_ms=deadline_ms, max_new_tokens=max_new,
                        eos_id=eos_id if eos_id is not None else "default",
                        adapter=adapter)
                    # blocks until the dispatcher admits the prompt into
                    # the continuous batch (or sheds it)
                    stream = ticket.stream(
                        timeout=(deadline_ms / 1e3 + 5.0
                                 if deadline_ms is not None else 600.0))
                else:
                    # adapter rides only when named: engines that host no
                    # adapters (a DisaggService) keep working here
                    kw = {"adapter": adapter} if adapter is not None else {}
                    stream = self.gen_engine.submit(
                        tokens, max_new_tokens=max_new,
                        eos_id=eos_id if eos_id is not None else "default",
                        deadline_ms=deadline_ms, **kw)
        except TrafficShed as e:
            self._reply_shed(e)
            return
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
            if ticket is not None:
                # the client is gone after this 504: withdraw the queued
                # request so it never spends a lane on a dead stream
                ticket.cancel()
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
        if self._trace_id:
            self.send_header(TRACE_HEADER, self._trace_id)
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
                if n == 0:
                    # the ids ride the first fragment (at TTFT), so a
                    # client can correlate a stream it later abandons
                    if self._trace_id:
                        line["trace_id"] = self._trace_id
                    if self._rid:
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
        if self._trace_id:
            tail.setdefault("trace_id", self._trace_id)
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


class _ReuseportThreadingServer(_QuietThreadingServer):
    """SO_REUSEPORT listener: the worker processes of a WorkerPool bind
    the same host:port and the kernel balances new connections across
    them."""

    def server_bind(self):
        if not hasattr(socket, "SO_REUSEPORT"):
            raise OSError(
                "SO_REUSEPORT is not supported on this platform; use "
                "traffic.ThinRouter / WorkerPool(use_reuseport=False)")
        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()


class ServingServer:
    """Owns the HTTP listener; the engines' lifecycles stay the
    caller's. ``port=0`` binds a free port; ``.port`` and ``.address``
    report it. ``traffic=`` routes both POST endpoints through a
    ``traffic.TrafficController``; ``fleet=`` serves a
    ``FleetAggregator`` on ``/metrics/fleet``; ``phase`` (by default the
    generation engine's) labels ``/healthz``; ``reuse_port=True`` binds
    with SO_REUSEPORT. ``stream_write_timeout_s`` overrides the
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
        self.engine = engine
        self.generation_engine = generation_engine
        self.traffic = traffic
        self.fleet = fleet
        if phase is None:
            phase = getattr(generation_engine, "phase", None)
        self.phase = str(phase) if phase else None
        if stream_write_timeout_s is None:
            stream_write_timeout_s = float(
                flag("traffic_stream_write_timeout_s"))
        self._active = {"n": 0}
        self._active_lock = threading.Lock()
        handler = type("_BoundHandler", (_Handler,),
                       {"engine": engine, "gen_engine": generation_engine,
                        "traffic": traffic, "fleet": fleet,
                        "phase": self.phase,
                        "stream_timeout_s": float(stream_write_timeout_s),
                        "sndbuf": int(sndbuf),
                        "active": self._active,
                        "active_lock": self._active_lock,
                        "started_at": time.monotonic()})
        server_cls = (_ReuseportThreadingServer if reuse_port
                      else _QuietThreadingServer)
        self._httpd = server_cls((host, port), handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def active_requests(self) -> int:
        """POST requests inside a handler now (the drain's exit
        condition)."""
        with self._active_lock:
            return self._active["n"]

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
