"""Fleet metrics aggregation + SLO burn-rate signals (the counterpart of
``paddle_tpu/observability/fleet.py``).

One process's ``/metrics`` is the unified registry (registry.py); the
deployed system is a FLEET: WorkerPool serving processes behind one
port, disaggregated prefill/decode tiers, multi-host trainers. A
closed-loop autoscaler needs every worker's ``paddle_traffic_*`` /
``paddle_generation_*`` / ``paddle_disagg_*`` series in ONE scrape,
with labels saying which process each sample came from, plus an SLO
verdict computed over the merged view.

* ``FleetAggregator`` — scrapes every known worker endpoint
  (explicitly added, discovered from a ``traffic.WorkerPool``'s
  backend list, or from ``PADDLE_TRAINER_ENDPOINTS`` /
  ``observability_fleet_endpoints``) concurrently with a hard
  per-endpoint timeout; a dead or hung backend marks its series STALE
  (last-good values keep serving, ``paddle_fleet_stale{worker=}``
  flips to 1) and can never stall the scrape. Merged samples are
  re-labeled ``{worker=,phase=,rank=}`` and served by
  ``ServingServer``'s ``/metrics/fleet`` and
  ``observability.fleet_snapshot()``.
* ``SLOMonitor`` — windowed deadline-miss ratio vs an error budget,
  TTFT/ITL p99 vs configured targets (``slo_*`` flags), exported as
  ``paddle_slo_*{cls=}`` gauges. ``burn`` is the classic burn rate:
  miss-ratio / budget, 1.0 = consuming budget exactly as provisioned.
  Sustained burn above ``slo_burn_threshold`` for a full window
  triggers ONE fleet-wide flight dump (local ring + a
  ``POST /v1/admin/flight/dump`` to every live worker) and latches
  until the burn recedes — the postmortem is captured at the moment
  the SLO story turns, not after someone notices the pager.
* ``assemble_trace`` — pulls ``/v1/admin/trace/<id>`` from every
  fleet endpoint and merges the per-process span lists into one
  cross-process trace (a timeline renderer draws it with process
  lanes).

The monitor's clock is injectable (tests drive burn-rate math on a
fake clock); the aggregator's scrape is pull-only and holds no lock
while any socket is in flight.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import flight

__all__ = [
    "FleetAggregator", "SLOMonitor", "parse_prometheus_text",
    "discover_endpoints", "configure_fleet", "default_aggregator",
    "fleet_snapshot", "fetch_trace", "assemble_trace",
]

_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+([^\s]+)$")
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus_text(text: str) -> List[Tuple[str, Dict[str, str],
                                                   float]]:
    """Exposition text -> ``[(name, labels, value)]``; comments and
    unparseable lines are skipped (a half-written scrape from a dying
    worker must not take down the merge)."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if m is None:
            continue
        name, raw_labels, raw_val = m.groups()
        try:
            val = float(raw_val)
        except ValueError:
            continue
        labels = ({k: v for k, v in _LABEL.findall(raw_labels)}
                  if raw_labels else {})
        out.append((name, labels, val))
    return out


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    items = sorted(labels.items())
    return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


def discover_endpoints() -> List[Dict[str, Any]]:
    """Endpoints named by the environment/flags contract:
    ``observability_fleet_endpoints`` (comma list, ``name=url`` or
    bare url) wins; ``PADDLE_TRAINER_ENDPOINTS`` (the multi-host
    trainer contract) adds one rank-labeled endpoint per peer."""
    from ..flags import flag

    eps: List[Dict[str, Any]] = []
    raw = str(flag("observability_fleet_endpoints") or "").strip()
    for i, item in enumerate(p for p in raw.split(",") if p.strip()):
        item = item.strip()
        if "=" in item.split("://")[0]:
            name, url = item.split("=", 1)
        else:
            name, url = f"worker-{i}", item
        if "://" not in url:
            url = f"http://{url}"
        eps.append({"url": url, "worker": name})
    peers = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").strip()
    if peers:
        for rank, ep in enumerate(p for p in peers.split(",")
                                  if p.strip()):
            eps.append({"url": f"http://{ep.strip()}",
                        "worker": f"trainer-{rank}", "rank": rank,
                        "phase": "train"})
    return eps


class _Endpoint:
    __slots__ = ("url", "worker", "phase", "rank", "text", "ok_at",
                 "stale", "errors_total", "last_error")

    def __init__(self, url: str, worker: str,
                 phase: Optional[str] = None,
                 rank: Optional[int] = None):
        self.url = url.rstrip("/")
        self.worker = worker
        self.phase = phase
        self.rank = rank
        self.text: Optional[str] = None   # last-good exposition text
        self.ok_at: Optional[float] = None
        self.stale = True
        self.errors_total = 0
        self.last_error: Optional[str] = None

    def labels(self) -> Dict[str, str]:
        lbl = {"worker": self.worker}
        if self.phase:
            lbl["phase"] = str(self.phase)
        if self.rank is not None:
            lbl["rank"] = str(self.rank)
        return lbl


class FleetAggregator:
    """Merge every known worker's ``/metrics`` into one exposition.

        agg = FleetAggregator()
        agg.add_endpoint(server.address, worker="router", phase="both")
        agg.watch_pool(pool)            # WorkerPool/ThinRouter backends
        text = agg.to_prometheus_text() # scrape + merge, {worker=} labels

    Scrapes run one thread per endpoint with a hard ``timeout_s``; a
    hung socket's thread is abandoned at the deadline (daemon), its
    endpoint marked stale with last-good values still exported.
    """

    def __init__(self, endpoints: Optional[List[Any]] = None, *,
                 timeout_s: Optional[float] = None,
                 slo: Optional["SLOMonitor"] = None,
                 clock: Callable[[], float] = time.monotonic):
        from ..flags import flag

        self._timeout = (float(flag("observability_fleet_timeout_s"))
                         if timeout_s is None else float(timeout_s))
        self._clock = clock
        self._lock = threading.Lock()
        self._eps: List[_Endpoint] = []
        self._pools: List[Any] = []
        self.slo = slo
        self.scrapes_total = 0
        self.last_scrape_ms = 0.0
        for ep in (endpoints or []):
            if isinstance(ep, dict):
                self.add_endpoint(**ep)
            else:
                self.add_endpoint(str(ep))
        for ep in discover_endpoints():
            self.add_endpoint(**ep)

    # -- membership ----------------------------------------------------------
    def add_endpoint(self, url: str, *, worker: Optional[str] = None,
                     phase: Optional[str] = None,
                     rank: Optional[int] = None) -> None:
        if "://" not in url:
            url = f"http://{url}"
        url = url.rstrip("/")
        with self._lock:
            for ep in self._eps:
                if ep.url == url:
                    if worker:
                        ep.worker = worker
                    if phase:
                        ep.phase = phase
                    if rank is not None:
                        ep.rank = rank
                    return
            self._eps.append(_Endpoint(
                url, worker or f"worker-{len(self._eps)}", phase, rank))

    def watch_pool(self, pool) -> None:
        """Track a ``traffic.WorkerPool`` (or anything exposing
        ``metrics_endpoints()``): its current backend list is re-read
        at every scrape, so rolling restarts and scale events never
        leave the fleet view pointing at dead ports."""
        with self._lock:
            if pool not in self._pools:
                self._pools.append(pool)

    def endpoints(self) -> List[Dict[str, Any]]:
        self._refresh_pools()
        with self._lock:
            return [{"url": ep.url, **ep.labels(), "stale": ep.stale,
                     "errors_total": ep.errors_total}
                    for ep in self._eps]

    def _refresh_pools(self) -> None:
        with self._lock:
            pools = list(self._pools)
        for pool in pools:
            try:
                for ep in pool.metrics_endpoints():
                    self.add_endpoint(**ep)
            except Exception:  # noqa: BLE001 — a closing pool mid-scrape
                continue

    # -- scraping ------------------------------------------------------------
    def _fetch(self, ep: _Endpoint) -> None:
        try:
            with urllib.request.urlopen(f"{ep.url}/metrics",
                                        timeout=self._timeout) as r:
                text = r.read().decode("utf-8", "replace")
            ep.text = text
            ep.ok_at = self._clock()
            ep.stale = False
            ep.last_error = None
        except Exception as e:  # noqa: BLE001 — dead/hung backends expected
            ep.stale = True
            ep.errors_total += 1
            ep.last_error = f"{type(e).__name__}: {e}"[:200]

    def scrape(self) -> Dict[str, Any]:
        """One concurrent pass over every endpoint. Wall time is
        bounded by ``timeout_s`` (plus join slack), NOT by the number
        of dead backends — each endpoint gets its own thread and a
        thread past its deadline is abandoned, never joined on."""
        self._refresh_pools()
        with self._lock:
            eps = list(self._eps)
        t0 = time.monotonic()
        threads = [threading.Thread(target=self._fetch, args=(ep,),
                                    name=f"pt-fleet-scrape-{ep.worker}",
                                    daemon=True)
                   for ep in eps]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self._timeout + 0.25
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        self.scrapes_total += 1
        self.last_scrape_ms = (time.monotonic() - t0) * 1e3
        live = sum(1 for ep in eps if not ep.stale)
        return {"endpoints": len(eps), "live": live,
                "stale": len(eps) - live,
                "scrape_ms": round(self.last_scrape_ms, 2)}

    # -- views ---------------------------------------------------------------
    def series(self, name: str) -> List[Tuple[Dict[str, str], float]]:
        """All samples of one family across the last scrape, each
        stamped with its endpoint labels — the SLO monitor's ingest
        path (and any autoscaler's)."""
        out = []
        with self._lock:
            eps = list(self._eps)
        for ep in eps:
            if not ep.text:
                continue
            lbl = ep.labels()
            for fam, labels, val in parse_prometheus_text(ep.text):
                if fam == name:
                    out.append(({**labels, **lbl}, val))
        return out

    def _self_series(self, eps: List[_Endpoint]) -> List[str]:
        lines = [
            "# TYPE paddle_fleet_endpoints gauge",
            f"paddle_fleet_endpoints {len(eps)}",
            "# TYPE paddle_fleet_live gauge",
            f"paddle_fleet_live {sum(1 for e in eps if not e.stale)}",
            "# TYPE paddle_fleet_scrape_ms gauge",
            f"paddle_fleet_scrape_ms {round(self.last_scrape_ms, 3)}",
            "# TYPE paddle_fleet_scrapes_total counter",
            f"paddle_fleet_scrapes_total {self.scrapes_total}",
            "# TYPE paddle_fleet_stale gauge",
            "# TYPE paddle_fleet_scrape_errors_total counter",
        ]
        for ep in eps:
            ls = _label_str(ep.labels())
            lines.append(f"paddle_fleet_stale{ls} {int(ep.stale)}")
            lines.append(
                f"paddle_fleet_scrape_errors_total{ls} {ep.errors_total}")
        return lines

    def to_prometheus_text(self, scrape: bool = True) -> str:
        """The merged fleet exposition (what ``/metrics/fleet``
        serves): every worker's families re-labeled
        ``{worker=,phase=,rank=}``, the aggregator's own
        ``paddle_fleet_*`` health series, and — when an ``SLOMonitor``
        is attached — the ``paddle_slo_*`` burn-rate gauges."""
        if scrape:
            self.scrape()
        with self._lock:
            eps = list(self._eps)
        lines: List[str] = []
        seen_types: Dict[str, str] = {}
        for ep in eps:
            if not ep.text:
                continue
            lbl = ep.labels()
            for name, labels, val in parse_prometheus_text(ep.text):
                if name not in seen_types:
                    kind = ("counter" if name.endswith("_total")
                            else "gauge")
                    seen_types[name] = kind
                    lines.append(f"# TYPE {name} {kind}")
                lines.append(
                    f"{name}{_label_str({**labels, **lbl})} {val}")
        lines.extend(self._self_series(eps))
        if self.slo is not None:
            try:
                self.slo.ingest(self)
            except Exception:  # noqa: BLE001 — the merge must survive
                pass
            lines.extend(self.slo.to_prometheus_lines())
        return "\n".join(lines) + "\n"

    def snapshot(self, scrape: bool = True) -> Dict[str, Any]:
        """JSON view: per-worker family dump + fleet health + SLO
        verdicts — ``observability.fleet_snapshot()``."""
        if scrape:
            self.scrape()
        with self._lock:
            eps = list(self._eps)
        workers = []
        for ep in eps:
            series: Dict[str, Any] = {}
            if ep.text:
                for name, labels, val in parse_prometheus_text(ep.text):
                    series.setdefault(name, []).append(
                        {"labels": labels, "value": val})
            workers.append({"url": ep.url, **ep.labels(),
                            "stale": ep.stale,
                            "errors_total": ep.errors_total,
                            "last_error": ep.last_error,
                            "series": series})
        out: Dict[str, Any] = {
            "fleet": {"endpoints": len(eps),
                      "live": sum(1 for e in eps if not e.stale),
                      "scrapes_total": self.scrapes_total,
                      "scrape_ms": round(self.last_scrape_ms, 2)},
            "workers": workers,
        }
        if self.slo is not None:
            try:
                self.slo.ingest(self)
            except Exception:  # noqa: BLE001
                pass
            out["slo"] = self.slo.snapshot()
        return out

    # -- fleet-wide actions --------------------------------------------------
    def trigger_flight_dump(self, reason: str) -> Dict[str, Any]:
        """Dump the local flight ring AND ask every live worker to
        dump its own (``POST /v1/admin/flight/dump``) — the sustained-
        burn action. Best-effort everywhere: a worker that died
        mid-incident must not stop the others' evidence."""
        local = flight.dump(reason)
        remote: Dict[str, Any] = {}
        with self._lock:
            eps = list(self._eps)

        def ask(ep: _Endpoint):
            try:
                req = urllib.request.Request(
                    f"{ep.url}/v1/admin/flight/dump", data=b"{}",
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(req,
                                            timeout=self._timeout) as r:
                    remote[ep.worker] = json.loads(r.read()).get("path")
            except Exception as e:  # noqa: BLE001
                remote[ep.worker] = f"error: {type(e).__name__}"

        threads = [threading.Thread(target=ask, args=(ep,), daemon=True)
                   for ep in eps]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self._timeout + 0.25
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        return {"reason": reason, "local": local, "workers": dict(remote)}


# -- SLO burn rate -----------------------------------------------------------

class _ClsWindow:
    __slots__ = ("samples", "ttft_p99", "itl_p99", "burn_since",
                 "latched")

    def __init__(self):
        # (t, completed_total, missed_total) cumulative samples
        self.samples: List[Tuple[float, float, float]] = []
        self.ttft_p99: Optional[float] = None
        self.itl_p99: Optional[float] = None
        self.burn_since: Optional[float] = None
        self.latched = False


class SLOMonitor:
    """Windowed SLO math over cumulative counters.

    ``record(cls, completed_total=, deadline_missed_total=)`` feeds
    CUMULATIVE totals (what counters are); the monitor differences
    them across a sliding ``window_s`` window:

        miss_ratio = d(missed) / d(completed)      over the window
        burn       = miss_ratio / budget           (1.0 = on budget)

    ``ingest(aggregator)`` pulls the same samples from a fleet scrape
    (summing ``paddle_traffic_*_total`` across workers per ``cls``).
    When ``burn > burn_threshold`` holds for a FULL window the monitor
    fires ``on_burn`` once (default: the aggregator's fleet-wide
    flight dump) and latches until the burn recedes below threshold.

    All timing flows through the injected ``clock`` — burn-rate math
    is testable on a fake clock with zero sleeps.
    """

    def __init__(self, *, budget: Optional[float] = None,
                 ttft_p99_ms: Optional[float] = None,
                 itl_p99_ms: Optional[float] = None,
                 window_s: Optional[float] = None,
                 burn_threshold: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_burn: Optional[Callable[[str], Any]] = None):
        from ..flags import flag

        self.budget = float(flag("slo_deadline_miss_budget")
                            if budget is None else budget)
        self.ttft_p99_ms = float(flag("slo_ttft_p99_ms")
                                 if ttft_p99_ms is None else ttft_p99_ms)
        self.itl_p99_ms = float(flag("slo_itl_p99_ms")
                                if itl_p99_ms is None else itl_p99_ms)
        self.window_s = float(flag("slo_window_s")
                              if window_s is None else window_s)
        self.burn_threshold = float(flag("slo_burn_threshold")
                                    if burn_threshold is None
                                    else burn_threshold)
        self._clock = clock
        self._on_burn = on_burn
        self._lock = threading.Lock()
        self._cls: Dict[str, _ClsWindow] = {}
        self.dumps_total = 0

    def _win(self, cls: str) -> _ClsWindow:
        w = self._cls.get(cls)
        if w is None:
            w = self._cls[cls] = _ClsWindow()
        return w

    def record(self, cls: str = "all", *,
               completed_total: float = 0.0,
               deadline_missed_total: float = 0.0,
               ttft_p99_ms: Optional[float] = None,
               itl_p99_ms: Optional[float] = None,
               t: Optional[float] = None) -> None:
        """Feed one cumulative sample for ``cls`` (call once per
        scrape/tick)."""
        now = self._clock() if t is None else float(t)
        with self._lock:
            w = self._win(cls)
            w.samples.append((now, float(completed_total),
                              float(deadline_missed_total)))
            horizon = now - self.window_s
            # keep one sample at-or-before the horizon as the window's
            # left edge so d(counter) spans the full window
            while len(w.samples) >= 2 and w.samples[1][0] <= horizon:
                w.samples.pop(0)
            if ttft_p99_ms is not None:
                w.ttft_p99 = float(ttft_p99_ms)
            if itl_p99_ms is not None:
                w.itl_p99 = float(itl_p99_ms)
        self._evaluate_burn(cls, now)

    def ingest(self, aggregator: FleetAggregator) -> None:
        """Pull the cumulative counters out of the aggregator's last
        scrape: completed/missed summed across workers per ``cls``,
        TTFT/ITL p99 as the fleet-wide max (the SLO is violated by the
        worst worker, not the average)."""
        done: Dict[str, float] = {}
        miss: Dict[str, float] = {}
        for labels, v in aggregator.series("paddle_traffic_completed_total"):
            cls = labels.get("cls", "all")
            done[cls] = done.get(cls, 0.0) + v
        for labels, v in aggregator.series(
                "paddle_traffic_deadline_miss_total"):
            cls = labels.get("cls", "all")
            miss[cls] = miss.get(cls, 0.0) + v
        ttfts = [v for _l, v in aggregator.series(
            "paddle_generation_ttft_ms_p99")]
        itls = [v for _l, v in aggregator.series(
            "paddle_generation_itl_ms_p99")]
        ttft = max(ttfts) if ttfts else None
        itl = max(itls) if itls else None
        for cls in sorted(set(done) | set(miss)) or ["all"]:
            self.record(cls, completed_total=done.get(cls, 0.0),
                        deadline_missed_total=miss.get(cls, 0.0),
                        ttft_p99_ms=ttft, itl_p99_ms=itl)

    # -- the math -------------------------------------------------------------
    def _window_ratio(self, w: _ClsWindow) -> Tuple[float, float]:
        if len(w.samples) < 2:
            return 0.0, 0.0
        t0, c0, m0 = w.samples[0]
        t1, c1, m1 = w.samples[-1]
        dc = max(0.0, c1 - c0)
        dm = max(0.0, m1 - m0)
        ratio = (dm / dc) if dc > 0 else 0.0
        return ratio, dc

    def _evaluate_burn(self, cls: str, now: float) -> None:
        if self.burn_threshold <= 0:
            return
        with self._lock:
            w = self._win(cls)
            ratio, dc = self._window_ratio(w)
            burn = (ratio / self.budget) if self.budget > 0 else 0.0
            if burn > self.burn_threshold and dc > 0:
                if w.burn_since is None:
                    w.burn_since = now
                sustained = (now - w.burn_since) >= self.window_s
                fire = sustained and not w.latched
                if fire:
                    w.latched = True
                    self.dumps_total += 1
            else:
                w.burn_since = None
                w.latched = False
                fire = False
        if fire:
            cb = self._on_burn
            if cb is not None:
                try:
                    cb(f"slo-burn-{cls}")
                except Exception:  # noqa: BLE001 — monitoring must not crash serving
                    pass
            else:
                flight.dump(f"slo-burn-{cls}")

    # -- exports --------------------------------------------------------------
    def gauges(self) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
        """``paddle_slo_*`` series, one sample per ``cls``."""
        out: Dict[str, List[Tuple[Dict[str, str], float]]] = {
            "paddle_slo_deadline_miss_ratio": [],
            "paddle_slo_error_budget_burn": [],
            "paddle_slo_window_completed": [],
            "paddle_slo_sustained_burn": [],
        }
        with self._lock:
            for cls, w in sorted(self._cls.items()):
                lbl = {"cls": cls}
                ratio, dc = self._window_ratio(w)
                burn = (ratio / self.budget) if self.budget > 0 else 0.0
                out["paddle_slo_deadline_miss_ratio"].append((lbl, ratio))
                out["paddle_slo_error_budget_burn"].append(
                    (lbl, round(burn, 4)))
                out["paddle_slo_window_completed"].append((lbl, dc))
                out["paddle_slo_sustained_burn"].append(
                    (lbl, float(w.latched)))
                if w.ttft_p99 is not None:
                    out.setdefault("paddle_slo_ttft_p99_ms", []).append(
                        (lbl, w.ttft_p99))
                    if self.ttft_p99_ms > 0:
                        out.setdefault("paddle_slo_ttft_target_ratio",
                                       []).append(
                            (lbl, round(w.ttft_p99 / self.ttft_p99_ms, 4)))
                if w.itl_p99 is not None:
                    out.setdefault("paddle_slo_itl_p99_ms", []).append(
                        (lbl, w.itl_p99))
                    if self.itl_p99_ms > 0:
                        out.setdefault("paddle_slo_itl_target_ratio",
                                       []).append(
                            (lbl, round(w.itl_p99 / self.itl_p99_ms, 4)))
            out["paddle_slo_flight_dumps_total"] = [
                ({}, float(self.dumps_total))]
        return out

    def to_prometheus_lines(self) -> List[str]:
        lines: List[str] = []
        for name, series in self.gauges().items():
            kind = "counter" if name.endswith("_total") else "gauge"
            lines.append(f"# TYPE {name} {kind}")
            for labels, val in series:
                lines.append(f"{name}{_label_str(labels)} {val}")
        return lines

    def snapshot(self) -> Dict[str, Any]:
        return {name: [{"labels": dict(l), "value": v}
                       for l, v in series]
                for name, series in self.gauges().items()}

    def register(self) -> "SLOMonitor":
        """Export the gauges through the process-wide registry too, so
        a worker's OWN ``/metrics`` carries its slice of the SLO story
        even when nobody asks the router."""
        from .registry import registry

        registry().register_collector("slo", self.gauges)
        return self


# -- module-default aggregator (observability.fleet_snapshot) ----------------

_default_lock = threading.Lock()
_default: Optional[FleetAggregator] = None


def configure_fleet(endpoints: Optional[List[Any]] = None,
                    **kwargs) -> FleetAggregator:
    """Build (or rebuild) the process-default aggregator behind
    ``observability.fleet_snapshot()``."""
    global _default
    with _default_lock:
        _default = FleetAggregator(endpoints, **kwargs)
        return _default


def default_aggregator() -> FleetAggregator:
    global _default
    with _default_lock:
        if _default is None:
            _default = FleetAggregator(slo=SLOMonitor())
        return _default


def fleet_snapshot(scrape: bool = True) -> Dict[str, Any]:
    """One JSON view of the whole fleet — the programmatic twin of
    ``GET /metrics/fleet`` (endpoints come from ``configure_fleet``,
    the ``observability_fleet_endpoints`` flag, or
    ``PADDLE_TRAINER_ENDPOINTS``)."""
    return default_aggregator().snapshot(scrape=scrape)


# -- cross-process trace assembly --------------------------------------------

def fetch_trace(url: str, trace_id: str, *,
                timeout_s: float = 2.0) -> Optional[Dict[str, Any]]:
    """One process's ``/v1/admin/trace/<id>`` payload, or None."""
    try:
        with urllib.request.urlopen(
                f"{url.rstrip('/')}/v1/admin/trace/{trace_id}",
                timeout=timeout_s) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None
        return None
    except Exception:  # noqa: BLE001 — a dead worker has no spans to give
        return None


def assemble_trace(trace_id: str, endpoints: List[str], *,
                   timeout_s: float = 2.0) -> Dict[str, Any]:
    """Pull a trace's spans from every process and merge them into one
    cross-process view: ``spans`` sorted by start time (each already
    pid-stamped by ``propagate.local_trace``), ``processes`` naming
    each pid's lane."""
    spans: List[Dict[str, Any]] = []
    processes: Dict[int, Dict[str, Any]] = {}
    for url in endpoints:
        payload = fetch_trace(url, trace_id, timeout_s=timeout_s)
        if not payload:
            continue
        pid = int(payload.get("pid", 0))
        processes[pid] = {
            "pid": pid, "url": url,
            "host": payload.get("host"),
            "worker": payload.get("worker"),
            "phase": payload.get("phase"),
        }
        seen = {(s.get("span_id"), s.get("ts")) for s in spans}
        for s in payload.get("spans", []):
            if (s.get("span_id"), s.get("ts")) not in seen:
                spans.append(s)
    spans.sort(key=lambda s: s.get("ts", 0.0))
    return {"trace_id": trace_id, "spans": spans,
            "processes": sorted(processes.values(),
                                key=lambda p: p["pid"])}
