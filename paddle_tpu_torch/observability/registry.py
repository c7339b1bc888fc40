"""Process-wide metrics registry: every subsystem's counters in ONE
scrape (the counterpart of ``paddle_tpu/observability/registry.py``).

* **instruments**: labeled Counter / Gauge / Histogram handles for code
  that pushes values on a hot path. Histograms reuse the serving
  ``StreamingHistogram`` (constant memory, log-spaced buckets).
* **collectors**: pull-at-scrape-time callables for subsystems that
  keep their own locked counters (ServingMetrics, the ServingEngine's
  predictor stats, GenerationEngine, AdapterStore, TrafficController,
  the disagg store / client / service, Executor, Supervisor). The
  registry walks live instances (weak sets: a dead engine stops being
  scraped and is never pinned) only when someone asks for ``/metrics``
  or ``snapshot()``.

Naming: every family is ``paddle_<subsystem>_<what>[_<unit>]``,
counters end in ``_total``, per-instance series are told apart by labels
(``engine=``, ``ctrl=``, ``svc=``, ``store=``, ``sup=``). The series
names and label sets are the JAX package's, character for character:
dashboards and the fleet merge key on them.

The data tiers export ``paddle_reader_*{loader=}`` (``watch_loader``:
every live ``reader.GeneratorLoader``) and ``paddle_step_overlap_*``
(``overlap_telemetry``: the pipelined step's hidden feed time). Not
ported (their families are absent from the scrape):
``watch_partition`` (``paddle_partition_*{resolve=}``),
``watch_collectives`` (``paddle_collective_*{plan=}``) and
``watch_coordinator`` (``paddle_dist_*{coord=}``) with distribution,
ROADMAP A10. The port keeps no process-wide compile cache, so the JAX
package's ``paddle_dispatch_*`` family has no counterpart.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..serving.metrics import StreamingHistogram
from . import flight

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "watch_serving", "watch_engine", "watch_executor", "watch_supervisor",
    "watch_generation", "watch_traffic", "watch_disagg", "watch_adapters",
    "watch_loader", "step_telemetry", "overlap_telemetry",
]

VERSION = "0.1.0"       # paddle_tpu/version.py full_version


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class _Instrument:
    """One (family, labelset) series. The registry hands back the same
    object for the same name+labels, so hot paths can resolve once and
    hold the reference."""

    __slots__ = ("_lock", "_value", "_hist")

    def __init__(self, hist: bool = False):
        self._lock = threading.Lock()
        self._value = 0.0
        self._hist = StreamingHistogram() if hist else None

    # counters / gauges
    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        with self._lock:
            self._value -= n

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def get(self) -> float:
        with self._lock:
            return self._value

    # histograms
    def observe(self, v: float) -> None:
        with self._lock:
            self._hist.record(v)

    def hist_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return self._hist.snapshot()


class _Family:
    """A named metric family: kind + help + labeled children. Calling
    the instrument methods directly on the family addresses the
    unlabeled child (the common case)."""

    def __init__(self, name: str, kind: str, help: str = ""):
        self.name = name
        self.kind = kind
        self.help = help
        self._lock = threading.Lock()
        self._children: Dict[Tuple, _Instrument] = {}

    def labels(self, **labels) -> _Instrument:
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _Instrument(hist=self.kind == "histogram")
                self._children[key] = child
            return child

    # unlabeled convenience forwards
    def inc(self, n: float = 1) -> None:
        self.labels().inc(n)

    def dec(self, n: float = 1) -> None:
        self.labels().dec(n)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def get(self) -> float:
        return self.labels().get()

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def children(self) -> List[Tuple[Tuple, _Instrument]]:
        with self._lock:
            return list(self._children.items())


# Counter/Gauge/Histogram are the same machinery with a declared kind;
# the split exists so the exposition format can say which is which.
Counter = Gauge = Histogram = _Family


class MetricsRegistry:
    """One process-wide registry; ``registry()`` below is the global
    instance everything shares. Instrument creation is idempotent
    (same name -> same family), so rebinding call sites is safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: "Dict[str, _Family]" = {}
        self._collectors: "Dict[str, Callable[[], Dict[str, Any]]]" = {}

    # -- instruments ---------------------------------------------------------
    def _family(self, name: str, kind: str, help: str) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"not {kind}")
            return fam

    def counter(self, name: str, help: str = "") -> _Family:
        return self._family(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> _Family:
        return self._family(name, "gauge", help)

    def histogram(self, name: str, help: str = "") -> _Family:
        return self._family(name, "histogram", help)

    # -- collectors ----------------------------------------------------------
    def register_collector(self, name: str,
                           fn: Callable[[], Dict[str, Any]]) -> None:
        """``fn()`` is called at scrape time and returns either
        ``{metric_name: number}`` or ``{metric_name: [(labels, number),
        ...]}``. Names ending in ``_total`` export as counters,
        everything else as gauges."""
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(name, None)

    def _collect(self) -> Dict[str, List[Tuple[Tuple, float]]]:
        """Run every collector; one bad collector must not take down
        the whole scrape (its families just vanish until it heals)."""
        with self._lock:
            collectors = list(self._collectors.items())
        merged: Dict[str, List[Tuple[Tuple, float]]] = {}
        for _cname, fn in collectors:
            try:
                produced = fn() or {}
            except Exception:  # noqa: BLE001 — scrape must survive
                continue
            for name, v in produced.items():
                series = merged.setdefault(name, [])
                if isinstance(v, list):
                    for labels, val in v:
                        series.append((_label_key(labels or {}), float(val)))
                elif isinstance(v, (int, float)) and not isinstance(v, bool):
                    series.append(((), float(v)))
        return merged

    # -- exporters -----------------------------------------------------------
    def to_prometheus_text(self) -> str:
        lines: List[str] = []
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            children = fam.children()
            if not children:
                continue
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            if fam.kind == "histogram":
                lines.append(f"# TYPE {fam.name} summary")
                for key, child in children:
                    h = child.hist_snapshot()
                    base = _label_str(key)
                    for q, k in (("0.5", "p50"), ("0.95", "p95"),
                                 ("0.99", "p99")):
                        qkey = key + (("quantile", q),)
                        lines.append(f"{fam.name}{_label_str(qkey)} {h[k]}")
                    lines.append(f"{fam.name}_sum{base} {h['sum']}")
                    lines.append(f"{fam.name}_count{base} {h['count']}")
            else:
                lines.append(f"# TYPE {fam.name} {fam.kind}")
                for key, child in children:
                    lines.append(f"{fam.name}{_label_str(key)} {child.get()}")
        for name, series in sorted(self._collect().items()):
            kind = "counter" if name.endswith("_total") else "gauge"
            lines.append(f"# TYPE {name} {kind}")
            for key, val in series:
                lines.append(f"{name}{_label_str(key)} {val}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable point-in-time view of everything the
        registry knows (instruments + collector output)."""
        inst: Dict[str, Any] = {}
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            vals: Dict[str, Any] = {}
            for key, child in fam.children():
                vals[_label_str(key) or "_"] = (
                    child.hist_snapshot() if fam.kind == "histogram"
                    else child.get())
            if vals:
                inst[fam.name] = {"kind": fam.kind, "values": vals}
        coll: Dict[str, Any] = {}
        for name, series in self._collect().items():
            coll[name] = {_label_str(k) or "_": v for k, v in series}
        return {"instruments": inst, "collected": coll}


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


# -- built-in subsystem collectors ------------------------------------------
#
# Subsystems self-register at construction time (watch_* below); each
# watched instance gets a stable small id for its label. WeakSets keep
# registration from extending any object's lifetime — a test that
# creates 400 Executors leaks nothing into the scrape once they die.

_ids = {"count": 0}
_ids_lock = threading.Lock()


def _obs_id(obj) -> str:
    oid = getattr(obj, "_obs_id", None)
    if oid is None:
        with _ids_lock:
            _ids["count"] += 1
            oid = str(_ids["count"])
        try:
            obj._obs_id = oid
        except AttributeError:  # __slots__ without _obs_id
            oid = str(id(obj))
    return oid


_serving: "weakref.WeakSet" = weakref.WeakSet()
_engines: "weakref.WeakSet" = weakref.WeakSet()
_executors: "weakref.WeakSet" = weakref.WeakSet()
_supervisors: "weakref.WeakSet" = weakref.WeakSet()
_generation: "weakref.WeakSet" = weakref.WeakSet()
_traffic: "weakref.WeakSet" = weakref.WeakSet()
_disagg: "weakref.WeakSet" = weakref.WeakSet()
_adapters: "weakref.WeakSet" = weakref.WeakSet()
_loaders: "weakref.WeakSet" = weakref.WeakSet()


def watch_serving(metrics) -> None:
    """Called by ServingMetrics.__init__: its snapshot becomes the
    ``paddle_serving_*`` family group, one labeled series per live
    instance."""
    _obs_id(metrics)
    _serving.add(metrics)


def watch_engine(engine) -> None:
    _obs_id(engine)
    _engines.add(engine)


def watch_executor(exe) -> None:
    _executors.add(exe)


def watch_supervisor(sup) -> None:
    _obs_id(sup)
    _supervisors.add(sup)


def watch_loader(loader) -> None:
    """Called by reader.GeneratorLoader.__init__: its prefetch queue,
    resume position and stall counters become the
    ``paddle_reader_*{loader=}`` family group."""
    _obs_id(loader)
    _loaders.add(loader)


def watch_generation(metrics) -> None:
    """Called by generation.GenerationMetrics.__init__: the engine's
    counters/histograms + page-pool stats become the
    ``paddle_generation_*{engine=}`` family group — per-phase
    prefill/decode occupancy, page-pool utilization, tokens/sec, the
    TTFT / inter-token latency quantiles, and the speculative-decoding
    health series (``paddle_generation_spec_proposed_total`` /
    ``_spec_accepted_total`` / ``_spec_acceptance_rate`` /
    ``_spec_accepted_tokens_per_step``) and the radix prefix-cache
    group (``paddle_generation_radix_*``: hit volume/rate, the
    shared/private/trie page split, CoW forks, leaf evictions) in the
    one scrape."""
    _obs_id(metrics)
    _generation.add(metrics)


def watch_disagg(obj) -> None:
    """Called by disagg ctors (HostPageStore / PageStoreClient /
    DisaggService): anything exposing ``stats_numeric()`` exports as
    the ``paddle_disagg_*{svc=}`` family — pages shipped and pulled,
    wire bytes vs the fp32 bytes they replace (the <=0.3x gate is one
    division away), store hit rate, and the prefill->decode handoff
    latency quantiles."""
    _obs_id(obj)
    _disagg.add(obj)


def watch_adapters(store) -> None:
    """Called by adapters.AdapterStore.__init__: residency + pool
    accounting export as the ``paddle_adapter_*{store=}`` family —
    resident/pinned adapter counts, used vs capacity pool bytes, and
    the upload/evict churn counters (LRU and tenant-quota self-evicts
    broken out) — so "which adapters live where and is the pool
    thrashing" is the same one scrape the router reads."""
    _obs_id(store)
    _adapters.add(store)


def watch_traffic(controller) -> None:
    """Called by traffic.TrafficController.__init__: per-class/
    per-tenant admit/shed/goodput counters, queue depths, the
    deadline-miss ratio and the shed-before-batch counter become the
    ``paddle_traffic_*{ctrl=}`` family group — the admission story of
    every live controller in the one scrape a router/autoscaler
    already reads."""
    _obs_id(controller)
    _traffic.add(controller)


def _flatten(prefix: str, d: Dict[str, Any], out: Dict[str, float]) -> None:
    for k, v in d.items():
        if isinstance(v, dict):
            _flatten(f"{prefix}_{k}", v, out)
        elif isinstance(v, bool):
            out[f"{prefix}_{k}"] = int(v)
        elif isinstance(v, (int, float)):
            out[f"{prefix}_{k}"] = v


def _labeled(instances: Iterable, label: str, prefix: str,
             snap_fn) -> Dict[str, List]:
    merged: Dict[str, List] = {}
    for obj in list(instances):
        try:
            flat: Dict[str, float] = {}
            _flatten(prefix, snap_fn(obj), flat)
        except Exception:  # noqa: BLE001 — a closing instance mid-scrape
            continue
        lbl = {label: getattr(obj, "_obs_id", "?")}
        for name, v in flat.items():
            merged.setdefault(name, []).append((lbl, v))
    return merged


def _collect_serving():
    # counter families keep their _total suffix from ServingMetrics;
    # nested histogram snapshots flatten to _p50/_p95/... gauges
    return _labeled(_serving, "engine", "paddle_serving",
                    lambda m: m.snapshot())


def _collect_engines():
    return _labeled(_engines, "engine", "paddle_serving_predictor",
                    lambda e: e.predictor_stats_numeric())


def _collect_executors():
    """Aggregated across live executors (per-instance labels would be
    noise: tests mint hundreds). ``compiled_blocks`` counts the
    executor's lowered plans, the port's compiled blocks."""
    agg: Dict[str, float] = {"paddle_executor_live": 0}
    for exe in list(_executors):
        agg["paddle_executor_live"] += 1
        for k, v in exe._stats.items():
            if isinstance(v, (int, float)):
                agg[f"paddle_executor_{k}"] = agg.get(
                    f"paddle_executor_{k}", 0) + v
        agg["paddle_executor_bound_steps"] = agg.get(
            "paddle_executor_bound_steps", 0) + len(exe._bound)
        agg["paddle_executor_compiled_blocks"] = agg.get(
            "paddle_executor_compiled_blocks", 0) + len(exe._plans)
    return agg


def _collect_supervisors():
    return _labeled(_supervisors, "sup", "paddle_resilience",
                    lambda s: {k: v for k, v in s.stats().items()
                               if isinstance(v, (int, float, bool))
                               and v is not None})


def _collect_loaders():
    merged: Dict[str, List] = {}
    for loader in list(_loaders):
        lbl = {"loader": getattr(loader, "_obs_id", "?")}
        q = getattr(loader, "_obs_queue", None)
        depth = q.qsize() if q is not None else 0
        for name, v in (
                ("paddle_reader_queue_depth", depth),
                ("paddle_reader_position", loader.position()),
                ("paddle_reader_capacity", loader.capacity),
                # feed-starvation visibility: full = producer blocked
                # (consumer/device is the bottleneck), empty = consumer
                # blocked (the input pipeline is the bottleneck)
                ("paddle_reader_buffer_full_stall_total",
                 getattr(loader, "_stall_full", 0)),
                ("paddle_reader_buffer_empty_stall_total",
                 getattr(loader, "_stall_empty", 0)),
                ("paddle_reader_prefetch_depth",
                 getattr(loader, "_active_depth", 0)),
                # which slice of the sample stream this loader feeds
                # (rank sharding from the launcher env)
                ("paddle_reader_trainer_id",
                 getattr(loader, "trainer_id", 0)),
                ("paddle_reader_num_trainers",
                 getattr(loader, "num_trainers", 1)),
        ):
            merged.setdefault(name, []).append((lbl, v))
    return merged


def _collect_generation():
    # engines expose stats_numeric(): counters + flattened hist
    # snapshots + cache pool stats; nested dicts flatten to
    # paddle_generation_<group>_<field> gauges
    return _labeled(_generation, "engine", "paddle_generation",
                    lambda e: e.stats_numeric())


def _collect_traffic():
    """TrafficMetrics.collect() already emits labeled series (cls=,
    tenant=, reason=); this just stamps each with the controller's
    ctrl= id so two controllers in one process stay distinguishable."""
    merged: Dict[str, List] = {}
    for ctl in list(_traffic):
        try:
            series = ctl.metrics.collect()
        except Exception:  # noqa: BLE001 — a closing controller mid-scrape
            continue
        cid = getattr(ctl, "_obs_id", "?")
        for name, items in series.items():
            out = merged.setdefault(name, [])
            for labels, val in items:
                out.append(({**{"ctrl": cid}, **(labels or {})}, val))
    return merged


def _collect_disagg():
    return _labeled(_disagg, "svc", "paddle_disagg",
                    lambda s: s.stats_numeric())


def _collect_adapters():
    return _labeled(_adapters, "store", "paddle_adapter",
                    lambda s: s.stats_numeric())


def _collect_build_info():
    # the JAX package's label set; the port does not run on a TPU
    return {"paddle_build_info": [({"version": VERSION, "tpu": "OFF"}, 1)]}


for _name, _fn in (
    ("serving", _collect_serving),
    ("serving_predictor", _collect_engines),
    ("executor", _collect_executors),
    ("resilience", _collect_supervisors),
    ("generation", _collect_generation),
    ("traffic", _collect_traffic),
    ("disagg", _collect_disagg),
    ("adapter", _collect_adapters),
    ("reader", _collect_loaders),
    ("build_info", _collect_build_info),
):
    _REGISTRY.register_collector(_name, _fn)


# -- step telemetry ----------------------------------------------------------


class _StepTelemetry:
    """Per-step telemetry. NOT registry instruments per field: a step
    is the hottest path in the process, so all counters live behind
    ONE lock and export through a scrape-time collector like every
    other subsystem."""

    __slots__ = ("_lock", "steps", "examples", "wall_ms_sum", "hist",
                 "last_ms", "last_eps")

    def __init__(self):
        self._lock = threading.Lock()
        self.steps = 0
        self.examples = 0
        self.wall_ms_sum = 0.0
        self.hist = StreamingHistogram()
        self.last_ms = 0.0
        self.last_eps = 0.0

    def record(self, ms: float, rows: int, step: Optional[int] = None) -> None:
        with self._lock:
            self.steps += 1
            self.examples += rows
            self.wall_ms_sum += ms
            self.hist.record(ms)
            self.last_ms = ms
            if rows and ms > 0:
                self.last_eps = rows / (ms / 1e3)
        # metric sample into the crash-time ring: a flight dump shows
        # the step-time trajectory right up to the fault
        flight.note("step", step=step, ms=round(ms, 4), rows=rows)

    def collect(self) -> Dict[str, float]:
        with self._lock:
            h = self.hist.snapshot()
            out = {
                "paddle_step_total": self.steps,
                "paddle_step_examples_total": self.examples,
                "paddle_step_wall_ms_sum": round(self.wall_ms_sum, 3),
                "paddle_step_wall_ms_p50": h["p50"],
                "paddle_step_wall_ms_p99": h["p99"],
                "paddle_step_last_wall_ms": round(self.last_ms, 4),
                "paddle_step_last_examples_per_s": round(self.last_eps, 1),
            }
            if self.wall_ms_sum > 0:
                out["paddle_step_examples_per_s_avg"] = round(
                    self.examples / (self.wall_ms_sum / 1e3), 1)
            return out


_step_tel = _StepTelemetry()
_REGISTRY.register_collector("step", _step_tel.collect)


def step_telemetry() -> _StepTelemetry:
    return _step_tel


class _OverlapTelemetry:
    """Overlap accounting of the pipelined step (``BoundStep.
    run_pipelined``). Per step the feeder thread spends ``feed_ms`` of
    host work (pull, normalize, stage and copy to the card) and the
    consumer waits ``wait_ms`` for the prepared feed. Host work the
    consumer did NOT wait for ran while the previous step did:
    ``hidden_fraction`` is ``1 - wait_ms_sum / feed_ms_sum`` (clamped to
    [0, 1]); 1.0 means every feed millisecond overlapped a step, 0.0 that
    the pipeline is feed-bound."""

    __slots__ = ("_lock", "steps", "feed_ms_sum", "wait_ms_sum")

    def __init__(self):
        self._lock = threading.Lock()
        self.steps = 0
        self.feed_ms_sum = 0.0
        self.wait_ms_sum = 0.0

    def record(self, feed_ms: float, wait_ms: float) -> None:
        with self._lock:
            self.steps += 1
            self.feed_ms_sum += feed_ms
            self.wait_ms_sum += wait_ms

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            steps = self.steps
            feed = self.feed_ms_sum
            wait = self.wait_ms_sum
        hidden = 1.0 - (min(wait, feed) / feed) if feed > 0 else 0.0
        return {
            "steps": steps,
            "feed_ms_sum": round(feed, 3),
            "wait_ms_sum": round(wait, 3),
            "hidden_fraction": round(hidden, 4),
        }

    def collect(self) -> Dict[str, float]:
        s = self.snapshot()
        return {
            "paddle_step_overlap_steps_total": s["steps"],
            "paddle_step_overlap_feed_ms_sum": s["feed_ms_sum"],
            "paddle_step_overlap_wait_ms_sum": s["wait_ms_sum"],
            "paddle_step_overlap_hidden_fraction": s["hidden_fraction"],
        }


_overlap_tel = _OverlapTelemetry()
_REGISTRY.register_collector("step_overlap", _overlap_tel.collect)


def overlap_telemetry() -> _OverlapTelemetry:
    return _overlap_tel
