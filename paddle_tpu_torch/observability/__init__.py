"""Unified telemetry (the counterpart of ``paddle_tpu/observability/``).

* ``registry``: ONE process-wide MetricsRegistry. Serving, generation,
  adapters, traffic, the disaggregated tiers, executors and supervisors
  register into it, so one ``/metrics`` scrape (or ``snapshot()``)
  shows the whole stack.
* ``tracing``: spans with trace/span/parent ids (``torch.profiler.
  record_function`` ranges underneath), ``attach`` across threads,
  ``traced`` as a decorator.
* ``flight``: the always-on constant-memory flight recorder, dumped to
  JSON on a NaN rollback, a watchdog hang, an SLO breach or SIGUSR2.
* ``propagate``: the cross-process trace-context codec (``traceparent``
  headers, page-store frame heads, ``PADDLE_TRACE_*`` env for spawned
  workers) and the per-process trace index behind
  ``/v1/admin/trace/<id>``.
* ``fleet``: ``FleetAggregator`` merges every worker's ``/metrics``
  into one ``{worker=,phase=,rank=}``-labeled exposition
  (``/metrics/fleet``, ``fleet_snapshot()``); ``SLOMonitor`` computes
  the windowed deadline-miss ratio and error-budget burn over it
  (``paddle_slo_*`` gauges, a fleet-wide flight dump on sustained burn).

Flags: ``observability_metrics``, ``observability_tracing``,
``observability_flight``, ``observability_flight_capacity``,
``observability_dump_dir``, ``observability_fleet_endpoints``,
``observability_fleet_timeout_s`` and the ``slo_*`` family. The data
tiers register too: every ``reader.GeneratorLoader``
(``watch_loader``, ``paddle_reader_*``) and the pipelined step
(``overlap_telemetry``, ``paddle_step_overlap_*``). Not ported:
``watch_partition``, ``watch_collectives`` and ``watch_coordinator``
(A10).
"""

from __future__ import annotations

from . import fleet, flight, propagate, registry, tracing
from .fleet import (FleetAggregator, SLOMonitor, assemble_trace,
                    configure_fleet, default_aggregator, fleet_snapshot)
from .flight import dump as flight_dump
from .flight import install_signal_handlers
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       overlap_telemetry, step_telemetry, watch_adapters,
                       watch_disagg, watch_engine, watch_executor,
                       watch_generation, watch_loader, watch_serving,
                       watch_supervisor, watch_traffic)
from .registry import registry as get_registry
from .tracing import SpanContext, attach, current, span, traced

__all__ = [
    "registry", "tracing", "flight", "propagate", "fleet",
    "FleetAggregator", "SLOMonitor", "configure_fleet",
    "default_aggregator", "fleet_snapshot", "assemble_trace",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "get_registry",
    "span", "traced", "attach", "current", "SpanContext",
    "flight_dump", "install_signal_handlers",
    "watch_serving", "watch_engine", "watch_executor", "watch_supervisor",
    "watch_generation", "watch_traffic", "watch_disagg", "watch_adapters",
    "watch_loader", "step_telemetry", "overlap_telemetry", "snapshot",
    "to_prometheus_text",
]


def snapshot():
    """One JSON-serializable view of every registered metric family:
    the programmatic twin of ``GET /metrics``."""
    return get_registry().snapshot()


def to_prometheus_text() -> str:
    """The unified Prometheus exposition (what ServingServer's
    ``/metrics`` serves)."""
    return get_registry().to_prometheus_text()
