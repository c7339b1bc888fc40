"""paddle_tpu_torch.traffic: the traffic tier (the counterpart of
``paddle_tpu/traffic/``), between the HTTP front end and the engines.

* ``admission``: priority classes (``interactive`` / ``batch`` /
  ``best_effort``), per-tenant token-bucket quotas, per-adapter quotas,
  per-class / per-tenant bounded queues.
* ``controller``: ``TrafficController``, deadline-aware scheduling
  (service-time estimates from the live ``paddle_step_*`` quantiles;
  provably unmeetable deadlines shed before they cost a batch slot,
  with a Retry-After from the measured drain rate), strict priority
  with aging, and a flight dump on a sustained SLO breach.
* ``frontend``: ``WorkerPool``, spawned serving processes behind
  SO_REUSEPORT (or the ``ThinRouter``), with a zero-drop rolling
  restart.

Everything exports ``paddle_traffic_*`` series into the unified
observability registry.

    from paddle_tpu_torch.serving import ServingEngine, ServingServer
    from paddle_tpu_torch import traffic

    ctl = traffic.TrafficController(engine, generation_engine=gen)
    srv = ServingServer(engine, traffic=ctl)     # X-Tenant, X-Priority
    ctl.stats()
"""

from .admission import (
    BATCH,
    BEST_EFFORT,
    CLASSES,
    INTERACTIVE,
    ClassQueues,
    TenantSpec,
    TokenBucket,
    TrafficConfig,
    parse_adapter_quotas,
    parse_tenants,
)
from .controller import (
    ServiceTimeEstimator,
    TrafficController,
    TrafficShed,
    TrafficTicket,
    engine_retry_after,
    generation_retry_after,
)
from .frontend import ThinRouter, WorkerPool, reuseport_supported
from .metrics import TrafficMetrics

__all__ = [
    "CLASSES", "INTERACTIVE", "BATCH", "BEST_EFFORT",
    "TokenBucket", "TenantSpec", "parse_tenants", "parse_adapter_quotas",
    "TrafficConfig",
    "ClassQueues", "TrafficMetrics",
    "TrafficController", "TrafficTicket", "TrafficShed",
    "ServiceTimeEstimator", "engine_retry_after", "generation_retry_after",
    "WorkerPool", "ThinRouter", "reuseport_supported",
]
