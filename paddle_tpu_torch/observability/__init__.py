"""The part of ``paddle_tpu/observability/`` the training supervisor
calls: the crash-time flight recorder (``flight.note``, ``flight.dump``)
and trace spans (``tracing.span``, ``tracing.enabled``). The metrics
registry, the exporters, fleet aggregation and the SLO monitor are
ROADMAP A9."""

from . import flight, tracing  # noqa: F401

__all__ = ["flight", "tracing"]
