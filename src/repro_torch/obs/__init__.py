"""Telemetry plane of the port (copy of ``repro.obs``): metrics registry,
per-txn traces and Prometheus/JSON export.  Open-loop load generation
(``repro.obs.load``) is not ported yet."""

from .names import (FUNCTIONAL_SPANS, SIM_SPANS, STAT_NAMES, stat_metric,
                    unify_cluster_stats, unify_sim_result)
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       OccupancyMeter, StatsCounter, log_bucket_bounds)
from .trace import Span, Trace, Tracer
from .export import parse_prometheus, to_json, to_prometheus

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "OccupancyMeter",
    "StatsCounter", "log_bucket_bounds",
    "Span", "Trace", "Tracer",
    "parse_prometheus", "to_json", "to_prometheus",
    "STAT_NAMES", "stat_metric", "unify_cluster_stats", "unify_sim_result",
    "FUNCTIONAL_SPANS", "SIM_SPANS",
]
