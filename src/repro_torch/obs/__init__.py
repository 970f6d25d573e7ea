"""Telemetry plane of the port (copy of ``repro.obs``): metrics registry,
per-txn traces, Prometheus/JSON export and open-loop load generation."""

from .names import (FUNCTIONAL_SPANS, SIM_SPANS, STAT_NAMES, stat_metric,
                    unify_cluster_stats, unify_sim_result)
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       OccupancyMeter, StatsCounter, log_bucket_bounds)
from .trace import Span, Trace, Tracer
from .export import parse_prometheus, to_json, to_prometheus
from .load import bursty_arrivals, find_knee, poisson_arrivals, serve_open_loop

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "OccupancyMeter",
    "StatsCounter", "log_bucket_bounds",
    "Span", "Trace", "Tracer",
    "parse_prometheus", "to_json", "to_prometheus",
    "poisson_arrivals", "bursty_arrivals", "serve_open_loop", "find_knee",
    "STAT_NAMES", "stat_metric", "unify_cluster_stats", "unify_sim_result",
    "FUNCTIONAL_SPANS", "SIM_SPANS",
]
