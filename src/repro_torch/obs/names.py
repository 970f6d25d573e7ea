"""One shared name table for the two metric surfaces.

The functional layer historically exposes ``Cluster.stats`` (a Counter with
short keys like ``hot``/``commits``) and the sim layer a result dict with its
own spelling (``throughput``, ``commits`` as a per-class dict, ``lat_*``
means).  This module is the single mapping between those legacy keys and the
canonical Prometheus-style metric names the registry/exporter use.  The
legacy keys stay valid forever -- they are the *aliases*; tests and benches
keep reading them -- while anything scraping the registry sees one vocabulary
across both layers.
"""

from __future__ import annotations

import re

# --------------------------------------------------------------------------
# Cluster.stats key -> (canonical metric name, help text).
#
# Semantics note (pinned by tests/test_dbms.py::test_hot_counter_semantics):
# "hot" counts *admissions*, exactly once per hot txn in both the per-txn and
# batch paths; "cold"/"warm" count execution *attempts* (each 2PL retry after
# an abort bumps them again).  "commits" is per committed txn.
# --------------------------------------------------------------------------
STAT_NAMES = {
    "hot":            ("txns_hot_total", "hot-classified admissions (once per txn)"),
    "cold":           ("txn_attempts_cold_total", "cold execution attempts incl. retries"),
    "warm":           ("txn_attempts_warm_total", "warm execution attempts incl. retries"),
    "commits":        ("txns_committed_total", "committed transactions"),
    "aborts":         ("txn_aborts_total", "2PL aborts (before any retry)"),
    "gave_up":        ("txns_gave_up_total", "txns dropped after exhausting retries"),
    "early_aborts":   ("txn_early_aborts_total", "in-flight conflicts aborted before completing doomed round-trips"),
    "wasted_ops":     ("txn_wasted_ops_total", "ops executed by eventually-aborted attempts"),
    "demoted_brownout": ("txns_demoted_brownout_total", "hot admissions demoted to cold during switch brown-out"),
    "brownouts":      ("switch_brownouts_total", "switch brown-out windows entered"),
    "multipass":      ("switch_multipass_total", "hot txns needing >1 switch pass"),
    "distributed":    ("txns_distributed_total", "cold/warm txns spanning >1 node (2PC)"),
    "checkpoints":    ("checkpoints_total", "checkpoints taken"),
    "switch_reads":   ("reads_switch_total", "point reads served from switch registers"),
    "store_reads":    ("reads_store_total", "point reads served from node stores"),
    "scan_rows_shipped": ("scan_rows_shipped_total", "rows shipped to scans"),
    "scans_switch":   ("scans_switch_total", "scans served via switch read tier"),
    "recoveries":     ("switch_recoveries_total", "switch register-plane recoveries"),
    "failovers":      ("failovers_total", "warm-standby failovers"),
    "migrations":     ("migrations_total", "hot-set migrations executed"),
    "migrated_tuples": ("migrated_tuples_total", "tuples moved by migrations"),
    "cross_switch_weight": ("layout_cross_switch_weight", "access weight crossing shards"),
}

# Sim result-dict key -> canonical name (scalar keys only; dict-valued keys
# are unified by unify_sim_result below).
SIM_ALIASES = {
    "throughput":    "throughput_txns_per_second",
    "switch_rounds": "switch_rounds_total",
    "avg_batch":     "switch_batch_size_avg",
}

# Span vocabularies (trace point names, in causal order).
FUNCTIONAL_SPANS = ("classify", "packet-build", "dispatch", "drain")
SIM_SPANS = ("admission", "batcher-join", "switch-service", "commit")

# Shared histogram / gauge names used by both instrumented layers.
H_TXN_LATENCY = "txn_latency_seconds"
H_BATCH_SERVICE = "batch_service_seconds"
H_DRAIN = "drain_seconds"
H_READ_BATCH = "read_batch_seconds"
H_PHASE = "phase_seconds"
H_ADMISSION_WAIT = "admission_wait_seconds"
H_RETRIES = "txn_retries"
G_INFLIGHT = "inflight_batches"
G_SHARD_DISPATCHES = "shard_dispatches"
G_WAL_RECORDS = "wal_records"
G_UTILIZATION = "resource_utilization"
C_ARRIVALS = "arrivals_total"
C_DROPPED = "admission_dropped_total"

_SAN = re.compile(r"[^a-zA-Z0-9_]")


def sanitize(key: str) -> str:
    return _SAN.sub("_", str(key))


def stat_metric(key):
    """Canonical (name, help) for a Cluster.stats key; unknown keys get a
    generated ``stat_<key>_total`` name so nothing is ever dropped."""
    try:
        return STAT_NAMES[key]
    except KeyError:
        return (f"stat_{sanitize(key)}_total", f"legacy stat counter {key!r}")


def unify_cluster_stats(stats) -> dict:
    """Cluster.stats -> {canonical name: value}."""
    return {stat_metric(k)[0]: v for k, v in stats.items()}


def unify_sim_result(out) -> dict:
    """ClusterSim result dict -> {canonical name: value}.

    Per-class dicts fold into the same totals the functional layer reports,
    so `txns_committed_total` / `txns_hot_total` / `txn_aborts_total` mean
    the same thing on both surfaces.
    """
    uni = {}
    commits = out.get("commits", {})
    uni["txns_committed_total"] = sum(commits.values())
    uni["txns_hot_total"] = commits.get("hot", 0)
    uni["txn_aborts_total"] = sum(out.get("aborts", {}).values())
    for old, new in SIM_ALIASES.items():
        if old in out:
            uni[new] = out[old]
    lat = {k[len("lat_"):]: v for k, v in out.items() if k.startswith("lat_")}
    if lat:
        uni["latency_mean_seconds"] = lat
    return uni
