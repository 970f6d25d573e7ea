"""The benchmark as this tree leaves it still runs a program without the
cluster's own spans for its hot group's send and scatter and its warm
path's parts: a traced run of each cell on the CPU (short windows, as
``test_p4bench_faults.py`` runs), once on the program as it is and once
with every span outside ``FUNCTIONAL_SPANS`` suppressed, standing in for
a program that lacks them.  Both give a correct result line with the
same per-layer metrics; the span readings of ``p4bench/spans.py`` give
numbers only where their spans exist, and account for the host's rest."""
import contextlib
import time

import pytest
import torch
from repro_torch.obs import FUNCTIONAL_SPANS
from repro_torch.obs import trace as trace_mod

from p4bench import harness, spans as S

SEED = 2 ** 31 + 23
# the profiler's readings, which a CPU run has nothing for
DEVICE_TRACE = {"kernel_us", "switch_walk_smem_roofline", "device_idle_pct"}
PARTS = {"ycsb_a.allhot": ("wal-send", "scatter"),
         "tpcc.paper": ("cold-exec", "switch-sub", "commit")}
NEW = ("wal_send_us_per_txn", "scatter_us_per_txn", "cold_exec_us_per_txn",
       "switch_sub_us_per_txn", "commit_us_per_txn", "result_lag_us")


class _WithoutNewSpans(trace_mod.Trace):
    """A trace that records only the spans the JAX package names."""

    __slots__ = ()

    def span(self, name):
        if name in FUNCTIONAL_SPANS:
            return super().span(name)
        return contextlib.nullcontext()


def _traced(monkeypatch, name):
    """A traced run's result line and the program's spans (taken as the
    harness reads its evidence, before it lets the cluster go)."""
    taken = {}
    evidence = harness.Run.evidence

    def keep(run, w):
        taken["spans"] = S.of_traces(run.cluster.tracer.traces)
        taken["window"] = w
        return evidence(run, w)

    monkeypatch.setattr(harness.Run, "evidence", keep)
    # a CPU outruns the mixes' rates: four times the traffic
    pool = harness.traffic_txns
    monkeypatch.setattr(harness, "traffic_txns",
                        lambda *a, **kw: 4 * pool(*a, **kw))
    out, _ = harness.measure(harness.load_cell(name), SEED, 0.3, True,
                             torch.device("cpu"), time.perf_counter(),
                             warmup_batches=1)
    return out, taken["spans"], taken["window"]


@pytest.mark.parametrize("program", ["as_is", "without_new_spans"])
@pytest.mark.parametrize("name", sorted(PARTS))
def test_traced_run_on_either_program(monkeypatch, name, program):
    if program == "without_new_spans":
        monkeypatch.setattr(trace_mod, "Trace", _WithoutNewSpans)
    out, sp, w = _traced(monkeypatch, name)
    assert out["correct"], out["checks"]
    cell = harness.load_cell(name)
    expect = {m["name"] for m in cell["per_layer"]} - DEVICE_TRACE
    assert set(out["metrics"]) == expect
    assert not set(out["metrics"]) & set(NEW)
    assert out["breakdown"]["idle_gaps"]

    names = {s[0] for s in sp}
    txns = w["txns"]
    got = {part: S.per_txn_us(sp, part, txns) for part in PARTS[name]}
    unspanned = S.unspanned_us_per_txn(sp, w["traced_s"], txns)
    assert unspanned is not None and unspanned >= 0
    assert S.result_lag_us(sp) is None          # no device events here
    if program == "without_new_spans":
        assert names <= set(FUNCTIONAL_SPANS)
        assert all(v is None for v in got.values())
        return
    assert all(v is not None and v > 0 for v in got.values()), got
    rest = out["metrics"]["host_rest_us_per_txn"]["value"]
    if name == "ycsb_a.allhot":
        # the residual the harness reads is the send, the scatter and the
        # time outside every span, up to the spans' own cost
        assert sum(got.values()) + unspanned == pytest.approx(rest, rel=0.1)
    else:
        assert sum(got.values()) <= \
            out["metrics"]["warm_us_per_txn"]["value"]


def test_readings_of_hand_made_spans():
    """The readings on spans whose sums are known: two traces, a device
    span after each drain, one idle stretch in each span."""
    sp = [("classify", 0.0, 1.0, 0, 0), ("drain", 2.0, 4.0, 0, 0),
          ("device", 1.5, 3.0, 0, 0), ("scatter", 4.0, 5.0, 0, 0),
          ("warm", 6.0, 9.0, 0, 1), ("switch-sub", 7.0, 8.0, 1, 1),
          ("device", 7.2, 7.6, 1, 1)]
    assert S.per_txn_us(sp, "drain", 2) == pytest.approx(1e6)
    assert S.per_txn_us(sp, "commit", 2) is None
    assert sorted(S.result_lags_s(sp)) == pytest.approx([0.4, 1.0])
    assert S.result_lag_us(sp) == pytest.approx(0.7e6)
    # window 10 s, host spans cover 0-1, 2-5, 6-9: 7 s
    assert S.unspanned_us_per_txn(sp, 10.0, 2) == pytest.approx(1.5e6)
    idle = S.idle_by_span(sp, 0.0, 10.0)
    assert idle == pytest.approx({"classify": 1.0, "none": 2.5,
                                  "drain": 1.0, "scatter": 1.0, "warm": 2.0,
                                  "switch-sub": 0.6})
    assert sum(idle.values()) == pytest.approx(10.0 - 1.5 - 0.4)
