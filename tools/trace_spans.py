"""The program's spans on the card: one traced run of a benchmark cell
(``p4bench/harness.py``'s set-up, window and check, its profiler window
included) with ``device_events`` set on the cluster's tracer, then the
readings of ``p4bench/spans.py`` beside the harness's own per-layer
metrics, one JSON line a run:

* ``wal_send_us_per_txn``, ``scatter_us_per_txn`` (a hot group's send
  records and result scatter), ``cold_exec_us_per_txn``,
  ``switch_sub_us_per_txn``, ``commit_us_per_txn`` (the warm path's
  parts), ``result_lag_us`` (the median wait of a dispatch's results on
  the host), ``unspanned_us_per_txn`` (host time outside every program
  span);
* the anchor's skew (a second anchor's miss), the ``device`` spans and
  the dispatches, the ``device`` spans left open, the share of the warm
  path's ``device`` spans outside their ``switch-sub`` (as read, and
  beyond the skew), and the card's idle seconds by the innermost span
  open;
* the collector's passes in the window (``run.collector``), and the
  WAL's counters (``Cluster.wal_counters``, absent from a program without
  them): the segments unpacked inside the window, those held packed at
  its end, and the share of the logged records they hold;
* ``--costs``: the host us a timed dispatch adds (a B = 1 sync dispatch
  of the TPC-C cell's shape, a B = 512 deferred one of the YCSB cell's,
  timed and untimed in turns; ``settle`` after each turn, outside the
  time), each CUDA call's host us, and whether an event pair read in
  reverse order gives a negative time;
* ``--span-costs``: the host us a txn that the port-only host spans add
  to an untraced run, windows with them and stubbed in turns in one
  process (``span_costs``).

Usage, from the repository root (a CUDA card; ``--device cpu`` runs the
same at a small size without the profiler, events or costs):

    python3 tools/trace_spans.py [--cells ycsb_a.allhot,tpcc.paper]
        [--seeds 11,12] [--seconds 10] [--events 1] [--costs]
        [--span-costs ROUNDS] [--span-seconds 2]
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from p4bench import run as bench_run  # noqa: E402

PARTS = {"wal_send_us_per_txn": "wal-send", "scatter_us_per_txn": "scatter",
         "cold_exec_us_per_txn": "cold-exec",
         "switch_sub_us_per_txn": "switch-sub",
         "commit_us_per_txn": "commit"}


def sync_outside(spans, slack: float):
    """(outside, all) of the ``device`` spans right after a ``switch-sub``
    span: outside it by more than ``slack`` seconds."""
    out = n = 0
    for j in range(1, len(spans)):
        name, t0, t1, _, tr = spans[j]
        sub = spans[j - 1]
        if name == "device" and sub[0] == "switch-sub" and sub[4] == tr:
            n += 1
            out += t0 < sub[1] - slack or t1 > sub[2] + slack
    return out, n


def traced(name, seed, seconds, device, events, warmup=None):
    from p4bench import harness, spans as S
    from p4bench.reference import compare
    cell = harness.load_cell(name)
    run = harness.Run(cell, seed, seconds, device, trace=True,
                      warmup_batches=warmup)
    # a CPU outruns the mixes' rates: four times the traffic there
    run.setup(n_txns=None if device.type == "cuda" else
              4 * harness.traffic_txns(cell, seconds, run.warmup))
    tracer = run.cluster.tracer
    tracer.device_events = events
    wal0 = wal_counters(run.cluster)
    t0 = time.perf_counter()
    w = run.window()
    t1 = time.perf_counter()
    wal1 = wal_counters(run.cluster)
    t_settle = time.perf_counter()
    left_open = tracer.settle()
    settle_s = time.perf_counter() - t_settle
    sp = S.of_traces(tracer.traces)
    got = run.outputs()
    ev = run.evidence(w)
    ev["setup_s"] = 0.0
    correct, _ = compare.judge(run.check(got))
    line = dict(cell=name, seed=seed, events=events, correct=correct,
                txns=w["txns"], traced_s=w["traced_s"],
                profiled=ev["profile"] is not None)
    for m in cell["per_layer"]:
        line[m["name"]] = harness.read_metric(m["name"], ev)
    for metric, span in PARTS.items():
        line[metric] = S.per_txn_us(sp, span, w["txns"])
    line["result_lag_us"] = S.result_lag_us(sp)
    line["unspanned_us_per_txn"] = S.unspanned_us_per_txn(
        sp, w["traced_s"], w["txns"])
    skew = [abs(v) for v in tracer.anchor_skew_s.values()]
    line["anchor_skew_us"] = [v * 1e6 for v in
                              tracer.anchor_skew_s.values()]
    line["device_spans"] = sum(s[0] == "device" for s in sp)
    line["dispatches"] = run.counters["dispatches"]
    line["device_open"] = left_open
    line["settle_us_a_span"] = settle_s / max(line["device_spans"], 1) * 1e6
    lags = S.result_lags_s(sp)
    if lags:
        line["result_lag_us_min_max"] = [min(lags) * 1e6, max(lags) * 1e6]
    line["sync_device_outside"] = sync_outside(sp, 0.0)
    line["sync_device_outside_beyond_skew"] = sync_outside(
        sp, max(skew, default=0.0))
    # the window's profiler set-up and reading fall outside every span
    line["profiler_own_s"] = run.profiler_s
    line["idle_by_span_s"] = S.idle_by_span(sp, t0, t1) if events else None
    line["collector"] = run.collector
    if wal1 is not None:
        line["wal_unpacked_in_window"] = sum(wal1["unpacked"]) - sum(
            wal0["unpacked"])
        line["wal_packed_segments"] = wal1["packed"]
        line["wal_packed_share"] = wal1["packed_records"] / max(
            wal1["records"], 1)
    return line, run


def wal_counters(c):
    """The WAL's counters now, or None where the program has none."""
    if not hasattr(c, "wal_counters"):
        return None
    from repro_torch.obs.names import G_WAL_PACKED, G_WAL_UNPACKED
    got = c.wal_counters()
    return dict(packed=got[G_WAL_PACKED], unpacked=got[G_WAL_UNPACKED],
                packed_records=sum(n.wal.packed_segments
                                   * n.wal.segment_size for n in c.nodes),
                records=sum(len(n.wal) for n in c.nodes))


def _us(fn, reps):
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def parts(eng, reps=2001):
    """Median host us of each CUDA call a timed dispatch adds, on the
    last engine's stream."""
    import torch
    from repro_torch.obs.trace import Span, Tracer
    dev = eng.device
    stream = torch.cuda.current_stream(dev)
    made = torch.cuda.Event(enable_timing=True)
    made.record(stream)
    a, b = eng.stamp(), eng.stamp()
    torch.cuda.synchronize(dev)
    tracer = Tracer()
    tracer.anchor(dev, eng.stamp)
    tr = tracer.start("parts")

    def took():
        tr.spans.clear()
        s = Span("drain", 0.0, 0.0)
        tr.spans.append(s)
        tracer.took(tr, s, dev, (a, b))

    def settled():
        took()
        tracer.settle()

    def med(fn):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize(dev)
        return statistics.median(ts)

    return {
        "timing Event() made": med(lambda: torch.cuda.Event(
            enable_timing=True)),
        "timing Event() made + recorded": med(lambda: torch.cuda.Event(
            enable_timing=True).record(stream)),
        "plain Event() made + recorded": med(
            lambda: torch.cuda.Event().record(stream)),
        "an event recorded again": med(lambda: made.record(stream)),
        "current_stream()": med(lambda: torch.cuda.current_stream(dev)),
        "engine stamp()": med(eng.stamp),
        "query() done": med(a.query),
        "elapsed_time()": med(lambda: a.elapsed_time(b)),
        "took() of a done pair": med(took),
        "took() + settle() of a done pair": med(settled),
    }


def costs(runs, rounds=4, reps=400):
    """Host us a dispatch, timed and untimed in turns, on the engines of
    the runs' clusters (their checks are done; the registers move on)."""
    import torch
    from repro_torch.core.packets import build_packets
    from repro_torch.db.txn import Txn
    from repro_torch.obs.trace import Span, Tracer
    out = {}
    for name, run in runs.items():
        c = run.cluster
        eng, hi, cfg = c.switch, c.hot_index, c.switch_cfg
        if name.startswith("tpcc"):
            t = run.batches[0][0]
            txns = [Txn(t.kind, [op for op in t.ops if hi.is_hot(op[1])],
                        t.home, tid=t.tid)]
            kw = dict(mode="auto")
        else:
            txns = run.batches[0]
            kw = dict(mode="auto", defer=True)
        pkts, meta = build_packets(txns, hi, cfg)
        tracer = Tracer()
        tracer.device_events = True
        tr = tracer.start("costs")
        tracer.anchor(eng.device, eng.stamp)

        def untimed():
            eng.execute_batch(pkts, meta, **kw).results_np()

        def timed():
            pb = eng.execute_batch(pkts, meta, timed=True, **kw)
            pb.results_np()
            took = Span("drain", 0.0, 0.0)      # the span taking results
            tr.spans.append(took)
            tracer.took(tr, took, eng.device, pb.timing)

        for fn in (untimed, timed):
            _us(fn, 50)
        got = {"untimed": [], "timed": []}
        for _ in range(rounds):
            for label, fn in (("untimed", untimed), ("timed", timed),
                              ("timed", timed), ("untimed", untimed)):
                torch.cuda.synchronize()
                got[label].append(_us(fn, reps))
                tracer.settle()
                tr.spans.clear()
        med = {k: statistics.median(v) for k, v in got.items()}
        out[name] = dict(turns_us=got, median_us=med,
                         added_us=med["timed"] - med["untimed"],
                         device_open=tracer.settle())
    out["parts_us"] = parts(eng)
    eng = next(iter(runs.values())).cluster.switch
    first, second = eng.stamp(), eng.stamp()
    second.synchronize()
    try:
        out["reverse_elapsed_ms"] = second.elapsed_time(first)
    except RuntimeError as e:
        out["reverse_elapsed_ms"] = f"raised: {e}"
    return out


def span_costs(name, seed, seconds, rounds, device):
    """Host us a txn that the port-only host spans (``PORT_SPANS``) add to
    a cell's untraced run (the cluster's default tracer traces every
    batch), in one process: windows of ``seconds`` with them and with
    ``dbms._span`` stubbed for their names, in turns (A B B A), beside one
    span's median host us times the spans a txn records."""
    import contextlib
    from p4bench import harness
    from repro_torch.db import dbms
    from repro_torch.obs import PORT_SPANS
    from repro_torch.obs.trace import Tracer
    cell = harness.load_cell(name)
    run = harness.Run(cell, seed, seconds, device)
    run.setup(n_txns=harness.traffic_txns(cell, 4 * rounds * seconds))
    orig = dbms._span

    def stub(tr, n):
        return contextlib.nullcontext() if n in PORT_SPANS else orig(tr, n)

    got = {"spans": [], "stubbed": []}
    for _ in range(rounds):
        for label in ("spans", "stubbed", "stubbed", "spans"):
            dbms._span = orig if label == "spans" else stub
            run.cluster.tracer.clear()
            try:
                w = run.window()
            finally:
                dbms._span = orig
            got[label].append(w["window_s"] / w["txns"] * 1e6)
    traces = list(run.cluster.tracer.traces)      # the last window's
    new = sum(s.name in PORT_SPANS for tr in traces for s in tr.spans)
    per_txn = new / (len(traces) * run.batch)
    tr = Tracer().start("costs")

    def one():
        with orig(tr, "commit"):
            pass
        tr.spans.clear()

    one_us = statistics.median(_us(one, 2000) for _ in range(9))
    med = {k: statistics.median(v) for k, v in got.items()}
    return dict(cell=name, us_per_txn=got, median_us_per_txn=med,
                added_us_per_txn=med["spans"] - med["stubbed"],
                added_share=med["spans"] / med["stubbed"] - 1,
                new_spans_per_txn=per_txn, one_span_us=one_us,
                predicted_us_per_txn=one_us * per_txn)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="ycsb_a.allhot,tpcc.paper")
    ap.add_argument("--seeds", default="11")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--events", default="1")
    ap.add_argument("--costs", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--span-costs", type=int, default=0, metavar="ROUNDS",
                    help="then ROUNDS of A B B A windows a cell, spans on "
                         "and stubbed (see span_costs)")
    ap.add_argument("--span-seconds", type=float, default=2.0)
    a = ap.parse_args()
    if a.device == "cuda":
        bench_run._environment()          # as a benchmark run: re-execs
    import torch
    device = torch.device(a.device)
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(f"card: {smi}; torch {torch.__version__}", flush=True)
    last = {}
    for seed in [int(x) for x in a.seeds.split(",")]:
        for name in a.cells.split(","):
            for events in [bool(int(e)) for e in a.events.split(",")]:
                line, run = traced(name, seed, a.seconds, device,
                                   events and device.type == "cuda",
                                   None if device.type == "cuda" else 1)
                print(json.dumps(line), flush=True)
                if a.costs:
                    last[name] = run
    if a.costs and device.type == "cuda":
        print(json.dumps(dict(costs=costs(last))), flush=True)
    for name in a.cells.split(",") if a.span_costs else ():
        print(json.dumps(dict(span_costs=span_costs(
            name, int(a.seeds.split(",")[0]) + 1, a.span_seconds,
            a.span_costs, device))), flush=True)


if __name__ == "__main__":
    main()
