"""Open-loop load generation and the functional serving front end.

Arrival processes are generated up front as numpy arrays of absolute arrival
times (seed-deterministic, vectorized -- a million Poisson arrivals is one
``rng.exponential`` call).  The functional driver ``serve_open_loop`` plays a
txn stream against a real ``Cluster``: txns arrive on a virtual clock, queue
in a bounded backlog (admission control drops the newest arrival when full),
and are served in ``run_batch`` batches whose *service times are measured
wall-clock* on the real engines, then accounted onto ``lanes`` virtual
service lanes.  Latency for every txn is (batch completion - arrival) on the
virtual clock, recorded into fixed-bucket histograms for p50/p99/p999.

This is deliberately the textbook open-loop harness: offered load is set by
the arrival process, not by completions, so pushing the rate past capacity
makes the backlog -- and the tail -- blow up, which is exactly the knee
``find_knee`` looks for.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from .names import C_ARRIVALS, C_DROPPED, H_TXN_LATENCY
from .registry import MetricsRegistry


# --------------------------------------------------------------------------
# Arrival processes (absolute times, seconds, seed-deterministic)
# --------------------------------------------------------------------------

def poisson_arrivals(rate: float, n: int, seed: int = 0, t0: float = 0.0) -> np.ndarray:
    """n Poisson arrivals at `rate`/s: cumulative iid exponential gaps."""
    if n <= 0:
        return np.empty(0, dtype=np.float64)
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    return t0 + np.cumsum(gaps)


def bursty_arrivals(rate: float, n: int, seed: int = 0, t0: float = 0.0,
                    burst: int = 16, cv: float = 4.0) -> np.ndarray:
    """Bursty arrivals at mean `rate`/s: Poisson bursts of geometric size.

    Arrivals come in bursts of mean size ``burst`` (geometric), with
    exponential gaps between bursts scaled so the long-run rate is `rate`;
    within a burst, gaps are `cv`x shorter.  Squared coefficient of variation
    of the gap process rises with `burst`, stressing tail latency at the same
    mean load.
    """
    if n <= 0:
        return np.empty(0, dtype=np.float64)
    rng = np.random.default_rng(seed)
    sizes = []
    total = 0
    while total < n:
        s = int(rng.geometric(1.0 / burst))
        sizes.append(s)
        total += s
    gaps = np.empty(total, dtype=np.float64)
    i = 0
    # Time budget per burst of size s is s/rate in expectation: (s-1) short
    # intra-burst gaps at cv-times the base rate, remainder on the lead gap.
    for s in sizes:
        lead_mean = max(1e-12, s / rate - (s - 1) / (rate * cv))
        gaps[i] = rng.exponential(lead_mean)
        if s > 1:
            gaps[i + 1:i + s] = rng.exponential(1.0 / (rate * cv), size=s - 1)
        i += s
    return t0 + np.cumsum(gaps[:n])


# --------------------------------------------------------------------------
# Functional serving driver
# --------------------------------------------------------------------------

class ServeResult(dict):
    """Result row of one offered-load point (plain dict for JSON)."""
    __slots__ = ()


def serve_open_loop(cluster, txns, arrivals, batch: int = 64, lanes: int = 1,
                    max_backlog: int | None = None,
                    gather_window: float = 0.0,
                    registry: MetricsRegistry | None = None,
                    clock=time.perf_counter) -> ServeResult:
    """Serve `txns[i]` arriving at `arrivals[i]` against a live Cluster.

    The driver is single-threaded: each dispatched batch is executed
    synchronously (``run_batch`` + ``drain``) and its measured wall-clock
    service time is charged to the least-loaded of ``lanes`` virtual lanes,
    which models a front end with `lanes` independent service pipelines
    without needing real threads (the engines are the bottleneck either way).

    ``gather_window`` > 0 is the group-commit knob (the functional mirror
    of the sim's ``batch_window``): a lane with a partial batch waits up to
    that long past the head txn's arrival for the batch to fill before
    dispatching.  Batch-amortized engines pay a per-dispatch device cost,
    so without a window light load degenerates to batch-of-one dispatches
    and capacity collapses to the per-dispatch rate; the window trades a
    bounded latency floor for full batch amortization.
    """
    n = min(len(txns), len(arrivals))
    reg = registry if registry is not None else MetricsRegistry()
    h_all = reg.histogram(H_TXN_LATENCY, help="arrival-to-completion latency", klass="all")
    c_arr = reg.counter(C_ARRIVALS, help="client arrivals offered")
    c_drop = reg.counter(C_DROPPED, help="arrivals dropped by admission control")

    backlog: deque[int] = deque()
    lane_free = [0.0] * max(1, lanes)
    vclock = 0.0
    next_i = 0
    served = 0
    dropped = 0
    backlog_peak = 0
    busy = 0.0
    t_last_done = 0.0

    def admit_until(t):
        nonlocal next_i, dropped, backlog_peak
        while next_i < n and arrivals[next_i] <= t:
            c_arr.inc()
            if max_backlog is not None and len(backlog) >= max_backlog:
                dropped += 1
                c_drop.inc()
            else:
                backlog.append(next_i)
                if len(backlog) > backlog_peak:
                    backlog_peak = len(backlog)
            next_i += 1

    while next_i < n or backlog:
        if not backlog:
            # Idle: jump the virtual clock to the next arrival.
            vclock = max(vclock, float(arrivals[next_i]))
            admit_until(vclock)
            continue
        lane = min(range(len(lane_free)), key=lane_free.__getitem__)
        start = max(vclock, lane_free[lane])
        admit_until(start)  # arrivals that landed while the lane was busy
        if gather_window > 0.0 and len(backlog) < batch and next_i < n:
            # hold a partial batch until it fills or the head txn has
            # waited out the gather window, whichever comes first
            deadline = float(arrivals[backlog[0]]) + gather_window
            while (len(backlog) < batch and next_i < n
                   and float(arrivals[next_i]) <= deadline):
                start = max(start, float(arrivals[next_i]))
                admit_until(start)
            if len(backlog) < batch and deadline > start:
                start = deadline
            vclock = start
        take = [backlog.popleft() for _ in range(min(batch, len(backlog)))]
        t0 = clock()
        cluster.run_batch([txns[i] for i in take])
        cluster.drain()
        dt = clock() - t0
        finish = start + dt
        lane_free[lane] = finish
        busy += dt
        t_last_done = max(t_last_done, finish)
        lats = [finish - float(arrivals[i]) for i in take]
        h_all.observe_many(lats)
        served += len(take)
        vclock = start

    makespan = max(t_last_done, float(arrivals[n - 1]) if n else 0.0)
    offered = n / float(arrivals[n - 1]) if n and arrivals[n - 1] > 0 else 0.0
    return ServeResult(
        offered_rate=offered,
        achieved_rate=served / makespan if makespan > 0 else 0.0,
        served=served,
        arrivals=n,
        dropped=dropped,
        backlog_peak=backlog_peak,
        utilization=busy / (len(lane_free) * makespan) if makespan > 0 else 0.0,
        p50=h_all.percentile(0.50),
        p99=h_all.percentile(0.99),
        p999=h_all.percentile(0.999),
        mean=h_all.mean,
    )


def find_knee(rows, achieved_frac: float = 0.9):
    """Saturation knee from a sweep of ServeResult rows (any dicts with
    offered_rate/achieved_rate): the highest offered rate still achieving
    >= `achieved_frac` of offered.  Returns 0.0 if no point qualifies."""
    knee = 0.0
    for r in sorted(rows, key=lambda r: r["offered_rate"]):
        if r["offered_rate"] > 0 and r["achieved_rate"] >= achieved_frac * r["offered_rate"]:
            knee = r["offered_rate"]
    return knee
