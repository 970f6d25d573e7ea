"""Readings of the program's own spans (``repro_torch.obs.trace``): the
traced window's spans as plain tuples ``(name, t0, t1, depth, trace)``,
in each trace's order, and what the per-layer readings of the host's
parts and of the card's device time make of them.

A reading returns None where the program records none of the spans it
reads, so a program without them gives no reading rather than a wrong
one.  The harness's evidence does not carry these spans yet
(``harness.Run.evidence``), so no metric reads them; ``tools/
trace_spans.py`` does, on the card.
"""
from __future__ import annotations

import statistics

DEVICE = "device"


def of_traces(traces) -> list:
    """Every closed span of ``traces`` as (name, t0, t1, depth, trace)."""
    return [(s.name, s.t0, s.t1, s.depth, i)
            for i, tr in enumerate(traces) for s in tr.spans
            if s.t1 is not None]


def per_txn_us(spans, name: str, txns: int):
    """Host us a transaction in the spans named ``name``."""
    d = [t1 - t0 for n, t0, t1, _, _ in spans if n == name]
    if not d or not txns:
        return None
    return sum(d) / txns * 1e6


def result_lags_s(spans) -> list:
    """For each ``device`` span, the end of the host span that took its
    results (the one right before it in its trace) less its own end."""
    out = []
    for j in range(1, len(spans)):
        name, _, t1, _, tr = spans[j]
        prev = spans[j - 1]
        if name == DEVICE and prev[4] == tr and prev[0] != DEVICE:
            out.append(prev[2] - t1)
    return out


def result_lag_us(spans):
    """Median over dispatches of the results' wait on the host, us."""
    lags = result_lags_s(spans)
    return statistics.median(lags) * 1e6 if lags else None


def union_s(intervals) -> float:
    """Seconds covered by the union of (t0, t1) intervals."""
    total, end = 0.0, None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def unspanned_us_per_txn(spans, window_s: float, txns: int):
    """Host us a transaction outside every depth-0 program span (device
    spans left out): the window less the union of those spans."""
    host = [(t0, t1) for n, t0, t1, d, _ in spans if d == 0 and n != DEVICE]
    if not host or not txns:
        return None
    return (window_s - union_s(host)) / txns * 1e6


def idle_by_span(spans, t0: float, t1: float) -> dict:
    """The card's idle seconds in [t0, t1] (outside every ``device``
    span), put down to the innermost host span open at the time, or
    ``none``."""
    busy, cut = [], []
    for n, a, b, d, _ in spans:
        (busy if n == DEVICE else cut).append((a, b, d, n))
    edges = {t0, t1}
    for a, b, _, _ in busy + cut:
        edges.update((min(max(a, t0), t1), min(max(b, t0), t1)))
    edges = sorted(edges)
    busy.sort()
    cut.sort()
    out = {}
    open_, bi, ci = [], 0, 0          # host spans open: (depth, t0, t1, name)
    busy_until = -float("inf")
    for a, b in zip(edges, edges[1:]):
        while bi < len(busy) and busy[bi][0] <= a:
            busy_until = max(busy_until, busy[bi][1])
            bi += 1
        while ci < len(cut) and cut[ci][0] <= a:
            s0, s1, d, n = cut[ci]
            open_.append((d, s0, s1, n))
            ci += 1
        open_ = [o for o in open_ if o[2] > a]
        if busy_until >= b:
            continue
        name = max(open_)[3] if open_ else "none"
        out[name] = out.get(name, 0.0) + (b - a)
    return out
