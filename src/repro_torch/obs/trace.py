"""Lightweight per-txn tracing.

A ``Trace`` is a label plus an ordered list of ``Span``s (name, t0, t1,
depth).  Spans come from either the context-manager form (functional layer,
wall clock) or explicit timestamps (DES layer, stamped from sim time).  A
``Tracer`` hands out traces with deterministic counter-based sampling -- no
RNG -- and keeps the most recent ``capacity`` traces in a ring, so tracing a
million-arrival run costs O(capacity) memory.

Determinism contract (pinned by tests/test_obs.py): two identical runs
produce identical sequences of (trace label, span names, depths); on the DES
side the timestamps are identical too, because they are sim time.
"""

from __future__ import annotations

import collections
import contextlib
import time


class Span:
    __slots__ = ("name", "t0", "t1", "depth")

    def __init__(self, name, t0, t1=None, depth=0):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.depth = depth

    @property
    def duration(self):
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    def __repr__(self):
        return f"Span({self.name!r}, {self.t0:.6g}..{self.t1 if self.t1 is None else round(self.t1, 9)}, d{self.depth})"


class Trace:
    __slots__ = ("label", "spans", "_stack", "_clock")

    def __init__(self, label, clock=time.perf_counter):
        self.label = label
        self.spans = []
        self._stack = []
        self._clock = clock

    @contextlib.contextmanager
    def span(self, name):
        s = Span(name, self._clock(), depth=len(self._stack))
        self.spans.append(s)
        self._stack.append(s)
        try:
            yield s
        finally:
            self._stack.pop()
            s.t1 = self._clock()

    def add_span(self, name, t0, t1, depth=0):
        """Explicit-timestamp form (DES side: t0/t1 are sim time)."""
        self.spans.append(Span(name, t0, t1, depth))

    def names(self):
        return [s.name for s in self.spans]

    def to_dict(self):
        return {
            "label": self.label,
            "spans": [{"name": s.name, "t0": s.t0, "t1": s.t1, "depth": s.depth}
                      for s in self.spans],
        }


class Tracer:
    """Deterministic sampling tracer with a bounded ring of retained traces.

    ``start(label)`` returns a ``Trace`` for every ``sample_every``-th call
    and ``None`` otherwise; call sites must tolerate ``None`` (span recording
    is skipped).  Sampling is a plain modulo counter, never a clock or RNG,
    so identical runs trace identical txns.
    """

    def __init__(self, clock=time.perf_counter, capacity=256, sample_every=1):
        self.clock = clock
        self.capacity = capacity
        self.sample_every = max(1, int(sample_every))
        self.traces = collections.deque(maxlen=capacity)
        self.started = 0
        self._n = 0

    def start(self, label):
        self._n += 1
        if (self._n - 1) % self.sample_every:
            return None
        tr = Trace(label, clock=self.clock)
        self.traces.append(tr)
        self.started += 1
        return tr

    def clear(self):
        self.traces.clear()
        self.started = 0
        self._n = 0
