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


class DeviceSpan(Span):
    """A dispatch's time on ``card``, open (``t0`` NaN, ``t1`` None) until
    ``Tracer.settle`` reads its (start, end) timing events."""
    __slots__ = ("card", "pair")

    def __init__(self, card, pair, depth):
        super().__init__("device", float("nan"), depth=depth)
        self.card, self.pair = card, pair


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

    Device time (the port's cluster): with ``device_events`` set on an
    instance, every switch dispatch of a traced batch records a timing
    event pair around its job on the stream the job runs on, and the host
    taking its results hands the pair to ``took``, which puts an open
    ``device`` span right after the span that took them.  ``settle()``,
    called by whoever reads the traces (after the window's last sync),
    closes each such span on this tracer's clock through one anchor per
    card a window (``anchor``).  Off by default: then nothing is recorded.
    """

    device_events = False

    def __init__(self, clock=time.perf_counter, capacity=256, sample_every=1):
        self.clock = clock
        self.capacity = capacity
        self.sample_every = max(1, int(sample_every))
        self.traces = collections.deque(maxlen=capacity)
        self.started = 0
        self._n = 0
        self._anchors = {}      # card -> (anchor event, clock reading)
        self.anchor_skew_s = {}  # card -> the second anchor's miss, s

    def start(self, label):
        self._n += 1
        if (self._n - 1) % self.sample_every:
            return None
        tr = Trace(label, clock=self.clock)
        self.traces.append(tr)
        self.started += 1
        return tr

    def clear(self):
        """Start a new window: forget the traces and the anchors."""
        self.traces.clear()
        self.started = 0
        self._n = 0
        self._anchors.clear()
        self.anchor_skew_s.clear()

    # ------------------------------------------------------- device time --
    def anchor(self, card, stamp) -> bool:
        """Tie ``card``'s event clock to this tracer's clock, once a
        window: ``stamp()`` records a timing event on the card's stream
        (None where the card has no events, as on the CPU), which is
        waited for and read against the clock.  A second anchor right
        after it measures the tie's uncertainty: ``anchor_skew_s[card]``
        is the second reading less the first's prediction of it.  True
        where ``card`` has an anchor."""
        if card in self._anchors:
            return True
        first = stamp()
        if first is None:
            return False
        first.synchronize()
        t_first = self.clock()
        second = stamp()
        second.synchronize()
        t_second = self.clock()
        self._anchors[card] = (first, t_first)
        self.anchor_skew_s[card] = t_second - (
            t_first + first.elapsed_time(second) * 1e-3)
        return True

    def took(self, trace, span, card, pair):
        """The host took the results of a dispatch on ``card`` timed by
        ``pair`` (start, end events) inside ``span``, the last span of
        ``trace``: an open ``device`` span goes right after it, and
        ``settle`` closes it.  Reading the events costs more host time
        than recording them, so that waits for the reader."""
        trace.spans.append(DeviceSpan(card, pair, span.depth))

    def settle(self) -> int:
        """Close every open ``device`` span of the retained traces whose
        end event has completed, without waiting on a card; returns how
        many stay open."""
        left = 0
        for trace in self.traces:
            for s in trace.spans:
                if s.t1 is not None or not isinstance(s, DeviceSpan):
                    continue
                start, end = s.pair
                if s.card not in self._anchors or not end.query():
                    left += 1
                    continue
                ev, t = self._anchors[s.card]
                s.t0 = t + ev.elapsed_time(start) * 1e-3
                s.t1 = t + ev.elapsed_time(end) * 1e-3
                s.pair = None
        return left
