"""Runtime heat tracking — the observability half of adaptive hot-set
management (copy of ``repro/core/heat.py``; the port's epoch controller
is ``repro_torch.db.migrate``).

The paper (§3.1) detects the hot set OFFLINE from a representative trace
and bakes the placement into the switch program; a workload whose skew
drifts silently degrades to the cold path.  This module supplies the
runtime signal the epoch controller (repro.db.migrate, repro.sim.model)
re-places from:

  * ``HeatTracker`` — exponentially-decayed per-tuple access counters fed
    from the DBMS hot path (``Cluster.run`` / ``Cluster.run_batch``) or
    the timing sim's admission loop, plus a bounded window of recent
    access traces.  The decayed counters answer "what is hot NOW"
    (``top_k``); the trace window preserves co-access structure so
    ``layout.make_layout`` can rebuild a declustered placement for the
    new hot set.

  * ``CountMinSketch`` — a memory-bounded alternative to the exact
    counter dict (Cheetah's argument: switch-adjacent state must live
    under tight memory budgets).  ``HeatTracker(sketch=...)`` counts
    through the sketch and keeps only the window's key set as top-k
    candidates; estimates never under-count, so heavy hitters are never
    missed, only (rarely) over-ranked.

Determinism: all tie-breaks are by ascending key, so the same access
stream always yields the same ``top_k`` — the adaptive sim and the
functional controller stay replayable from a seed.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

class CountMinSketch:
    """Conservative count-min sketch over int64 keys (vectorized numpy).

    ``depth`` multiply-shift hash rows of ``width`` float counters;
    ``estimate`` returns the row minimum, an upper bound on the true
    count.  ``scale`` multiplies every counter — the decay hook."""

    def __init__(self, width: int = 2048, depth: int = 4, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.width = int(width)
        self.depth = int(depth)
        self.table = np.zeros((self.depth, self.width), np.float64)
        # multiply-shift hashing: h(k) = ((a*k + b) mod 2^64) >> 32, a odd
        # — wraparound multiplication IS the modulus, fully vectorized
        self._a = rng.integers(1, 1 << 62, self.depth,
                               np.uint64) | np.uint64(1)
        self._b = rng.integers(0, 1 << 62, self.depth, np.uint64)

    def _rows(self, keys: np.ndarray) -> np.ndarray:
        """[depth, n] column index per hash row."""
        k = np.asarray(keys, np.int64).astype(np.uint64)[None, :]
        with np.errstate(over="ignore"):
            h = (self._a[:, None] * k + self._b[:, None]) >> np.uint64(32)
        return (h % np.uint64(self.width)).astype(np.int64)

    def add(self, keys, count: float = 1.0):
        keys = np.asarray(keys, np.int64).ravel()
        if keys.size == 0:
            return
        cols = self._rows(keys)
        for d in range(self.depth):
            np.add.at(self.table[d], cols[d], count)

    def estimate(self, keys) -> np.ndarray:
        keys = np.asarray(keys, np.int64).ravel()
        if keys.size == 0:
            return np.zeros(0, np.float64)
        cols = self._rows(keys)
        per_row = np.stack([self.table[d][cols[d]]
                            for d in range(self.depth)])
        return per_row.min(axis=0)

    def scale(self, factor: float):
        self.table *= factor


class HeatTracker:
    """Decayed per-tuple access heat + a bounded recent-trace window.

    ``observe_trace`` is the single feed point: it bumps every accessed
    tuple's heat by 1 and appends the trace to the window.  The epoch
    controller calls ``top_k`` (hot-set candidates, hottest first) and
    ``window_traces`` (co-access structure for re-layout), then
    ``advance_epoch`` to decay history so a shifted hotspot overtakes the
    old one within a couple of epochs.

    With ``sketch=None`` (default) counts are exact in a dict; pass a
    ``CountMinSketch`` to bound counter memory — candidates then come
    from the window's key set, so memory is O(window * ops_per_txn +
    sketch)."""

    def __init__(self, window: int = 2048, decay: float = 0.25,
                 sketch: Optional[CountMinSketch] = None):
        if not (0.0 <= decay < 1.0):
            raise ValueError(f"decay must be in [0, 1), got {decay}")
        self.decay = float(decay)
        self.window: collections.deque = collections.deque(maxlen=window)
        self.sketch = sketch
        self.counts: Dict[int, float] = collections.defaultdict(float)
        self.n_observed = 0          # traces seen (lifetime)
        self.epoch = 0

    # ------------------------------------------------------------- feed --
    def observe_trace(self, trace: Sequence[Tuple[int, int]]):
        """trace: ordered [(tuple_id, op), ...] of one transaction."""
        self.n_observed += 1
        self.window.append(tuple(trace))
        if self.sketch is not None:
            self.sketch.add([t for t, _ in trace])
        else:
            for t, _ in trace:
                self.counts[t] += 1.0

    # ------------------------------------------------------------ query --
    def heat(self, key: int) -> float:
        if self.sketch is not None:
            return float(self.sketch.estimate([key])[0])
        return self.counts.get(key, 0.0)

    def _candidates(self) -> List[int]:
        if self.sketch is not None:
            return sorted({t for tr in self.window for t, _ in tr})
        return list(self.counts)

    def top_k(self, k: int) -> List[int]:
        """The k hottest tuples, hottest first; ties break by ascending
        key so identical access streams give identical hot sets."""
        cand = self._candidates()
        if not cand:
            return []
        if self.sketch is not None:
            est = self.sketch.estimate(cand)
            scored = list(zip(cand, est.tolist()))
        else:
            scored = [(t, self.counts[t]) for t in cand]
        scored.sort(key=lambda kv: (-kv[1], kv[0]))
        return [t for t, _ in scored[:k]]

    def window_traces(self) -> List[Tuple[Tuple[int, int], ...]]:
        return list(self.window)

    # ------------------------------------------------------------ epoch --
    def advance_epoch(self):
        """Decay all heat by ``decay`` (and drop negligible exact
        counters so the dict stays bounded by the live key set)."""
        self.epoch += 1
        if self.sketch is not None:
            self.sketch.scale(self.decay)
            return
        if self.decay == 0.0:
            self.counts.clear()
            return
        dead = []
        for t in self.counts:
            self.counts[t] *= self.decay
            if self.counts[t] < 1e-3:
                dead.append(t)
        for t in dead:
            del self.counts[t]
