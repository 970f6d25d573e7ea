"""Offline hot-set detection (paper §3.1): replay a representative workload
statement-by-statement, count per-tuple access frequencies, offload the
top-k to the switch.  The resulting hot index (tuple -> (switch, stage,
reg)) is replicated to every database node's partition manager."""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.layout import Placement, make_layout
from repro_torch.core.packets import READ, SwitchConfig


def access_frequencies(traces: Sequence[Sequence[Tuple[int, int]]]):
    freq = collections.Counter()
    for tr in traces:
        for t, _ in tr:
            freq[t] += 1
    return freq


def detect_hotset(traces, top_k: int) -> List[int]:
    freq = access_frequencies(traces)
    return [t for t, _ in freq.most_common(top_k)]


@dataclass
class HotIndex:
    """Replicated per-node index over hot tuples (paper §6.1): tells a node
    whether a txn is hot/cold/warm and how to build the switch packet.

    Besides the dict interface, the index exposes sorted numpy lookup
    arrays (built lazily, cached) so the batched packet builder can map
    whole key vectors to (switch, stage, reg) slots with one
    ``searchsorted`` — no per-key Python dict probes on the hot path."""
    placement: Placement
    _keys: Optional[np.ndarray] = field(default=None, repr=False,
                                        compare=False)
    _switches: Optional[np.ndarray] = field(default=None, repr=False,
                                            compare=False)
    _stages: Optional[np.ndarray] = field(default=None, repr=False,
                                          compare=False)
    _regs: Optional[np.ndarray] = field(default=None, repr=False,
                                        compare=False)
    _cache_token: object = field(default=None, repr=False, compare=False)

    def is_hot(self, tuple_id) -> bool:
        return tuple_id in self.placement.slot

    def classify(self, trace) -> str:
        hits = [self.is_hot(t) for t, _ in trace]
        if all(hits):
            return "hot"
        if not any(hits):
            return "cold"
        return "warm"

    def slot(self, tuple_id):
        return self.placement.slot[tuple_id]

    # ------------------------------------------------- vectorized lookup --
    def _ensure_arrays(self):
        # invalidate on the placement-dict *version*, not its size: a
        # same-size in-place re-placement (rotating hotspot under epoch
        # re-placement / shard rebalancing) must not serve stale slots
        slot = self.placement.slot
        token = (id(slot), getattr(slot, "version", None))
        if self._keys is None or self._cache_token != token:
            items = sorted(slot.items())
            norm = [(k, s if len(s) == 3 else (0, *s)) for k, s in items]
            self._keys = np.array([k for k, _ in norm], np.int64)
            self._switches = np.array([w for _, (w, _, _) in norm], np.int32)
            self._stages = np.array([s for _, (_, s, _) in norm], np.int32)
            self._regs = np.array([r for _, (_, _, r) in norm], np.int32)
            self._cache_token = token

    def hot_mask_np(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized ``is_hot`` over a key vector."""
        self._ensure_arrays()
        keys = np.asarray(keys, np.int64)
        if self._keys.size == 0:
            return np.zeros(keys.shape, bool)
        idx = np.searchsorted(self._keys, keys)
        idx = np.minimum(idx, self._keys.size - 1)
        return self._keys[idx] == keys

    def slots_np(self, keys: np.ndarray):
        """Vectorized ``slot`` over a key vector of hot tuples.

        Returns (switch [n], stage [n], reg [n]) int32 arrays; raises
        KeyError if any key is not hot (mirrors the dict lookup)."""
        self._ensure_arrays()
        keys = np.asarray(keys, np.int64)
        if keys.size == 0:
            z = np.zeros(0, np.int32)
            return z, z.copy(), z.copy()
        idx = np.searchsorted(self._keys, keys) if self._keys.size else None
        if idx is None or (idx >= self._keys.size).any() or \
                (self._keys[np.minimum(idx, self._keys.size - 1)]
                 != keys).any():
            missing = keys[~self.hot_mask_np(keys)]
            raise KeyError(f"keys not in hot index: {missing[:4].tolist()}")
        return self._switches[idx], self._stages[idx], self._regs[idx]


def layout_for_hotset(traces, hot, switch: SwitchConfig,
                      layout_fn=make_layout, seed: int = 0) -> Placement:
    """Filter traces to a chosen hot set and lay it out — the shared
    tail of every placement pipeline: offline (``build_hot_index``), the
    functional epoch controller (db.migrate) and the sim controller
    (sim.model) all re-place through this one path."""
    hot = set(hot)
    hot_traces = [[(t, op) for t, op in tr if t in hot] for tr in traces]
    hot_traces = [tr for tr in hot_traces if tr]
    # the hot SET, not the trace sample, defines membership: a chosen
    # tuple absent from the observed window (tail key the sample missed,
    # counts outliving the bounded window) still gets a slot — as a
    # singleton trace it carries no co-access constraints
    seen = {t for tr in hot_traces for t, _ in tr}
    hot_traces += [[(t, READ)] for t in sorted(hot - seen)]
    return layout_fn(hot_traces, switch, seed=seed)


def build_hot_index(traces, top_k: int, switch: SwitchConfig,
                    layout_fn=make_layout, seed: int = 0) -> HotIndex:
    hot = detect_hotset(traces, top_k)
    return HotIndex(layout_for_hotset(traces, hot, switch,
                                      layout_fn=layout_fn, seed=seed))
