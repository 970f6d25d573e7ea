"""Declustered storage model (paper §4).

Given hot-transaction traces, place hot tuples into (stage, register) slots
so that as many transactions as possible execute in a single pipeline pass:

  1. build a directed weighted conflict graph over hot tuples: an edge
     (u, v, w) means u and v are co-accessed w times; direction encodes
     access-order dependencies (read-before-write etc.), bidirectional
     edges carry no ordering constraint;
  2. partition nodes into <= n_stages capacity-bounded groups maximizing
     the cut (equivalently minimizing co-located co-accesses).  The paper
     uses MQLib; this container has no MQLib, so we use greedy balanced
     seeding + local-search moves (documented in DESIGN.md) — the same
     class of max-cut heuristic;
  3. orient the partition DAG: per cut, drop the direction with the lower
     total weight (those accesses go multi-pass), topologically order the
     rest, assign partitions to stages in that order.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.packets import NOP, READ, SwitchConfig


@dataclass
class ConflictGraph:
    nodes: List[int]                              # tuple ids
    index: Dict[int, int]
    w: np.ndarray                                 # [n, n] co-access weight
    d: np.ndarray                                 # [n, n] directed weight u->v

    @staticmethod
    def from_traces(traces: Sequence[Sequence[Tuple[int, int]]]):
        """traces: per txn, ordered list of (tuple_id, op).  A dependency
        u -> v is recorded when u is accessed before v in the same txn and
        v's op is order-sensitive w.r.t. u (we conservatively treat program
        order of a read followed by any later op as a dependency)."""
        ids = sorted({t for tr in traces for t, _ in tr})
        index = {t: i for i, t in enumerate(ids)}
        n = len(ids)
        w = np.zeros((n, n), np.float64)
        d = np.zeros((n, n), np.float64)
        for tr in traces:
            seen = []
            for t, op in tr:
                i = index[t]
                for j, jop in seen:
                    if i == j:
                        continue
                    w[i, j] += 1.0
                    w[j, i] += 1.0
                    # order dependency: earlier read feeding a later op
                    if jop == READ:
                        d[j, i] += 1.0
                    else:
                        d[j, i] += 0.25      # weak program-order preference
                seen.append((i, op))
        return ConflictGraph(ids, index, w, d)


class _VersionedDict(dict):
    """A dict that counts its mutations.  ``HotIndex`` caches vectorized
    lookup arrays against ``(id(slot), slot.version)`` — so an in-place
    re-placement that keeps the SIZE constant (rotating hotspot under a
    fixed top-k, the common epoch-re-placement case) still invalidates the
    cache.  O(1) per check; no fingerprint hashing on the hot path."""

    __slots__ = ("version",)

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.version = 0

    def _bump(self):
        self.version += 1

    def __setitem__(self, k, v):
        super().__setitem__(k, v)
        self._bump()

    def __delitem__(self, k):
        super().__delitem__(k)
        self._bump()

    def update(self, *a, **kw):
        super().update(*a, **kw)
        self._bump()

    def pop(self, *a):
        out = super().pop(*a)
        self._bump()
        return out

    def popitem(self):
        out = super().popitem()
        self._bump()
        return out

    def clear(self):
        super().clear()
        self._bump()

    def setdefault(self, k, default=None):
        out = super().setdefault(k, default)
        self._bump()
        return out


@dataclass
class Placement:
    # tuple -> (switch, stage, reg); legacy 2-tuples (stage, reg) are
    # normalized to switch 0 at construction, so every consumer sees one
    # slot shape regardless of which era built the placement
    slot: Dict[int, Tuple[int, int, int]]
    stats: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        norm = _VersionedDict()
        for k, s in self.slot.items():
            dict.__setitem__(norm, k, (0, *s) if len(s) == 2 else tuple(s))
        self.slot = norm

    def lookup(self, tuple_id):
        return self.slot.get(tuple_id)


def _intra_weight(w, parts):
    total = 0.0
    for p in parts:
        if len(p) > 1:
            idx = np.asarray(p)
            total += w[np.ix_(idx, idx)].sum() / 2.0
    return total


def partition_maxcut(w: np.ndarray, k: int, capacity: int, iters: int = 4,
                     seed: int = 0):
    """Capacity-bounded multiway max-cut via greedy seeding + local search.

    Returns list of k lists of node indices (some possibly empty)."""
    n = w.shape[0]
    rng = np.random.default_rng(seed)
    # greedy: place nodes in descending degree into the partition with the
    # least connection weight to it (max-cut greedy) that has room
    order = np.argsort(-w.sum(1))
    parts = [[] for _ in range(k)]
    load = np.zeros(k, int)
    conn = np.zeros((k, n))                      # weight(part, node)
    assign = np.full(n, -1, int)
    for u in order:
        cand = [p for p in range(k) if load[p] < capacity]
        p = min(cand, key=lambda q: (conn[q, u], load[q]))
        parts[p].append(int(u))
        assign[u] = p
        load[p] += 1
        conn[p] += w[u]
    # local search: move a node to a lighter-connected partition if it
    # reduces intra-partition weight
    for _ in range(iters):
        improved = False
        for u in rng.permutation(n):
            p = assign[u]
            best, best_gain = p, 0.0
            for q in range(k):
                if q == p or load[q] >= capacity:
                    continue
                gain = conn[p, u] - conn[q, u]
                if gain > best_gain + 1e-12:
                    best, best_gain = q, gain
            if best != p:
                parts[p].remove(int(u))
                parts[best].append(int(u))
                assign[u] = best
                load[p] -= 1
                load[best] += 1
                conn[p] -= w[u]
                conn[best] += w[u]
                improved = True
        if not improved:
            break
    return parts, assign


def partition_mincut(w: np.ndarray, k: int, capacity: int, iters: int = 4,
                     seed: int = 0):
    """Capacity-bounded multiway MIN-cut: the level-1 (cross-switch)
    partitioner.  Opposite objective of ``partition_maxcut``: co-accessed
    tuples should land on the SAME switch (a txn spanning switches pays an
    inter-switch hop and cannot single-pass), so nodes greedily join the
    partition they are most connected to; unconnected nodes spread to the
    least-loaded switch, balancing capacity.  Local-search moves chase
    heavier-connected partitions.  Returns (parts, assign) like
    ``partition_maxcut``."""
    n = w.shape[0]
    rng = np.random.default_rng(seed)
    order = np.argsort(-w.sum(1))
    parts = [[] for _ in range(k)]
    load = np.zeros(k, int)
    conn = np.zeros((k, n))
    assign = np.full(n, -1, int)
    for u in order:
        cand = [p for p in range(k) if load[p] < capacity]
        p = max(cand, key=lambda q: (conn[q, u], -load[q]))
        parts[p].append(int(u))
        assign[u] = p
        load[p] += 1
        conn[p] += w[u]
    for _ in range(iters):
        improved = False
        for u in rng.permutation(n):
            p = assign[u]
            best, best_gain = p, 0.0
            for q in range(k):
                if q == p or load[q] >= capacity:
                    continue
                gain = conn[q, u] - conn[p, u]
                if gain > best_gain + 1e-12:
                    best, best_gain = q, gain
            if best != p:
                parts[p].remove(int(u))
                parts[best].append(int(u))
                assign[u] = best
                load[p] -= 1
                load[best] += 1
                conn[p] -= w[u]
                conn[best] += w[u]
                improved = True
        if not improved:
            break
    return parts, assign


def cross_partition_weight(w: np.ndarray, parts) -> float:
    """Total co-access weight crossing partition boundaries (the min-cut
    objective; each undirected pair counted once)."""
    total = w.sum() / 2.0
    return float(total - _intra_weight(w, parts))


def order_partitions(d: np.ndarray, parts):
    """Topologically order partitions by directed cut weight; backward
    edges (minority direction per cut) are dropped and counted (those
    accesses become multi-pass).  Greedy minimum-feedback-arc ordering."""
    k = len(parts)
    pw = np.zeros((k, k))
    for a in range(k):
        for b in range(k):
            if a == b or not parts[a] or not parts[b]:
                continue
            pw[a, b] = d[np.ix_(parts[a], parts[b])].sum()
    remaining = [p for p in range(k)]
    order = []
    dropped = 0.0
    while remaining:
        # pick the partition with the least incoming weight from remaining
        best = min(remaining,
                   key=lambda p: sum(pw[q, p] for q in remaining if q != p))
        dropped += sum(pw[q, best] for q in remaining if q != best)
        order.append(best)
        remaining.remove(best)
    kept = pw.sum() - dropped
    return order, kept, dropped


def _check_capacity(n_tuples: int, switch: SwitchConfig):
    """A placement must fit the register file; truncating silently would
    leave "hot" tuples unreachable on the switch (classified hot by the
    index but with no slot), so over-capacity hot sets are an error the
    caller must handle by shrinking top_k (paper Fig 17 models graceful
    degradation by capping top_k, not by overflowing)."""
    if n_tuples > switch.total_slots:
        raise ValueError(
            f"hot set of {n_tuples} tuples exceeds switch register "
            f"capacity {switch.n_switches} switches x {switch.n_stages} "
            f"stages x {switch.regs_per_stage} regs = {switch.total_slots}; "
            f"reduce top_k or enlarge the switch config")


def make_layout(traces, switch: SwitchConfig, seed: int = 0) -> Placement:
    """2-level declustered placement.  Level 1 (``n_switches > 1`` only):
    partition the conflict graph ACROSS switches minimizing cross-switch
    co-access (``partition_mincut`` — a txn spanning switches pays an
    inter-switch hop).  Level 2: the paper's stage/reg declustering
    (``partition_maxcut`` + ``order_partitions``) runs per shard on the
    subgraph.  With one switch, level 1 is the identity and the placement
    is byte-identical to the pre-sharding pipeline."""
    g = ConflictGraph.from_traces(traces)
    n = len(g.nodes)
    if n == 0:
        return Placement({}, {"single_pass_rate": 1.0})
    _check_capacity(n, switch)
    if switch.n_switches == 1:
        shards = [list(range(n))]
        cross_w = 0.0
    else:
        sw_parts, _ = partition_mincut(g.w, switch.n_switches,
                                       switch.slots_per_switch, seed=seed)
        shards = [sorted(p) for p in sw_parts]
        cross_w = cross_partition_weight(g.w, sw_parts)
    slot = {}
    intra = kept_w = dropped_w = 0.0
    for sw_id, members in enumerate(shards):
        if not members:
            continue
        idx = np.asarray(members)
        sub_w = g.w[np.ix_(idx, idx)]
        sub_d = g.d[np.ix_(idx, idx)]
        parts, _ = partition_maxcut(sub_w, switch.n_stages,
                                    switch.regs_per_stage, seed=seed)
        order, kept, dropped = order_partitions(sub_d, parts)
        for stage, p in enumerate(order):
            for r, u in enumerate(sorted(parts[p])):
                slot[g.nodes[int(idx[u])]] = (sw_id, stage, r)
        intra += _intra_weight(sub_w, parts)
        kept_w += kept
        dropped_w += dropped
    pl = Placement(slot)
    pl.stats = dict(
        intra_weight=intra,
        kept_direction_weight=float(kept_w),
        dropped_direction_weight=float(dropped_w),
        single_pass_rate=single_pass_rate(traces, pl),
    )
    if switch.n_switches > 1:
        pl.stats["cross_switch_weight"] = cross_w
    return pl


def random_layout(traces, switch: SwitchConfig, seed: int = 0) -> Placement:
    """Worst-case baseline of §7.6.3: tuples assigned to stages randomly
    (and, with ``n_switches > 1``, to switches randomly — the draw space
    is the N*S virtual stage array, so the single-switch sequence of draws
    is untouched)."""
    ids = sorted({t for tr in traces for t, _ in tr})
    _check_capacity(len(ids), switch)
    rng = np.random.default_rng(seed)
    n_vstages = switch.n_switches * switch.n_stages
    slot = {}
    used = collections.Counter()
    for t in ids:
        s = int(rng.integers(n_vstages))
        if used[s] >= switch.regs_per_stage:   # stage full: redraw among
            room = [q for q in range(n_vstages)   # stages with room
                    if used[q] < switch.regs_per_stage]
            s = room[int(rng.integers(len(room)))]
        slot[t] = (s // switch.n_stages, s % switch.n_stages, used[s])
        used[s] += 1
    pl = Placement(slot)
    pl.stats = dict(single_pass_rate=single_pass_rate(traces, pl))
    return pl


def txn_stage_sequence(trace, placement: Placement):
    """Per-access (switch, stage) ordering keys — lexicographic tuple
    order equals the global-stage pipeline order the packet layer encodes
    (``switch * n_stages + stage``)."""
    return [placement.slot[t][:2] for t, _ in trace if t in placement.slot]


def trace_reorderable(trace) -> bool:
    """Ops with no intra-txn dependencies (no repeated tuple, no ADDP
    read-dependent write) may be issued in any order — the node sorts the
    packet's instructions by stage before sending (paper §6.1: the
    partition manager knows each tuple's stage)."""
    from repro_torch.core.packets import ADDP
    ids = [t for t, _ in trace]
    if len(set(ids)) != len(ids):
        return False
    return all(op != ADDP for _, op in trace)


def txn_is_single_pass(trace, placement: Placement) -> bool:
    """Single pass iff the access sequence can be issued in strictly
    increasing stage order: reorderable txns only need pairwise-distinct
    stages; dependency-ordered txns need program order to increase
    (paper §4.1)."""
    ids = [t for t, _ in trace]
    if len(set(ids)) != len(ids):
        return False
    seq = txn_stage_sequence(trace, placement)
    if trace_reorderable(trace):
        return len(set(seq)) == len(seq)
    return all(b > a for a, b in zip(seq, seq[1:]))


def single_pass_rate(traces, placement: Placement) -> float:
    if not traces:
        return 1.0
    ok = sum(txn_is_single_pass(tr, placement) for tr in traces)
    return ok / len(traces)
