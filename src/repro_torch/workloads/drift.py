"""Drift generators: workloads whose hot set MOVES over time.

The paper's placements are derived offline from a representative trace
(§3.1); these generators produce the traces that break that assumption —
flash-sale hotspot shifts, diurnal zipf rotation, TPC-C warehouse
rotation — so the adaptive controller (repro.db.migrate for the
functional layer, ``SystemConfig.reconfig_interval`` in the timing sim)
has something to chase.

Common protocol (duck-typed, used by ``ClusterSim``'s dynamic mode and
``benchmarks/bench_adaptive.py``):

  * ``period`` — seconds of simulated time per phase;
  * ``phase_of(t)`` — the phase active at time ``t``;
  * ``sample(rng, t, home=None)`` — one transaction drawn from the
    distribution active at ``t`` (``home`` pins the issuing node, e.g.
    to the simulated worker's node);
  * ``sample_phase(rng, phase, n)`` — n transactions from one phase
    (used to build the initial/static placement and oracle layouts);
  * ``hot_keys_at(t)`` — ground truth: the keys the generator is
    currently concentrating load on (the per-epoch oracle reads this;
    the adaptive controller must *estimate* it from observed accesses).

Determinism: generators are stateless — every sample is a pure function
of (rng state, t) — so the same seed always reproduces the same
transaction stream, even when one instance serves several runs
(pinned in tests/test_adaptive.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.packets import ADD, READ, WRITE
from repro_torch.db.txn import Txn, key_of
from repro_torch.workloads import tpcc
from repro_torch.workloads.ycsb import WRITE_FRAC


@dataclass
class YCSBHotspotShift:
    """YCSB whose hot block jumps every ``period`` seconds (flash-sale /
    diurnal hotspot drift).

    Each node's key space holds ``n_blocks`` disjoint candidate blocks of
    ``hot_per_node`` keys; phase p concentrates ``p_hot_txn`` of the load
    on block ``p mod n_blocks``.  Within the block, op j draws from
    hot-key class ``j mod ops_per_txn`` — the same co-access structure
    the static YCSB generator has, so a correctly-placed hot set stays
    single-pass.  Cold keys come from beyond the candidate blocks, so a
    cold key never becomes hot later."""
    n_nodes: int = 8
    keys_per_node: int = 100_000
    hot_per_node: int = 50
    p_hot_txn: float = 0.75
    dist_frac: float = 0.2
    ops_per_txn: int = 8
    variant: str = "A"
    period: float = 4e-3
    n_blocks: int = 8

    def phase_of(self, t: float) -> int:
        return int(t // self.period)

    def _base(self, phase: int) -> int:
        return (phase % self.n_blocks) * self.hot_per_node

    def hot_keys_at(self, t: float) -> List[int]:
        b = self._base(self.phase_of(t))
        return [key_of(n, b + i) for n in range(self.n_nodes)
                for i in range(self.hot_per_node)]

    def sample(self, rng: np.random.Generator, t: float,
               home: Optional[int] = None) -> Txn:
        base = self._base(self.phase_of(t))
        wf = WRITE_FRAC[self.variant]
        home = int(rng.integers(self.n_nodes)) if home is None else home
        hot = rng.random() < self.p_hot_txn
        cold_lo = self.n_blocks * self.hot_per_node
        ops = []
        for j in range(self.ops_per_txn):
            remote = rng.random() < self.dist_frac
            node = int(rng.integers(self.n_nodes)) if remote else home
            if hot:
                cls = j % self.ops_per_txn
                members = range(base + cls, base + self.hot_per_node,
                                self.ops_per_txn)
                k = key_of(node, int(rng.choice(list(members))))
            else:
                k = key_of(node, int(rng.integers(cold_lo,
                                                  self.keys_per_node)))
            if rng.random() < wf:
                ops.append((WRITE, k, int(rng.integers(0, 1000))))
            else:
                ops.append((READ, k, 0))
        return Txn(f"ycsb_{self.variant}_shift", ops, home)

    def sample_phase(self, rng: np.random.Generator, phase: int,
                     n: int) -> List[Txn]:
        t = phase * self.period
        return [self.sample(rng, t) for _ in range(n)]


@dataclass
class RotatingZipf:
    """Zipf-popular keys whose rank->key mapping rotates each phase.

    Rank r (0 = hottest) maps to key ``(r * stride + phase * shift) mod
    keys_per_node`` on the op's node; every phase the whole popularity
    ladder slides by ``shift`` keys, so yesterday's head becomes today's
    tail.  Unlike the block-shift generator, heat here is graded (a zipf
    tail), so the tracker's top-k genuinely has to rank keys rather than
    spot a block."""
    n_nodes: int = 8
    keys_per_node: int = 10_000
    hot_per_node: int = 50
    zipf_s: float = 1.3
    ops_per_txn: int = 4
    write_frac: float = 0.5
    dist_frac: float = 0.2
    period: float = 4e-3
    shift: int = 997          # co-prime with keys_per_node: full coverage
    stride: int = 1

    def phase_of(self, t: float) -> int:
        return int(t // self.period)

    def _key(self, phase: int, rank: int, node: int) -> int:
        local = (rank * self.stride + phase * self.shift) \
            % self.keys_per_node
        return key_of(node, local)

    def hot_keys_at(self, t: float) -> List[int]:
        ph = self.phase_of(t)
        return [self._key(ph, r, n) for n in range(self.n_nodes)
                for r in range(self.hot_per_node)]

    def _rank(self, rng: np.random.Generator) -> int:
        while True:
            r = int(rng.zipf(self.zipf_s))
            if r <= self.keys_per_node:
                return r - 1

    def sample(self, rng: np.random.Generator, t: float,
               home: Optional[int] = None) -> Txn:
        ph = self.phase_of(t)
        home = int(rng.integers(self.n_nodes)) if home is None else home
        ops = []
        for _ in range(self.ops_per_txn):
            remote = rng.random() < self.dist_frac
            node = int(rng.integers(self.n_nodes)) if remote else home
            k = self._key(ph, self._rank(rng), node)
            if rng.random() < self.write_frac:
                ops.append((WRITE, k, int(rng.integers(0, 1000))))
            else:
                ops.append((READ, k, 0))
        return Txn("zipf_rot", ops, home)

    def sample_phase(self, rng: np.random.Generator, phase: int,
                     n: int) -> List[Txn]:
        t = phase * self.period
        return [self.sample(rng, t) for _ in range(n)]


@dataclass
class TPCCWarehouseRotation:
    """TPC-C NewOrder/Payment where the ACTIVE warehouse window rotates
    every phase (regional business hours): phase p serves warehouses
    ``[p*active, p*active + active) mod n_warehouses``, so the hot
    ytd/district/stock columns of sleeping warehouses go cold and the
    waking ones must be migrated in.

    Unlike the key-value generators, ``sample``'s ``home`` argument is
    IGNORED here: a TPC-C transaction homes at its warehouse's node
    (``w % n_nodes``), exactly as the static generator does."""
    n_nodes: int = 8
    n_warehouses: int = 16
    active: int = 4
    dist_frac: float = 0.2
    items_per_order: int = 10
    n_items: int = 100_000
    n_customers: int = 3000
    period: float = 4e-3

    def __post_init__(self):
        self._p = tpcc.TPCCParams(n_nodes=self.n_nodes,
                                  n_warehouses=self.n_warehouses,
                                  dist_frac=self.dist_frac,
                                  items_per_order=self.items_per_order,
                                  n_items=self.n_items,
                                  n_customers=self.n_customers)

    def phase_of(self, t: float) -> int:
        return int(t // self.period)

    def active_warehouses(self, phase: int) -> List[int]:
        start = (phase * self.active) % self.n_warehouses
        return [(start + i) % self.n_warehouses for i in range(self.active)]

    def hot_keys_at(self, t: float) -> List[int]:
        p = self._p
        ks = []
        for w in self.active_warehouses(self.phase_of(t)):
            ks.append(tpcc.w_ytd(p, w))
            for d in range(tpcc.N_DISTRICTS):
                ks += [tpcc.d_next_oid(p, w, d), tpcc.d_ytd(p, w, d)]
            for i in range(tpcc.HOT_ITEMS):
                ks.append(tpcc.stock(p, w, i))
        return ks

    def sample(self, rng: np.random.Generator, t: float,
               home: Optional[int] = None) -> Txn:
        p = self._p
        act = self.active_warehouses(self.phase_of(t))
        w = act[int(rng.integers(len(act)))]
        home = w % self.n_nodes                      # txns home at their wh
        d = int(rng.integers(tpcc.N_DISTRICTS))
        if rng.random() < 0.5:
            ops = [(ADD, tpcc.d_next_oid(p, w, d), 1)]
            qty = {}
            for _ in range(self.items_per_order):
                iw = w
                if rng.random() < self.dist_frac:
                    iw = act[int(rng.integers(len(act)))]
                if rng.random() < 0.7:
                    item = int(rng.integers(tpcc.HOT_ITEMS))
                else:
                    item = int(rng.integers(tpcc.HOT_ITEMS, self.n_items))
                k = tpcc.stock(p, iw, item)
                qty[k] = qty.get(k, 0) - int(rng.integers(1, 5))
            ops += [(ADD, k, v) for k, v in qty.items()]
            # order-row ids come from the rng, not an instance counter:
            # the stream stays a pure function of (seed, t) even when one
            # generator instance serves several runs (static / adaptive /
            # oracle share it, and the oracle controller samples mid-run)
            for _ in range(1 + self.items_per_order):
                ops.append((WRITE,
                            tpcc.order_row(p, w,
                                           int(rng.integers(8_000_000))),
                            int(rng.integers(1, 1000))))
            return Txn("neworder", ops, home)
        cw = w
        if rng.random() < self.dist_frac:
            cw = act[int(rng.integers(len(act)))]
        amt = int(rng.integers(1, 5000))
        c = int(rng.integers(self.n_customers))
        ops = [(ADD, tpcc.w_ytd(p, w), amt),
               (ADD, tpcc.d_ytd(p, w, d), amt),
               (ADD, tpcc.cust_bal(p, cw, d, c), -amt)]
        return Txn("payment", ops, home)

    def sample_phase(self, rng: np.random.Generator, phase: int,
                     n: int) -> List[Txn]:
        t = phase * self.period
        return [self.sample(rng, t) for _ in range(n)]


def traces(txns) -> list:
    """Access traces for hot-set detection / layout (same shape as the
    static workloads' helpers)."""
    return [[(k, o) for o, k, _ in t.ops] for t in txns]
