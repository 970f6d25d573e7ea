"""High-contention storm generators for the contention-resilience layer.

These are the adversarial counterparts of the steady-state workloads:
every transaction funnels through a SMALL set of *contended* cold keys,
so the cold/warm 2PL path sees the conflict rates the early-abort
detector (``db.conflict``) and the retry discipline exist for.

Two storm shapes, both from the paper's workload suite:

``ycsb_a_storm``
    Mixed YCSB-A under contention: 50/50 read-modify-write over 8 ops,
    but a ``p_contended`` fraction of each txn's ops lands on one of
    ``contended_per_node`` keys per node.  Contended ops sit at varied
    positions, so doomed attempts burn a realistic amount of private
    work before discovering the conflict — the wasted work early aborts
    reclaim.

``tpcc_payment_storm``
    A TPC-C payment storm: every payment updates its warehouse's YTD row
    FIRST (one contended key per warehouse — the classic TPC-C choke
    point), then the district row, then private customer/history rows;
    15% pay through a remote warehouse (cross-node 2PC).

Design constraint (load-bearing for the differential tests): all write
ops are ADDs — commutative read-modify-writes — so the final stores /
registers / WAL-recoverable state are identical under ANY legal
serialization.  Early-abort on vs off may commit the storm in different
orders; state identity must still hold exactly.

Hot keys (switch-resident) live in a DISJOINT local-index range above
``keys_per_node``, so the contended cold set never migrates to the
switch and the two planes stay separately measurable.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.packets import ADD, READ
from repro_torch.db.txn import Txn, key_of

N_DISTRICTS = 10          # TPC-C: districts per warehouse


@dataclass
class StormParams:
    n_nodes: int = 4
    keys_per_node: int = 10_000   # private (uniform) key space per node
    contended_per_node: int = 2   # storm funnel: this small
    hot_per_node: int = 8         # switch-resident keys (disjoint range)
    p_contended: float = 0.35     # per-op probability of a contended key
    p_hot_txn: float = 0.0        # fraction of txns also touching hot keys
    p_remote: float = 0.15        # cross-node ops (distributed 2PC)
    ops_per_txn: int = 8
    warehouses_per_node: int = 1  # tpcc storm: contention funnels here


def contended_keys(p: StormParams):
    """The storm funnel: local idx < contended_per_node on every node."""
    return [key_of(n, i) for n in range(p.n_nodes)
            for i in range(p.contended_per_node)]


def hot_keys(p: StormParams):
    """Switch-resident keys — a range DISJOINT from the cold key space."""
    return [key_of(n, p.keys_per_node + i) for n in range(p.n_nodes)
            for i in range(p.hot_per_node)]


def ycsb_a_storm(rng: np.random.Generator, n: int, p: StormParams):
    txns = []
    for _ in range(n):
        home = int(rng.integers(p.n_nodes))
        hot = rng.random() < p.p_hot_txn
        ops = []
        for j in range(p.ops_per_txn):
            remote = rng.random() < p.p_remote
            node = int(rng.integers(p.n_nodes)) if remote else home
            if hot and j == 0:
                k = key_of(node, p.keys_per_node
                           + int(rng.integers(p.hot_per_node)))
                ops.append((ADD, k, int(rng.integers(1, 10))))
                continue
            if rng.random() < p.p_contended:
                k = key_of(node, int(rng.integers(p.contended_per_node)))
                ops.append((ADD, k, int(rng.integers(1, 10))))
            else:
                k = key_of(node, int(rng.integers(p.contended_per_node,
                                                  p.keys_per_node)))
                # YCSB-A 50/50 read/RMW mix on the private keys
                if rng.random() < 0.5:
                    ops.append((READ, k, 0))
                else:
                    ops.append((ADD, k, int(rng.integers(1, 10))))
        txns.append(Txn("ycsb_a_storm", ops, home))
    return txns


def tpcc_payment_storm(rng: np.random.Generator, n: int, p: StormParams):
    """Payment: warehouse YTD (contended, FIRST — held longest), district
    YTD, customer balance, history append.  Warehouse w of node n is
    contended key ``key_of(n, w)`` (requires warehouses_per_node <=
    contended_per_node so the funnel stays in the contended range)."""
    wpn = min(p.warehouses_per_node, p.contended_per_node)
    txns = []
    for _ in range(n):
        home = int(rng.integers(p.n_nodes))
        w = int(rng.integers(wpn))
        remote = rng.random() < p.p_remote
        w_node = int(rng.integers(p.n_nodes)) if remote else home
        amount = int(rng.integers(1, 5000))
        d = int(rng.integers(N_DISTRICTS))
        # district rows sit right above the contended range
        d_key = key_of(w_node, p.contended_per_node + w * N_DISTRICTS + d)
        c_key = key_of(home, int(rng.integers(
            p.contended_per_node + wpn * N_DISTRICTS, p.keys_per_node)))
        h_key = key_of(home, int(rng.integers(
            p.contended_per_node + wpn * N_DISTRICTS, p.keys_per_node)))
        ops = [(ADD, key_of(w_node, w), amount),       # warehouse YTD
               (ADD, d_key, amount),                   # district YTD
               (ADD, c_key, -amount),                  # customer balance
               (ADD, h_key, amount)]                   # history append
        txns.append(Txn("tpcc_payment_storm", ops, home))
    return txns


def traces(txns):
    """Access traces for hot-set detection / layout."""
    return [[(k, o) for o, k, _ in t.ops] for t in txns]
