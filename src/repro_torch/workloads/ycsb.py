"""YCSB (paper §7.2): one table partitioned round-robin; a transaction is a
group of 8 read/write operations; hot-set = 50 keys per node receiving 75%
of all accesses.  Workloads A (50/50), B (95/5), C (read-only)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.packets import READ, WRITE
from repro_torch.db.txn import Txn, key_of

WRITE_FRAC = {"A": 0.5, "B": 0.05, "C": 0.0}


@dataclass
class YCSBParams:
    n_nodes: int = 8
    keys_per_node: int = 100_000
    hot_per_node: int = 50
    p_hot_txn: float = 0.75
    dist_frac: float = 0.2
    ops_per_txn: int = 8
    variant: str = "A"


def hot_keys(p: YCSBParams):
    return [key_of(n, i) for n in range(p.n_nodes)
            for i in range(p.hot_per_node)]


def generate(rng: np.random.Generator, n: int, p: YCSBParams):
    wf = WRITE_FRAC[p.variant]
    txns = []
    for _ in range(n):
        home = int(rng.integers(p.n_nodes))
        hot = rng.random() < p.p_hot_txn
        ops = []
        for j in range(p.ops_per_txn):
            remote = rng.random() < p.dist_frac
            node = int(rng.integers(p.n_nodes)) if remote else home
            if hot:
                # op j draws from hot-key class j (mod ops_per_txn): hot
                # co-access happens across classes, never within one — the
                # structure the declustered layout exploits to place all of
                # a txn's tuples in distinct stages (single-pass, §4)
                cls = j % p.ops_per_txn
                members = range(cls, p.hot_per_node, p.ops_per_txn)
                k = key_of(node, int(rng.choice(list(members))))
            else:
                k = key_of(node, int(rng.integers(p.hot_per_node,
                                                  p.keys_per_node)))
            if rng.random() < wf:
                ops.append((WRITE, k, int(rng.integers(0, 1000))))
            else:
                ops.append((READ, k, 0))
        txns.append(Txn(f"ycsb_{p.variant}", ops, home))
    return txns


def traces(txns):
    """Access traces for hot-set detection / layout."""
    return [[(k, o) for o, k, _ in t.ops] for t in txns]
