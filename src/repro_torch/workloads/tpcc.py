"""TPC-C, NewOrder + Payment mix (paper §7.2/7.5): these need *warm*
transactions — the contended warehouse/district/hot-stock columns are
offloaded to the switch, order lines / customer rows stay cold on nodes.

Key layout per warehouse w (0-based, round-robin over nodes):
  w_ytd(w), d_next_oid(w,d), d_ytd(w,d)      — hot (offloaded)
  stock(w,i) for the hottest items           — hot (offloaded)
  cust_bal(w,d,c), order rows                — cold
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.packets import ADD, READ, WRITE
from repro_torch.db.txn import Txn, key_of

N_DISTRICTS = 10
HOT_ITEMS = 20          # most-ordered stock items per warehouse


@dataclass
class TPCCParams:
    n_nodes: int = 8
    n_warehouses: int = 8
    dist_frac: float = 0.2          # probability of remote wh per item/cust
    items_per_order: int = 10
    n_items: int = 100_000
    n_customers: int = 3000


def _node(p, w):
    return w % p.n_nodes


def w_ytd(p, w):
    return key_of(_node(p, w), 10_000_000 + w)


def d_next_oid(p, w, d):
    return key_of(_node(p, w), 20_000_000 + w * N_DISTRICTS + d)


def d_ytd(p, w, d):
    return key_of(_node(p, w), 30_000_000 + w * N_DISTRICTS + d)


def stock(p, w, i):
    return key_of(_node(p, w), 40_000_000 + w * 100_000 + i)


def cust_bal(p, w, d, c):
    return key_of(_node(p, w), 50_000_000 + (w * N_DISTRICTS + d) * 3000 + c)


def order_row(p, w, uniq):
    return key_of(_node(p, w), 60_000_000 + uniq)


def hot_keys(p: TPCCParams):
    ks = []
    for w in range(p.n_warehouses):
        ks.append(w_ytd(p, w))
        for d in range(N_DISTRICTS):
            ks += [d_next_oid(p, w, d), d_ytd(p, w, d)]
        for i in range(HOT_ITEMS):
            ks.append(stock(p, w, i))
    return ks


def generate(rng: np.random.Generator, n: int, p: TPCCParams):
    txns = []
    for _ in range(n):
        w = int(rng.integers(p.n_warehouses))
        home = _node(p, w)
        d = int(rng.integers(N_DISTRICTS))
        if rng.random() < 0.5:
            # NewOrder: bump next_o_id (hot), touch stocks (hot for top
            # items), insert order rows (cold)
            ops = [(ADD, d_next_oid(p, w, d), 1)]
            qty = {}
            for _ in range(p.items_per_order):
                iw = w
                if rng.random() < p.dist_frac:
                    iw = int(rng.integers(p.n_warehouses))
                # zipf-ish: most orders hit the hot items
                if rng.random() < 0.7:
                    item = int(rng.integers(HOT_ITEMS))
                else:
                    item = int(rng.integers(HOT_ITEMS, p.n_items))
                k = stock(p, iw, item)
                qty[k] = qty.get(k, 0) - int(rng.integers(1, 5))
            # duplicate order lines for one item merge into one decrement
            # (keeps hot txns reorderable -> single-pass, paper §4.1)
            ops += [(ADD, k, v) for k, v in qty.items()]
            # cold inserts: order header + one order-line row per item.
            # Order-row ids come from the rng, NOT a module counter: the
            # stream must be a pure function of the seed (same fix as
            # drift.TPCCWarehouseRotation; a global itertools.count made
            # two same-seed generate() calls diverge — caught by the
            # conftest seed-determinism guard)
            for _ in range(1 + p.items_per_order):
                ops.append((WRITE, order_row(p, w,
                                             int(rng.integers(8_000_000))),
                            int(rng.integers(1, 1000))))
            txns.append(Txn("neworder", ops, home))
        else:
            # Payment: warehouse + district ytd (hot), customer (cold,
            # possibly remote)
            cw = w
            if rng.random() < p.dist_frac:
                cw = int(rng.integers(p.n_warehouses))
            amt = int(rng.integers(1, 5000))
            c = int(rng.integers(p.n_customers))
            ops = [(ADD, w_ytd(p, w), amt),
                   (ADD, d_ytd(p, w, d), amt),
                   (ADD, cust_bal(p, cw, d, c), -amt)]
            txns.append(Txn("payment", ops, home))
    return txns


def traces(txns):
    return [[(k, o) for o, k, _ in t.ops] for t in txns]
