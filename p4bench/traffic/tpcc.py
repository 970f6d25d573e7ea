"""TPC-C NewOrder + Payment (P4DB §7.2/§7.5; schema of TPC-C v5.11 §1),
frozen from ``repro_torch/workloads/tpcc.py`` and vectorised.

Every draw keeps the original's distribution: a uniform warehouse and
district; NewOrder or Payment with even odds.  NewOrder bumps the
district's next order id, takes 10 items, each from a uniform other
warehouse with ``dist_frac`` (else its own) and among the 20 hot items
with 0.7 (else a uniform other item), each a quantity of 1-4 (lines of
one item merged into one decrement, in first-seen order), and writes an
order header and a line an item (uniform row ids below 8,000,000, values
1-999).  Payment adds a uniform amount of 1-4,999 to the warehouse's and
the district's ytd and takes it from a uniform customer of a uniform
other warehouse with ``dist_frac`` (else its own).  Only the order of the
draws differs, so one seed gives another stream than the original's.

Keys per warehouse w (round-robin over nodes): w_ytd, d_next_oid and
d_ytd of its 10 districts, and stock of its 20 most-ordered items are
the contended columns; customer balances and order rows are cold.

``initial`` is the population of TPC-C v5.11 §4.3.3.1 for the columns
the mix updates, in whole currency units as the mix's amounts are:
W_YTD 300,000 a warehouse, D_YTD 30,000 and D_NEXT_O_ID 3,001 a
district, C_BALANCE -10 for each of the 3,000 customers of a district,
S_QUANTITY uniform in [10, 100] for each of the ``n_items`` stock rows
of a warehouse.  The mix only inserts order rows (blind writes at fresh
row ids), so none are loaded.
"""
from __future__ import annotations

import numpy as np

from p4bench.traffic.stream import ADD, WRITE, Stream, key_of

N_DISTRICTS = 10
HOT_ITEMS = 20          # most-ordered stock items per warehouse
KINDS = ["neworder", "payment"]


def _node(p, w):
    return w % p["n_nodes"]


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


def hot_keys(p) -> list:
    ks = []
    for w in range(p["n_warehouses"]):
        ks.append(w_ytd(p, w))
        for d in range(N_DISTRICTS):
            ks += [d_next_oid(p, w, d), d_ytd(p, w, d)]
        for i in range(HOT_ITEMS):
            ks.append(stock(p, w, i))
    return ks


def initial(rng: np.random.Generator, p: dict):
    """(keys, values) of every loaded row of the deployment."""
    wh = np.arange(p["n_warehouses"])
    w, d = np.divmod(np.arange(p["n_warehouses"] * N_DISTRICTS),
                     N_DISTRICTS)
    n_stock = p["n_warehouses"] * p["n_items"]
    sw, si = np.divmod(np.arange(n_stock), p["n_items"])
    n_cust = w.size * p["n_customers"]
    cd, cc = np.divmod(np.arange(n_cust), p["n_customers"])
    keys = np.concatenate([w_ytd(p, wh), d_next_oid(p, w, d), d_ytd(p, w, d),
                           stock(p, sw, si),
                           cust_bal(p, w[cd], d[cd], cc)])
    vals = np.concatenate([np.full(wh.size, 300_000), np.full(w.size, 3_001),
                           np.full(w.size, 30_000),
                           rng.integers(10, 101, size=n_stock),
                           np.full(n_cust, -10)])
    return keys.astype(np.int64), vals.astype(np.int64)


def generate(rng: np.random.Generator, n: int, p: dict) -> Stream:
    wh, remote, items = p["n_warehouses"], p["dist_frac"], p["items_per_order"]
    w = rng.integers(wh, size=n)
    d = rng.integers(N_DISTRICTS, size=n)
    new_order = rng.random(n) < 0.5
    # NewOrder: the items' warehouses and ids, their quantities, the order
    # rows (header + one line an item) and their values
    iw = np.where(rng.random((n, items)) < remote,
                  rng.integers(wh, size=(n, items)), w[:, None])
    item = np.where(rng.random((n, items)) < 0.7,
                    rng.integers(HOT_ITEMS, size=(n, items)),
                    rng.integers(HOT_ITEMS, p["n_items"], size=(n, items)))
    qty = rng.integers(1, 5, size=(n, items))
    row_id = rng.integers(8_000_000, size=(n, 1 + items))
    row_val = rng.integers(1, 1000, size=(n, 1 + items))
    # Payment: the customer's warehouse, the amount, the customer
    cw = np.where(rng.random(n) < remote, rng.integers(wh, size=n), w)
    amt = rng.integers(1, 5000, size=n)
    cust = rng.integers(p["n_customers"], size=n)

    stock_keys, qty = stock(p, iw, item).tolist(), qty.tolist()
    oid, ytd = d_next_oid(p, w, d).tolist(), d_ytd(p, w, d).tolist()
    wy, bal = w_ytd(p, w).tolist(), cust_bal(p, cw, d, cust).tolist()
    rows = order_row(p, w[:, None], row_id).tolist()
    row_val, amt = row_val.tolist(), amt.tolist()
    op, key, val, n_ops = [], [], [], []
    for i, no in enumerate(new_order.tolist()):
        if no:
            # duplicate order lines of one item merge into one decrement
            merged = {}
            for k, q in zip(stock_keys[i], qty[i]):
                merged[k] = merged.get(k, 0) - q
            ks = [oid[i], *merged, *rows[i]]
            vs = [1, *merged.values(), *row_val[i]]
            op += [ADD] * (1 + len(merged)) + [WRITE] * len(rows[i])
        else:
            a = amt[i]
            ks, vs = [wy[i], ytd[i], bal[i]], [a, a, -a]
            op += [ADD, ADD, ADD]
        key += ks
        val += vs
        n_ops.append(len(ks))
    start = np.zeros(n + 1, np.int64)
    np.cumsum(n_ops, out=start[1:])
    return Stream(KINDS, np.where(new_order, 0, 1).astype(np.int64),
                  _node(p, w).astype(np.int64), start,
                  np.array(op, np.int64), np.array(key, np.int64),
                  np.array(val, np.int64))
