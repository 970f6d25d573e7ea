"""SmallBank (+Payment, paper §7.2): banking transactions on 1-2 customer
accounts; 15% reads; read-dependent writes and simple constraints make it
need the declustered layout.  Hot-sets of 5/10/15 accounts per node get 90%
of transactions.

Keys: account a has checking key 2a and savings key 2a+1."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.packets import ADD, ADDP, CADD, READ, WRITE
from repro_torch.db.txn import Txn, key_of

TYPES = ("balance", "deposit", "transact", "amalgamate", "writecheck",
         "payment")
# ~15% read txns (balance); rest write-bearing
MIX = (0.15, 0.17, 0.17, 0.17, 0.17, 0.17)


@dataclass
class SmallBankParams:
    n_nodes: int = 8
    accounts_per_node: int = 125_000       # 1M total on 8 nodes
    hot_per_node: int = 10                 # 5 / 10 / 15 in the paper
    p_hot_txn: float = 0.9
    dist_frac: float = 0.2


def chk(node, a):
    return key_of(node, 2 * a)


def sav(node, a):
    return key_of(node, 2 * a + 1)


def hot_keys(p: SmallBankParams):
    ks = []
    for n in range(p.n_nodes):
        for a in range(p.hot_per_node):
            ks += [chk(n, a), sav(n, a)]
    return ks


def _account(rng, p, home, hot):
    node = home
    if rng.random() < p.dist_frac:
        node = int(rng.integers(p.n_nodes))
    if hot:
        return node, int(rng.integers(p.hot_per_node))
    return node, int(rng.integers(p.hot_per_node, p.accounts_per_node))


def generate(rng: np.random.Generator, n: int, p: SmallBankParams):
    txns = []
    for _ in range(n):
        home = int(rng.integers(p.n_nodes))
        hot = rng.random() < p.p_hot_txn
        t = rng.choice(len(TYPES), p=MIX)
        kind = TYPES[t]
        n1, a1 = _account(rng, p, home, hot)
        amt = int(rng.integers(1, 100))
        if kind == "balance":
            ops = [(READ, chk(n1, a1), 0), (READ, sav(n1, a1), 0)]
        elif kind == "deposit":
            ops = [(ADD, chk(n1, a1), amt)]
        elif kind == "transact":
            ops = [(CADD, sav(n1, a1), amt if rng.random() < 0.8 else -amt)]
        elif kind == "amalgamate":
            n2, a2 = _account(rng, p, home, hot)
            if (n2, a2) == (n1, a1):
                a2 = (a2 + 1) % max(p.hot_per_node if hot else
                                    p.accounts_per_node, 2)
            # read savings(a1), zero it, move into checking(a2)
            ops = [(READ, sav(n1, a1), 0), (WRITE, sav(n1, a1), 0),
                   (ADDP, chk(n2, a2), 0)]
        elif kind == "writecheck":
            ops = [(READ, sav(n1, a1), 0), (CADD, chk(n1, a1), -amt)]
        else:  # payment
            n2, a2 = _account(rng, p, home, hot)
            if (n2, a2) == (n1, a1):
                a2 = (a2 + 1) % max(p.hot_per_node if hot else
                                    p.accounts_per_node, 2)
            ops = [(CADD, chk(n1, a1), -amt), (ADD, chk(n2, a2), amt)]
        txns.append(Txn(f"sb_{kind}", ops, home))
    return txns


def traces(txns):
    return [[(k, o) for o, k, _ in t.ops] for t in txns]
