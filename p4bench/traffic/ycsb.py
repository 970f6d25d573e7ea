"""YCSB transactions (P4DB §7.2; YCSB core workloads, Cooper et al., SoCC
2010), frozen from ``repro_torch/workloads/ycsb.py`` and vectorised.

Every draw keeps the original's distribution, independent as there:
home node uniform; a txn is hot with ``p_hot_txn``; each of its
``ops_per_txn`` ops goes to a uniform node with ``dist_frac`` (else
home); a hot op j takes a uniform member of hot class ``j % ops_per_txn``
(locals ``j, j + ops_per_txn, ... < hot_per_node``), a cold op a uniform
local in ``[hot_per_node, keys_per_node)``; an op writes a uniform value
in ``[0, 1000)`` with the variant's write share, else reads.  Only the
order of the draws differs, so one seed gives another stream than the
original's.

``initial`` is the table as loaded before the first transaction: every
record of every node (``keys_per_node`` a node, hot ones among them),
each holding a uniform value in ``[0, 1000)``, the writes' range.
"""
from __future__ import annotations

import numpy as np

from p4bench.traffic.stream import READ, WRITE, Stream, key_of

WRITE_FRAC = {"A": 0.5, "B": 0.05, "C": 0.0}


def hot_keys(p) -> list:
    return [key_of(n, i) for n in range(p["n_nodes"])
            for i in range(p["hot_per_node"])]


def initial(rng: np.random.Generator, p: dict):
    """(keys, values) of every record of the deployment."""
    keys = key_of(np.arange(p["n_nodes"])[:, None],
                  np.arange(p["keys_per_node"])).reshape(-1)
    return keys.astype(np.int64), rng.integers(0, 1000, size=keys.size)


def generate(rng: np.random.Generator, n: int, p: dict) -> Stream:
    k, nodes, hot_n = p["ops_per_txn"], p["n_nodes"], p["hot_per_node"]
    home = rng.integers(nodes, size=n)
    hot = rng.random(n) < p["p_hot_txn"]
    remote = rng.random((n, k)) < p["dist_frac"]
    node = np.where(remote, rng.integers(nodes, size=(n, k)), home[:, None])
    cls = np.arange(k)
    members = np.array([len(range(j, hot_n, k)) for j in cls])
    hot_local = cls + k * rng.integers(0, members, size=(n, k))
    cold_local = rng.integers(hot_n, p["keys_per_node"], size=(n, k))
    local = np.where(hot[:, None], hot_local, cold_local)
    write = rng.random((n, k)) < WRITE_FRAC[p["variant"]]
    val = np.where(write, rng.integers(0, 1000, size=(n, k)), 0)
    return Stream([f"ycsb_{p['variant']}"], np.zeros(n, np.int64),
                  home.astype(np.int64), np.arange(n + 1, dtype=np.int64) * k,
                  np.where(write, WRITE, READ).reshape(-1).astype(np.int64),
                  key_of(node, local).reshape(-1).astype(np.int64),
                  val.reshape(-1).astype(np.int64))
