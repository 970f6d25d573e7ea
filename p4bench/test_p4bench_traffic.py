"""The generator copies against the program's generators
(``repro_torch.workloads``), one seed each: the same key layout, the same
shapes, and the same distributions (the copies draw in another order, so
the streams differ draw by draw)."""
import json
from pathlib import Path

import numpy as np
import pytest
from repro_torch.workloads import tpcc as prog_tpcc
from repro_torch.workloads import ycsb as prog_ycsb

from p4bench.traffic import tpcc, ycsb
from p4bench.traffic.stream import ADD, READ, WRITE, node_of

CONFIGS = Path(__file__).resolve().parent / "configs"
N = 20000


def _deployment(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["deployment"]


def _program_arrays(txns):
    ops = np.array([o for t in txns for o in t.ops], np.int64)
    n_ops = np.array([len(t.ops) for t in txns])
    home = np.array([t.home for t in txns])
    return ops[:, 0], ops[:, 1], ops[:, 2], n_ops, home


def _close(a, b, tol):
    assert abs(a - b) <= tol, (a, b)


def test_ycsb_copy_matches_the_program():
    p = _deployment("ycsb_a")
    prog_p = prog_ycsb.YCSBParams(**p)
    assert ycsb.hot_keys(p) == prog_ycsb.hot_keys(prog_p)
    s = ycsb.generate(np.random.default_rng(3), N, p)
    op, key, val, n_ops, home = _program_arrays(
        prog_ycsb.generate(np.random.default_rng(3), N, prog_p))
    assert (np.diff(s.start) == 8).all() and (n_ops == 8).all()
    assert s.kinds == ["ycsb_A"]
    k = p["ops_per_txn"]
    for o, ky, v, h in ((s.op, s.key, s.val, np.repeat(s.home, k)),
                        (op, key, val, np.repeat(home, k))):
        local = ky % 1_000_000_000
        hot = local < p["hot_per_node"]
        # a hot op j draws from hot class j
        assert (local[hot] % k == np.tile(np.arange(k), N)[hot]).all()
        assert set(np.unique(o)) == {READ, WRITE}
        assert (v[o == READ] == 0).all() and v.max() < 1000
    def stats(op, key, val, home):
        return dict(hot=np.mean(key % 1_000_000_000 < p["hot_per_node"]),
                    write=np.mean(op == WRITE),
                    remote=np.mean(node_of(key) != np.repeat(home, k)),
                    value=val[op == WRITE].mean())
    got, ref = stats(s.op, s.key, s.val, s.home), stats(op, key, val, home)
    for name, tol in (("hot", 0.015), ("write", 0.01), ("remote", 0.01),
                      ("value", 10.0)):
        _close(got[name], ref[name], tol)
    # a hot key is drawn as often as the other members of its class: the
    # 7 members of classes 0 and 1 each 6/7 as often as the 6 of the rest
    for ky in (s.key, key):
        local = ky % 1_000_000_000
        counts = np.bincount(local[local < p["hot_per_node"]])
        small = counts[np.arange(p["hot_per_node"]) % k < 2]
        big = counts[np.arange(p["hot_per_node"]) % k >= 2]
        _close(small.mean() / big.mean(), 6 / 7, 0.03)


@pytest.mark.parametrize("fn", ["w_ytd", "d_next_oid", "d_ytd", "stock",
                                "cust_bal", "order_row"])
def test_tpcc_key_layout_matches_the_program(fn):
    p = _deployment("tpcc")
    prog_p = prog_tpcc.TPCCParams(**p)
    args = {"w_ytd": (5,), "d_next_oid": (5, 3), "d_ytd": (5, 3),
            "stock": (5, 17), "cust_bal": (5, 3, 1234),
            "order_row": (5, 777)}[fn]
    assert getattr(tpcc, fn)(p, *args) == getattr(prog_tpcc, fn)(prog_p,
                                                                  *args)


def test_tpcc_copy_matches_the_program():
    p = _deployment("tpcc")
    prog_p = prog_tpcc.TPCCParams(**p)
    assert tpcc.hot_keys(p) == prog_tpcc.hot_keys(prog_p)
    s = tpcc.generate(np.random.default_rng(3), N, p)
    txns = prog_tpcc.generate(np.random.default_rng(3), N, prog_p)
    op, key, val, n_ops, home = _program_arrays(txns)
    got_no = np.mean(s.kind == 0)
    ref_no = np.mean([t.kind == "neworder" for t in txns])
    _close(got_no, ref_no, 0.02)
    _close(np.diff(s.start).mean(), n_ops.mean(), 0.25)
    assert set(np.diff(s.start)[s.kind == 1]) == {3}
    hot = set(tpcc.hot_keys(p))
    for o, ky in ((s.op, s.key), (op, key)):
        assert set(np.unique(o)) == {ADD, WRITE}
    share = lambda ky: np.mean([x in hot for x in ky.tolist()])
    _close(share(s.key), share(key), 0.01)
    _close(s.val[s.op == WRITE].mean(), val[op == WRITE].mean(), 10.0)
    _close(np.mean(s.home), np.mean(home), 0.1)


@pytest.mark.parametrize("name,gen,rows", [
    ("ycsb_a", ycsb, 8 * 100_000),
    # 32 w_ytd, 320 d_next_oid, 320 d_ytd, 3,200,000 stock, 960,000 customers
    ("tpcc", tpcc, 32 + 2 * 320 + 32 * 100_000 + 320 * 3000)])
def test_initial_tables_hold_the_deployment(name, gen, rows):
    p = _deployment(name)
    keys, vals = gen.initial(np.random.default_rng(5), p)
    assert keys.size == vals.size == rows == np.unique(keys).size
    loaded = set(keys.tolist())
    assert set(gen.hot_keys(p)) <= loaded
    # every key a transaction reads or adds to was loaded; only blind
    # writes (TPC-C's order inserts) reach keys that were not
    s = gen.generate(np.random.default_rng(6), 2000, p)
    assert all(k in loaded for k in s.key[s.op != WRITE].tolist())
    if gen is ycsb:
        assert 0 <= vals.min() and vals.max() < 1000
    else:
        stock = (keys % 1_000_000_000) // 10_000_000 == 4
        assert vals[stock].min() == 10 and vals[stock].max() == 100
        assert sorted(set(vals[~stock].tolist())) == [-10, 3_001, 30_000,
                                                      300_000]
    again = gen.initial(np.random.default_rng(5), p)
    assert (again[0] == keys).all() and (again[1] == vals).all()
