"""The plain reference: hand-worked answers, and agreement with the
program's cluster on the CPU (small seeded YCSB-A and TPC-C streams
through the harness, every answer and all state compared)."""
import copy

import numpy as np
import pytest
import torch

from p4bench import harness
from p4bench.reference import compare, serial
from p4bench.traffic.stream import ADD, ADDP, CADD, READ, WRITE, Stream


def _stream(txns):
    """``txns``: [(home, [(op, key, val), ...]), ...]."""
    n_ops = [len(ops) for _, ops in txns]
    start = np.concatenate([[0], np.cumsum(n_ops)]).astype(np.int64)
    flat = np.array([o for _, ops in txns for o in ops], np.int64)
    return Stream(["t"], np.zeros(len(txns), np.int64),
                  np.array([h for h, _ in txns], np.int64), start,
                  flat[:, 0], flat[:, 1], flat[:, 2])


def test_serial_answers_by_hand():
    s = _stream([(0, [(WRITE, 5, 7), (ADD, 5, 3), (READ, 9, 0)]),
                 (1, [(READ, 5, 0), (ADDP, 9, 0), (ADD, 9, -2)])])
    out = serial.execute(s)
    assert out.res.tolist() == [7, 10, 0, 10, 10, 8]
    assert out.pre.tolist() == [0, 7, 0, 10, 0, 10]
    assert out.post.tolist() == [7, 10, 0, 10, 10, 8]
    assert out.values == {5: 10, 9: 8}
    # another admission order gives other answers
    assert serial.execute(s, order=[1, 0]).res.tolist() == [7, 10, -2,
                                                            0, 0, -2]
    # from loaded tuples, which stay as they were
    loaded = {5: 1, 9: 100, 4: 2}
    out = serial.execute(s, loaded)
    assert out.res.tolist() == [7, 10, 100, 10, 110, 108]
    assert out.pre.tolist() == [1, 7, 100, 10, 100, 110]
    assert out.values == {5: 10, 9: 108, 4: 2}
    assert loaded == {5: 1, 9: 100, 4: 2}


@pytest.mark.parametrize("ops", [[(ADD, 1, 2 ** 31)], [(CADD, 1, 1)]])
def test_serial_refuses_what_it_does_not_model(ops):
    with pytest.raises(ValueError):
        serial.execute(_stream([(0, ops)]))


def test_compare_counts_each_kind_of_fault():
    s = _stream([(0, [(WRITE, 5, 7)]), (0, [(READ, 5, 0)])])
    ref = serial.execute(s)
    assert compare.results_bad(s, ref, *compare.pack([[7], [7]])) == 0
    assert compare.results_bad(s, ref, *compare.pack([[7], [6]])) == 1
    assert compare.results_bad(s, ref, *compare.pack([[7]])) == 1   # never
    assert compare.results_bad(s, ref, *compare.pack([[7], "gave up"])) == 1
    assert compare.results_bad(s, ref, *compare.pack([[7, 7], [7]])) == 1
    assert compare.values_bad(ref, {5: 7}) == 0
    assert compare.values_bad(ref, {5: 7, 6: 1}, stray=2) == 3
    assert compare.judge(dict(results_bad=0, values_bad=1))[0] is False


SMALL = {
    "ycsb": dict(deployment=dict(n_nodes=4, keys_per_node=2000,
                                 hot_per_node=16, ops_per_txn=8,
                                 dist_frac=0.2, p_hot_txn=0.75,
                                 variant="A"),
                 # 48 of the 64 hot keys: txns on the other 16 are warm
                 hot_index=dict(txns=600, seed=0, top_k=48),
                 params=dict(p_hot_txn=0.75)),
    "tpcc": dict(deployment=dict(n_nodes=2, n_warehouses=4, dist_frac=0.2,
                                 items_per_order=10, n_items=1000,
                                 n_customers=300),
                 hot_index=dict(txns=600, seed=0, top_k=164),
                 params={}),
}


def _small_cell(name, generator, async_hot):
    cell = copy.deepcopy(harness.load_cell(name))
    s = SMALL[generator]
    cell["config"].update(deployment=s["deployment"],
                          hot_index=s["hot_index"])
    cell["config"]["switch"] = dict(n_stages=8, regs_per_stage=256,
                                    max_instrs=16, n_switches=1)
    cell["config"]["cluster"].update(async_hot=async_hot, max_inflight=2)
    cell["traffic"].update(params=s["params"], batch=32, warmup_batches=2)
    return cell


@pytest.mark.parametrize("name,generator,async_hot", [
    ("ycsb_a.allhot", "ycsb", False), ("ycsb_a.allhot", "ycsb", True),
    ("tpcc.paper", "tpcc", False)])
def test_reference_agrees_with_the_cpu_cluster(name, generator, async_hot):
    cell = _small_cell(name, generator, async_hot)
    run = harness.Run(cell, 2 ** 31 + 5, 0.0, torch.device("cpu"))
    run.setup(n_txns=640)
    while run.next < len(run.batches):
        run._one()
    run.cluster.drain()
    stats = dict(run.cluster.stats)
    got = run.outputs()
    numbers = run.check(got)
    assert numbers == dict(results_bad=0, values_bad=0, wal_bad=0,
                           commits_gap=0)
    # the stream drove every path of its mix
    kinds = {"hot", "warm", "cold"} if generator == "ycsb" else {"warm"}
    assert kinds <= {k for k, v in stats.items() if v}
    assert got["lens"].size == 640
