"""The plain reference: hand-worked answers, and agreement with the
program's cluster on the CPU (small seeded YCSB-A, TPC-C and SmallBank
streams through the harness, every answer and all state compared)."""
import copy
import sys
import types

import numpy as np
import pytest
import torch

from p4bench import harness
from p4bench.reference import compare, serial
from p4bench.traffic.stream import (ADD, ADDP, CADD, READ, WRITE, Stream,
                                    node_of)


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
    assert out.committed.tolist() == [True, True]
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


@pytest.mark.parametrize("ops", [[(ADD, 1, 2 ** 31)], [(CADD, 1, 2 ** 31)]])
def test_serial_refuses_what_it_does_not_model(ops):
    with pytest.raises(ValueError):
        serial.execute(_stream([(0, ops)]))


def test_serial_refuses_addp_across_the_switch():
    s = _stream([(0, [(READ, 5, 0), (ADDP, 6, 0)])])
    for switch in ([5], [6]):
        with pytest.raises(ValueError):
            serial.execute(s, switch_keys=switch)
    for switch in ((), [5, 6]):
        assert serial.execute(s, {5: 2}, switch_keys=switch).res.tolist() \
            == [2, 2]


def test_serial_cadd_skipped_on_the_switch():
    """A switch CADD that would go below 0 keeps the value and answers it;
    one that would not applies."""
    s = _stream([(0, [(CADD, 5, -4)]), (0, [(CADD, 5, -3)]),
                 (0, [(CADD, 5, -1)])])
    out = serial.execute(s, {5: 3}, switch_keys=[5])
    assert out.committed.tolist() == [True, True, True]
    assert out.res.tolist() == [3, 0, 0]
    assert out.pre.tolist() == [3, 3, 0]
    assert out.post.tolist() == [3, 0, 0]
    assert out.values == {5: 0}


def test_serial_cadd_on_a_node_refuses_the_whole_txn():
    """A node CADD below 0 refuses its txn: its earlier node op and its
    switch op do not apply, and the next txn sees the values before it."""
    s = _stream([(0, [(ADD, 5, 1), (ADD, 8, 4), (CADD, 7, -3)]),
                 (1, [(READ, 5, 0), (READ, 8, 0), (CADD, 7, -2)])])
    loaded = {5: 10, 7: 2, 8: 1}
    out = serial.execute(s, loaded, switch_keys=[5])
    assert out.committed.tolist() == [False, True]
    assert out.res.tolist() == [0, 0, 0, 10, 1, 0]
    assert out.pre.tolist() == [10, 1, 2, 10, 1, 2]
    assert out.post.tolist() == [10, 1, 2, 10, 1, 0]
    assert out.values == {5: 10, 7: 0, 8: 1}
    assert loaded == {5: 10, 7: 2, 8: 1}
    # the same CADD on the switch is skipped, and the txn commits
    out = serial.execute(s, loaded, switch_keys=[5, 7])
    assert out.committed.tolist() == [True, True]
    assert out.res.tolist() == [11, 5, 2, 11, 5, 0]
    # a key that no txn wrote before the refusal is not left behind
    out = serial.execute(_stream([(0, [(ADD, 9, 1), (CADD, 7, -3)])]),
                         {7: 2})
    assert out.committed.tolist() == [False] and out.values == {7: 2}


def test_serial_addp_after_a_skipped_cadd():
    """ADDP adds the answer of a skipped CADD: the value it kept."""
    s = _stream([(0, [(CADD, 5, -5), (ADDP, 6, 0)])])
    out = serial.execute(s, {5: 2, 6: 100}, switch_keys=[5, 6])
    assert out.committed.tolist() == [True]
    assert out.res.tolist() == [2, 102]
    assert out.values == {5: 2, 6: 102}


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


class _Record:
    def __init__(self, kind, tid, **payload):
        self.kind, self.tid, self.payload = kind, tid, payload


def _log(*records):
    """``records`` as one node's hash-chained log."""
    for lsn, r in enumerate(records):
        r.lsn, r.hash, r.prev = lsn, lsn, lsn - 1
    return list(records)


def test_compare_holds_refused_txns():
    """A txn the reference refuses is right only where the program gave
    up on it, with no log record; it counts as no commit and as no
    failure."""
    s = _stream([(0, [(WRITE, 5, 1)]), (0, [(CADD, 5, -3)]),
                 (0, [(READ, 5, 0)])])
    ref = serial.execute(s)
    assert ref.committed.tolist() == [True, False, True]
    gave_up = object()                  # the program's sentinel stands in
    for answers, bad in (([[1], gave_up, [1]], 0), ([[1], [-2], [1]], 1),
                         ([[1], gave_up, gave_up], 1),
                         ([[1], None, [1]], 1), ([[1], gave_up], 1)):
        lens, flat = compare.pack(answers)
        assert compare.results_bad(s, ref, lens, flat) == bad, answers
    lens, _ = compare.pack([[1], gave_up, gave_up])
    assert compare.unanswered(ref, lens) == 1
    assert compare.unanswered(ref, lens, first=3) == 0
    assert compare.commits_gap(ref, 2) == 0
    assert compare.commits_gap(ref, 3) == 1
    ok = [_Record("write", 10, key=5, old=0, new=1), _Record("commit", 10),
          _Record("commit", 12)]
    assert compare.wal_bad(s, ref, [_log(*ok)], 10) == 0
    assert compare.wal_bad(s, ref, [_log(*ok, _Record(
        "write", 11, key=5, old=1, new=-2))], 10) == 1


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


# SmallBank at a small size: 2 nodes of 6 accounts, 4 of them hot.  A cold
# payment or amalgamate that draws one account twice moves the second to
# the next, and account 5 wraps to the hot account 0: such a txn is warm.
SMALLBANK = dict(n_nodes=2, accounts_per_node=6, hot_per_node=4,
                 p_hot_txn=0.9, dist_frac=0.2)


def _smallbank_generator():
    """A stand-in for a traffic generator: SmallBank as the program's own
    generator writes it (``repro_torch/workloads/smallbank.py``), as a
    stream, every account loaded with a balance in [0, 100).  A txn whose
    ADDP adds an op across the switch/node line (an amalgamate made warm
    by the wrap), which P4DB does not define, is left out."""
    from repro_torch.workloads import smallbank
    p = smallbank.SmallBankParams(**SMALLBANK)
    hot = set(smallbank.hot_keys(p))

    def defined(t):
        return all((k in hot) == (t.ops[v][1] in hot)
                   for o, k, v in t.ops if o == ADDP)

    def generate(rng, n, params):
        txns = [t for t in smallbank.generate(rng, 2 * n, p) if defined(t)]
        return _stream_of(txns[:n])

    def initial(rng, deployment):
        keys = np.array([node * 10 ** 9 + a for node in range(p.n_nodes)
                         for a in range(2 * p.accounts_per_node)], np.int64)
        return keys, rng.integers(0, 100, keys.size, dtype=np.int64)

    mod = types.ModuleType("p4bench.traffic.smallbank_program")
    mod.generate, mod.initial = generate, initial
    return mod


def _stream_of(txns) -> Stream:
    kinds = sorted({t.kind for t in txns})
    s = _stream([(t.home, list(t.ops)) for t in txns])
    s.kinds = kinds
    s.kind = np.array([kinds.index(t.kind) for t in txns], np.int64)
    return s


def smallbank_cell(monkeypatch, async_hot: bool) -> dict:
    """A cell of SmallBank at the small size, its traffic from the
    program's generator (``_smallbank_generator``)."""
    monkeypatch.setitem(sys.modules, "p4bench.traffic.smallbank_program",
                        _smallbank_generator())
    cell = _small_cell("ycsb_a.allhot", "ycsb", async_hot)
    cell["config"]["deployment"] = dict(SMALLBANK)
    cell["config"]["hot_index"] = dict(txns=2000, seed=0, top_k=16)
    cell["traffic"].update(generator="smallbank_program", params={})
    return cell


def run_all(cell, seed: int, n: int):
    """Every txn of ``n`` through the program on the CPU: (the run, its
    outputs)."""
    run = harness.Run(cell, seed, 0.0, torch.device("cpu"))
    run.setup(n_txns=n)
    while run.next < len(run.batches):
        run._one()
    run.cluster.drain()
    run._pack(final=True)
    return run, run.outputs()


@pytest.mark.parametrize("async_hot", [False, True])
def test_reference_agrees_with_the_cpu_cluster_on_smallbank(monkeypatch,
                                                            async_hot):
    cell = smallbank_cell(monkeypatch, async_hot)
    run, got = run_all(cell, 2 ** 31 + 7, 640)
    assert cell["config"]["cluster"]["switch_mode"] == "auto"
    assert run.check(got) == dict(results_bad=0, values_bad=0, wal_bad=0,
                                  commits_gap=0)
    assert run.failed == 0 and got["lens"].size == 640
    # the stream holds what the reference now models
    s = run.stream
    keys, values = run.initial
    ref = serial.execute(s, dict(zip(keys.tolist(), values.tolist())),
                         switch_keys=got["switch_keys"])
    switch = set(got["switch_keys"].tolist())
    on_switch = np.array([k in switch for k in s.key.tolist()])
    txn = np.repeat(np.arange(s.n), np.diff(s.start))
    all_hot = np.bincount(txn, on_switch, s.n) == np.diff(s.start)
    none_hot = np.bincount(txn, on_switch, s.n) == 0
    assert (~ref.committed & none_hot).any()          # a cold txn refused
    skipped = (s.op == CADD) & on_switch & (ref.pre + s.val < 0)
    assert (skipped & ref.committed[txn]).any()       # a switch CADD skipped
    assert (~all_hot & ~none_hot).any()               # a warm txn
    assert run.cluster.stats["gave_up"] == int((~ref.committed).sum())
    assert set(node_of(s.key).tolist()) == {0, 1}


def test_check_runs_the_reference_the_configuration_names(monkeypatch):
    """``Run.check`` imports the reference the configuration file names,
    and hands it the switch's keys as data."""
    calls = []

    def execute(stream, initial=None, switch_keys=(), order=None):
        calls.append(sorted(switch_keys.tolist()))
        out = serial.execute(stream, initial, switch_keys)
        if len(calls) > 1:              # a reference that refuses all
            out.committed[:] = False
        return out
    stub = types.ModuleType("p4bench.reference.stub_reference")
    stub.execute = execute
    monkeypatch.setitem(sys.modules, stub.__name__, stub)
    cell = _small_cell("ycsb_a.allhot", "ycsb", False)
    cell["config"]["reference"] = "p4bench/reference/stub_reference.py"
    run, got = run_all(cell, 2 ** 31 + 9, 128)
    assert run.check(got) == dict(results_bad=0, values_bad=0, wal_bad=0,
                                  commits_gap=0)
    assert calls == [sorted(got["switch_keys"].tolist())] and calls[0]
    numbers = run.check(got)
    assert numbers["results_bad"] == numbers["commits_gap"] == 128
    assert len(calls) == 2
