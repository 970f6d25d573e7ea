"""TPC-C on the port's Cluster against the JAX package's: every txn is
warm (a cold part under 2PL on the nodes plus a switch sub-transaction,
paper §6.2), so each one is its own B = 1 switch dispatch, some of them
multipass.  Results, registers, GIDs, stats, every WAL record and hash
head, and registers after crash recovery and failover agree exactly."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.workloads import tpcc as j_tpcc  # noqa: E402
from repro_torch.workloads import tpcc as t_tpcc  # noqa: E402
from test_torch_dbms import (_assert_same, _clusters, _indexes,  # noqa: E402
                             _port_txns, _same_results)


def _tpcc(n=200):
    """The shape of tests/test_dbms.py:45-51: 4 nodes, 8 warehouses,
    top_k 250; the warehouse and district counters start at 100."""
    p = j_tpcc.TPCCParams(n_nodes=4, n_warehouses=8)
    traces = j_tpcc.traces(j_tpcc.generate(np.random.default_rng(0), 800, p))
    txns = j_tpcc.generate(np.random.default_rng(1), n, p)
    loads = [(k, 100) for k in j_tpcc.hot_keys(p)[:24]]
    return traces, 250, txns, loads, 4


@pytest.mark.parametrize("mode", ["pallas", "auto"])
def test_tpcc_warm_matches_jax(mode):
    traces, top_k, txns, loads, n_nodes = _tpcc()
    jhi, thi = _indexes(traces, top_k)
    jc, tc = _clusters(jhi, thi, loads, n_nodes, mode)
    ttxns = _port_txns(txns)
    # the port's generator gives the same stream
    p = t_tpcc.TPCCParams(n_nodes=4, n_warehouses=8)
    assert [(t.kind, tuple(t.ops), t.home) for t in
            t_tpcc.generate(np.random.default_rng(1), len(txns), p)] == \
        [(t.kind, tuple(t.ops), t.home) for t in ttxns]
    d0 = tc.switch.dispatch_count
    for i in range(0, len(txns), 64):
        _same_results(jc.run_batch(txns[i:i + 64]),
                      tc.run_batch(ttxns[i:i + 64]))
    assert tc.stats["warm"] > 0 and tc.stats["multipass"] > 0
    # one dispatch per warm txn: nothing is hot on its own
    assert tc.stats["hot"] == 0
    assert tc.switch.dispatch_count - d0 == tc.stats["warm"]
    _assert_same(jc, tc)
    before = tc.switch.read_all()
    for c in (jc, tc):
        c.crash_switch_and_recover()
    np.testing.assert_array_equal(before, tc.switch.read_all())
    _assert_same(jc, tc)
    for c in (jc, tc):
        c.fail_over()
    _assert_same(jc, tc)
    np.testing.assert_array_equal(before, tc.switch.read_all())


def test_tpcc_per_txn_run_matches_jax():
    """``Cluster.run`` one txn at a time gives the same as the JAX run."""
    traces, top_k, txns, loads, n_nodes = _tpcc(n=60)
    jc, tc = _clusters(*_indexes(traces, top_k), loads, n_nodes, "auto")
    for jt, tt in zip(txns, _port_txns(txns)):
        _same_results([jc.run(jt)], [tc.run(tt)])
    _assert_same(jc, tc)
