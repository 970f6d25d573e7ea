"""The early-abort differential on a YCSB-A contention storm, on the
port's Cluster and the JAX package's: with the conflict detector off and
on, each package gives the same results, stores and registers, also after
WAL recovery, and the port's runs equal the JAX runs."""
import copy

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.hotset import build_hot_index as j_build_hot_index  # noqa: E402,E501
from repro.core.packets import ADD, SwitchConfig  # noqa: E402
from repro.db.dbms import Cluster as JCluster  # noqa: E402
from repro.workloads import storms as j_storms  # noqa: E402
from repro_torch.core.hotset import build_hot_index  # noqa: E402
from repro_torch.core.packets import SwitchConfig as TSwitchConfig  # noqa: E402,E501
from repro_torch.db.dbms import Cluster as TCluster  # noqa: E402
from repro_torch.workloads import storms as t_storms  # noqa: E402
from test_torch_dbms import _assert_same, _port_txns, _same_results  # noqa: E402,E501


def _stores(c):
    return [dict(n.store) for n in c.nodes]


# tests/test_contention.py:386-388
DIFF_P = dict(n_nodes=2, keys_per_node=60, contended_per_node=2,
              hot_per_node=4, p_hot_txn=0.4)
BSW = SwitchConfig(n_stages=4, regs_per_stage=16, max_instrs=4)
TBSW = TSwitchConfig(n_stages=4, regs_per_stage=16, max_instrs=4)


def _storm_runs(pkg, txns, mode):
    """The early-abort differential of tests/test_contention.py:391-
    416 on one package: (cluster, results) with the detector off, on."""
    storms, Cluster, build, sw, kw = (
        (j_storms, JCluster, j_build_hot_index, BSW, {}) if pkg == "jax"
        else (t_storms, TCluster, build_hot_index, TBSW,
              dict(device="cpu")))
    p = storms.StormParams(**DIFF_P)
    hi = build([[(k, ADD)] for k in storms.hot_keys(p)], 16, sw)
    outs = []
    for ea in (False, True):
        c = Cluster(p.n_nodes, sw, hi, use_switch=True, switch_mode=mode,
                    early_abort=ea, **kw)
        for k in storms.hot_keys(p):
            c.load(k, 10)
            c.switch.read_all()
        c.snapshot_offload()
        res = list(c.run_batch([copy.deepcopy(t) for t in txns]))
        c.drain()
        outs.append((c, res))
    return outs


@pytest.mark.parametrize("mode", ["pallas", "auto"])
def test_early_abort_storm_differential_matches_jax(mode):
    jtxns = j_storms.ycsb_a_storm(np.random.default_rng(9), 50,
                                  j_storms.StormParams(**DIFF_P))
    ttxns = t_storms.ycsb_a_storm(np.random.default_rng(9), 50,
                                  t_storms.StormParams(**DIFF_P))
    assert [(t.kind, tuple(t.ops), t.home) for t in jtxns] == \
        [(t.kind, tuple(t.ops), t.home) for t in ttxns]
    # each package numbers its txns itself: the WALs compare equal tids
    (j_off, jr_off), (j_on, jr_on) = _storm_runs("jax", jtxns, mode)
    (t_off, tr_off), (t_on, tr_on) = _storm_runs("torch", _port_txns(jtxns),
                                                 mode)
    assert tr_off == tr_on
    assert _stores(t_off) == _stores(t_on)
    np.testing.assert_array_equal(t_off.switch.read_all(),
                                  t_on.switch.read_all())
    _same_results(jr_off, tr_off)
    assert t_on.stats["warm"] > 0 and t_on.stats["cold"] > 0
    for jc, tc in ((j_off, t_off), (j_on, t_on)):
        _assert_same(jc, tc)
        assert _stores(jc) == _stores(tc)
    # WAL-recoverable state identical too
    for c in (j_off, j_on, t_off, t_on):
        for nid in range(len(c.nodes)):
            c.crash_node_and_recover(nid)
        c.crash_switch_and_recover()
    assert _stores(t_off) == _stores(t_on) == _stores(j_off)
    np.testing.assert_array_equal(t_off.switch.read_all(),
                                  t_on.switch.read_all())
    np.testing.assert_array_equal(j_off.switch.read_all(),
                                  t_on.switch.read_all())
