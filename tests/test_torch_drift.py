"""Adaptive hot-set management on the port's Cluster against the JAX
package's: a drift generator moves the hot set, an ``EpochController`` on
each side migrates the switch, and registers, node stores, stats, every
WAL record and every tuple value agree exactly."""
import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.heat import HeatTracker as JHeatTracker  # noqa: E402
from repro.core.hotset import build_hot_index as j_build_hot_index  # noqa: E402,E501
from repro.core.packets import SwitchConfig  # noqa: E402
from repro.db.dbms import Cluster as JCluster  # noqa: E402
from repro.db import migrate as j_migrate  # noqa: E402
from repro.db.migrate import EpochController as JEpochController  # noqa: E402,E501
from repro.db.txn import node_of  # noqa: E402
from repro.workloads import drift as j_drift  # noqa: E402
from repro_torch.core.heat import HeatTracker as THeatTracker  # noqa: E402
from repro_torch.core.hotset import build_hot_index  # noqa: E402
from repro_torch.core.packets import SwitchConfig as TSwitchConfig  # noqa: E402,E501
from repro_torch.db.dbms import Cluster as TCluster  # noqa: E402
from repro_torch.db import migrate as t_migrate  # noqa: E402
from repro_torch.db.migrate import EpochController as TEpochController  # noqa: E402,E501
from repro_torch.workloads import drift as t_drift  # noqa: E402
from test_torch_dbms import _assert_same, _port_txns, _same_results  # noqa: E402,E501

N_NODES = 4
SW = SwitchConfig(n_stages=16, regs_per_stage=512, max_instrs=16)
TSW = TSwitchConfig(n_stages=16, regs_per_stage=512, max_instrs=16)


def _stores(c):
    return [dict(n.store) for n in c.nodes]


def _value(c, k):
    if c.use_switch and c.hot_index.is_hot(k):
        return c.switch.read_value(c.hot_index.slot(k))
    return c.nodes[node_of(k)].store[k]


# the generators of tests/test_adaptive.py:27-41
GENS = {
    "ycsb_shift": ("YCSBHotspotShift",
                   dict(n_nodes=N_NODES, keys_per_node=2000,
                        hot_per_node=16, n_blocks=4, p_hot_txn=0.9)),
    "tpcc_rotation": ("TPCCWarehouseRotation",
                      dict(n_nodes=N_NODES, n_warehouses=8, active=2)),
}


def _adaptive_pair(name, interval=160):
    """tests/test_adaptive.py:134-145 on each package: the index from
    phase 0, hot keys loaded with 5, a tracker and a controller."""
    cls, kw = GENS[name]
    jg, tg = getattr(j_drift, cls)(**kw), getattr(t_drift, cls)(**kw)
    traces = j_drift.traces(
        jg.sample_phase(np.random.default_rng(0), 0, 800))
    jhi = j_build_hot_index(traces, 16 * N_NODES, SW)
    thi = build_hot_index(traces, 16 * N_NODES, TSW)
    assert dict(jhi.placement.slot) == dict(thi.placement.slot)
    jc = JCluster(N_NODES, SW, jhi, use_switch=True)
    tc = TCluster(N_NODES, TSW, thi, use_switch=True, device="cpu")
    assert jg.hot_keys_at(0.0) == tg.hot_keys_at(0.0)
    for k in jg.hot_keys_at(0.0):
        jc.load(k, 5)
        jc.switch.read_all()       # the reference's load race (Queue 3)
        tc.load(k, 5)
    for c in (jc, tc):
        c.snapshot_offload()
    JEpochController(jc, JHeatTracker(window=1024, decay=0.2),
                     interval=interval, top_k=16 * N_NODES)
    TEpochController(tc, THeatTracker(window=1024, decay=0.2),
                     interval=interval, top_k=16 * N_NODES)
    return jg, tg, jc, tc


@pytest.mark.parametrize("name", list(GENS))
def test_migration_matches_jax(name, monkeypatch):
    # each package draws migration tids from a module-wide counter, which
    # earlier tests in this process may have advanced: start both afresh
    for mod in (j_migrate, t_migrate):
        monkeypatch.setattr(mod, "_MIG_TID", itertools.count(1 << 40))
    jg, tg, jc, tc = _adaptive_pair(name)
    keys = set()
    for i, ph in enumerate((0, 0, 1, 1)):
        jb = jg.sample_phase(np.random.default_rng(10 + i), ph, 240)
        tb = tg.sample_phase(np.random.default_rng(10 + i), ph, 240)
        assert [(t.kind, tuple(t.ops), t.home) for t in jb] == \
            [(t.kind, tuple(t.ops), t.home) for t in tb]
        _same_results(jc.run_batch(jb), tc.run_batch(_port_txns(jb)))
        keys |= {k for t in jb for k in t.keys()}
    assert tc.stats["migrations"] >= 1
    assert dict(jc.hot_index.placement.slot) == \
        dict(tc.hot_index.placement.slot)
    _assert_same(jc, tc)
    assert _stores(jc) == _stores(tc)
    for k in sorted(keys):
        assert _value(jc, k) == _value(tc, k), k
    before = tc.switch.read_all()
    for c in (jc, tc):
        c.crash_switch_and_recover()
    np.testing.assert_array_equal(before, tc.switch.read_all())
    _assert_same(jc, tc)
