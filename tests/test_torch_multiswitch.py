"""The port's sharded register plane against the JAX package's:
``ShardedSwitchEngine`` at N in {1, 2, 4} (cross-shard rows, CADD and
cross-shard ADDP forwarding included), N = 1 byte-identical to the
port's ``SwitchEngine``, whole clusters across shard counts, recovery at
N = 2, a migration crossing an undrained batch at N = 2 with the port's
``EpochController``, and sharded state carried over by ``convert_state``.
Everything is int32 or exact host state, so every comparison is exact
(the workloads and placements of tests/test_multiswitch.py)."""
import copy
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as jeng  # noqa: E402
from repro.core.heat import HeatTracker as JHeatTracker  # noqa: E402
from repro.core.hotset import HotIndex as JHotIndex  # noqa: E402
from repro.core.hotset import build_hot_index as j_build_hot_index  # noqa: E402,E501
from repro.core.layout import Placement as JPlacement  # noqa: E402
from repro.core.packets import ADD, ADDP, CADD, READ, WRITE  # noqa: E402
from repro.core.packets import SwitchConfig  # noqa: E402
from repro.core.packets import build_packets as j_build_packets  # noqa: E402
from repro.db.dbms import Cluster as JCluster  # noqa: E402
from repro.db.migrate import EpochController as JEpochController  # noqa: E402,E501
from repro.db.txn import Txn, key_of  # noqa: E402
from repro_torch.convert import convert_state  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.heat import HeatTracker  # noqa: E402
from repro_torch.core.hotset import HotIndex, build_hot_index  # noqa: E402
from repro_torch.core.layout import Placement  # noqa: E402
from repro_torch.core.packets import SwitchConfig as TSwitchConfig  # noqa: E402,E501
from repro_torch.core.packets import build_packets  # noqa: E402
from repro_torch.db.dbms import Cluster as TCluster  # noqa: E402
from repro_torch.db.migrate import EpochController  # noqa: E402
from repro_torch.db.txn import Txn as TTxn  # noqa: E402
from test_multiswitch import (_mixed_txns, _round_robin_placement,  # noqa: E402,E501
                              _safe_txns, _workload)

S, R, M = 4, 32, 8
N_NODES = 2


def _cfgs(n):
    kw = dict(n_stages=S, regs_per_stage=R, max_instrs=M, n_switches=n)
    return SwitchConfig(**kw), TSwitchConfig(**kw)


def _port_txns(txns):
    return [TTxn(t.kind, list(t.ops), t.home, tid=t.tid) for t in txns]


def _packets(txns, slot, n):
    """The same txns through each package's packet builder under one
    placement; the two encodings must be identical."""
    jcfg, tcfg = _cfgs(n)
    jp, jm = j_build_packets(txns, JHotIndex(JPlacement(slot=dict(slot))),
                             jcfg)
    tp, tm = build_packets(_port_txns(txns), HotIndex(Placement(
        slot=dict(slot))), tcfg)
    assert jp.keys() == tp.keys()
    for k in jp:
        np.testing.assert_array_equal(jp[k], tp[k])
    return (jp, jm), (tp, tm)


def _drain(engine, pkts, meta, mode):
    pb = engine.execute_batch(copy.deepcopy(pkts), dict(meta), mode=mode)
    return pb.results_np().copy(), np.asarray(pb.ok_np()).copy()


def _engines_match(n, txns, slot, mode, async_dispatch=False, repeat=1):
    (jp, jm), (tp, tm) = _packets(txns, slot, n)
    jcfg, tcfg = _cfgs(n)
    je = jeng.ShardedSwitchEngine(jcfg, async_dispatch=async_dispatch)
    te = teng.ShardedSwitchEngine(tcfg, async_dispatch=async_dispatch,
                                  device="cpu")
    for _ in range(repeat):
        r1, ok1 = _drain(je, jp, jm, mode)
        r2, ok2 = _drain(te, tp, tm, mode)
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(ok1, ok2)
    np.testing.assert_array_equal(je.read_all(), te.read_all())
    assert je.next_gid == te.next_gid
    assert je.dispatch_count == te.dispatch_count
    return je, te


@pytest.mark.parametrize("mode", ["auto", "serial"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_engine_matches_jax_mixed(n, mode):
    """Random batches with cross-shard rows, CADD and repeated keys."""
    rng = np.random.default_rng(11 + n)
    keys = [key_of(0, i) for i in range(32)]
    txns = _mixed_txns(rng, keys, 24, [READ, WRITE, ADD, CADD])
    slot = _round_robin_placement(n, keys).slot
    _, te = _engines_match(n, txns, slot, mode, repeat=2)
    assert te.read_all().shape == ((S, R) if n == 1 else (n, S, R))


@pytest.mark.parametrize("mode", ["affine", "staged", "pallas"])
def test_sharded_engine_matches_jax_safe_modes(mode):
    rng = np.random.default_rng(5)
    keys = [key_of(0, i) for i in range(32)]
    slot = _round_robin_placement(2, keys).slot
    txns = _safe_txns(rng, JHotIndex(JPlacement(slot=slot)), keys, 24)
    _engines_match(2, txns, slot, mode)


def test_async_sharded_engine_matches_jax():
    rng = np.random.default_rng(9)
    keys = [key_of(0, i) for i in range(32)]
    txns = _mixed_txns(rng, keys, 24, [READ, WRITE, ADD, CADD])
    _engines_match(2, txns, _round_robin_placement(2, keys).slot, "auto",
                   async_dispatch=True, repeat=2)


def test_cross_shard_addp_forwarding_matches_jax():
    """ADDP whose source register lives on ANOTHER switch: the operand is
    forwarded on the host (tests/test_multiswitch.py's case)."""
    A, B, C = key_of(0, 0), key_of(0, 1), key_of(0, 2)
    slot = {A: (0, 0, 0), B: (1, 0, 0), C: (1, 1, 0)}
    txns = [Txn("w", [(WRITE, A, 7), (WRITE, B, 30), (WRITE, C, 500)], 0),
            Txn("u", [(READ, B, 0), (ADDP, A, 0)], 0),
            Txn("s", [(ADD, A, 1), (READ, C, 0)], 0),
            Txn("u2", [(READ, A, 0), (ADDP, C, 0)], 0)]
    _, te = _engines_match(2, txns, slot, "auto")
    assert te.read_value((0, 0, 0)) == 38
    assert te.read_value((1, 1, 0)) == 538


@pytest.mark.parametrize("mode", ["auto", "serial", "affine", "staged",
                                  "pallas"])
def test_n1_facade_byte_identical(mode):
    """With one shard the facade delegates verbatim: results, registers,
    GIDs and dispatch counts equal the port's plain SwitchEngine."""
    rng = np.random.default_rng(3)
    keys = [key_of(0, i) for i in range(24)]
    slot = _round_robin_placement(1, keys).slot
    txns = _safe_txns(rng, JHotIndex(JPlacement(slot=slot)), keys, 20)
    _, (tp, tm) = _packets(txns, slot, 1)
    _, tcfg = _cfgs(1)
    ref = teng.SwitchEngine(tcfg, device="cpu")
    sh = teng.ShardedSwitchEngine(tcfg, device="cpu")
    for _ in range(3):
        r1, r2 = _drain(ref, tp, tm, mode), _drain(sh, tp, tm, mode)
        np.testing.assert_array_equal(r1[0], r2[0])
        np.testing.assert_array_equal(r1[1], r2[1])
    np.testing.assert_array_equal(ref.read_all(), sh.read_all())
    assert ref.next_gid == sh.next_gid
    assert ref.dispatch_count == sh.dispatch_count
    assert sh.registers is sh.planes[0].registers


def test_sharded_snapshot_restore_and_merged_handle():
    rng = np.random.default_rng(21)
    keys = [key_of(0, i) for i in range(16)]
    slot = _round_robin_placement(2, keys).slot
    txns = _mixed_txns(rng, keys, 12, [WRITE, ADD])
    _, (tp, tm) = _packets(txns, slot, 2)
    e = teng.ShardedSwitchEngine(_cfgs(2)[1], device="cpu")
    e.execute_batch(tp, tm).results_np()
    snap = e.snapshot()
    before = e.read_all().copy()
    res, ok, gids = e.execute_batch(tp, tm)
    assert isinstance(res, torch.Tensor) and res.shape == (12, M)
    assert ok.dtype == torch.bool and len(gids) == 12
    e.restore(snap)
    np.testing.assert_array_equal(before, e.read_all())
    assert e.registers.shape == (2, S, R)
    e.registers = np.zeros((2, S, R), np.int32)
    assert not e.read_all().any()


# ------------------------------------------------------------ clusters --

def _cluster_pair(n, traces, hot, mode, async_hot, **kw):
    jcfg, tcfg = _cfgs(n)
    jhi = j_build_hot_index(traces, len(hot), jcfg)
    thi = build_hot_index(traces, len(hot), tcfg)
    assert dict(jhi.placement.slot) == dict(thi.placement.slot)
    jc = JCluster(N_NODES, jcfg, jhi, use_switch=True, switch_mode=mode,
                  async_hot=async_hot, **kw)
    tc = TCluster(N_NODES, tcfg, thi, use_switch=True, switch_mode=mode,
                  async_hot=async_hot, device="cpu", **kw)
    for k in hot:
        jc.load(k, 100)
        jc.switch.read_all()    # the reference load race (test_torch_dbms)
        tc.load(k, 100)
    for c in (jc, tc):
        c.snapshot_offload()
    return jc, tc


def _wal(c):
    return [[(r.kind, r.tid, r.payload) for r in n.wal] for n in c.nodes]


def _assert_same(jc, tc):
    np.testing.assert_array_equal(jc.switch.read_all(), tc.switch.read_all())
    assert jc.switch.next_gid == tc.switch.next_gid
    assert dict(jc.stats) == dict(tc.stats)
    assert _wal(jc) == _wal(tc)
    for a, b in zip(jc.nodes, tc.nodes):
        assert dict(a.store) == dict(b.store)


@pytest.mark.parametrize("async_hot", [False, True])
@pytest.mark.parametrize("mode", ["auto", "serial"])
def test_clusters_across_shard_counts_match_jax(mode, async_hot):
    """At N = 1, 2, 4: the port cluster equals the JAX cluster of the same
    N, and every N gives the same results, GIDs, per-key values and WAL
    stream as N = 1."""
    txns, traces, hot = _workload()
    worlds = {}
    for n in (1, 2, 4):
        jc, tc = _cluster_pair(n, traces, hot, mode, async_hot)
        r1, r2 = [], []
        for i in range(0, len(txns), 32):
            r1 += jc.run_batch([copy.deepcopy(t) for t in txns[i:i + 32]])
            r2 += tc.run_batch(_port_txns(txns[i:i + 32]))
        for c in (jc, tc):
            c.drain()
        assert r1 == r2
        _assert_same(jc, tc)
        worlds[n] = (tc, r2)
    c1, r1 = worlds[1]
    for n in (2, 4):
        cn, rn = worlds[n]
        assert r1 == rn and c1.switch.next_gid == cn.switch.next_gid
        assert [c1.read(k) for k in hot] == [cn.read(k) for k in hot]
        assert [[(e.kind, e.tid) for e in nd.wal] for nd in c1.nodes] == \
            [[(e.kind, e.tid) for e in nd.wal] for nd in cn.nodes]
        assert isinstance(cn.switch, teng.ShardedSwitchEngine)


def test_cluster_recovery_at_n2_matches_jax():
    """Crash/recover and failover of the sharded plane: WAL replay onto
    the [2, S, R] register stack reproduces the pre-crash state."""
    txns, traces, hot = _workload(n_txns=80, seed=17)
    jc, tc = _cluster_pair(2, traces, hot, "auto", False, standby=True)
    assert jc.run_batch([copy.deepcopy(t) for t in txns]) == \
        tc.run_batch(_port_txns(txns))
    before = tc.switch.read_all().copy()
    assert before.shape == (2, S, R)
    for recover in ("crash_switch_and_recover", "fail_over"):
        for c in (jc, tc):
            getattr(c, recover)()
        np.testing.assert_array_equal(before, tc.switch.read_all())
        _assert_same(jc, tc)


def test_migration_crosses_undrained_batch_n2_matches_jax(monkeypatch):
    """tests/test_multiswitch.py's case on both packages: an epoch
    controller migrates between shards while async hot groups are
    undrained; sync and async port clusters equal the JAX ones."""
    import repro.db.migrate as jm
    import repro_torch.db.migrate as tm
    for m in (jm, tm):
        monkeypatch.setattr(m, "_MIG_TID", itertools.count(1 << 40))
    A1, A2 = key_of(0, 0), key_of(0, 1)
    Bk = [key_of(0, 10 + i) for i in range(2)]
    slot = {A1: (0, 0, 0), A2: (1, 0, 0)}
    txns = [Txn("h", [(ADD, A1, i + 1), (READ, A2, 0)], 0)
            for i in range(6)]
    txns += [Txn("c", [(ADD, Bk[i % 2], 7)], 0) for i in range(30)]
    loads = [(A1, 5), (A2, 11), (Bk[0], 100), (Bk[1], 200)]
    jcfg, tcfg = _cfgs(2)

    def build(async_hot):
        jc = JCluster(1, jcfg, JHotIndex(JPlacement(slot=dict(slot))),
                      use_switch=True, async_hot=async_hot, max_inflight=8)
        tc = TCluster(1, tcfg, HotIndex(Placement(slot=dict(slot))),
                      use_switch=True, async_hot=async_hot, max_inflight=8,
                      device="cpu")
        for k, v in loads:
            jc.load(k, v)
            jc.switch.read_all()
            tc.load(k, v)
        for c in (jc, tc):
            c.snapshot_offload()
        JEpochController(jc, JHeatTracker(window=64, decay=0.5),
                         interval=25, top_k=2)
        EpochController(tc, HeatTracker(window=64, decay=0.5),
                        interval=25, top_k=2)
        return jc, tc

    worlds = [build(False), build(True)]
    for jc, tc in worlds:
        assert jc.run_batch([copy.deepcopy(t) for t in txns]) == \
            tc.run_batch(_port_txns(txns))
        assert tc.stats["migrations"] == 1
        assert tc.nodes[0].store[A1] == 5 + sum(range(1, 7))
        _assert_same(jc, tc)
        assert tc.controller.plans == jc.controller.plans
        before = tc.switch.read_all().copy()
        for c in (jc, tc):
            c.crash_switch_and_recover()
        np.testing.assert_array_equal(before, tc.switch.read_all())
    np.testing.assert_array_equal(worlds[0][1].switch.read_all(),
                                  worlds[1][1].switch.read_all())


def test_converted_sharded_state_continues_like_jax():
    """A JAX N = 2 cluster's [2, S, R] registers, placement and stores,
    carried into a port N = 2 cluster by convert_state, continue exactly
    like the JAX cluster."""
    txns, traces, hot = _workload(n_txns=120, seed=23)
    jcfg, tcfg = _cfgs(2)
    jhi = j_build_hot_index(traces, len(hot), jcfg)
    jc = JCluster(N_NODES, jcfg, jhi, use_switch=True)
    jc.snapshot_offload()
    jc.run_batch(txns[:60])
    regs, thi, stores = convert_state(
        jc.switch.read_all(), dict(jhi.placement.slot),
        [dict(n.store) for n in jc.nodes], device="cpu")
    assert tuple(regs.shape) == (2, S, R) and regs.dtype == torch.int32
    tc = TCluster(N_NODES, tcfg, thi, use_switch=True, device="cpu")
    tc.switch.load_registers(regs)
    tc.switch.next_gid = jc.switch.next_gid
    for n, st in zip(tc.nodes, stores):
        n.store = st
    n_wal = [len(n.wal) for n in jc.nodes]
    assert jc.run_batch(txns[60:]) == tc.run_batch(_port_txns(txns[60:]))
    np.testing.assert_array_equal(jc.switch.read_all(), tc.switch.read_all())
    assert jc.switch.next_gid == tc.switch.next_gid
    for jn, tn, n0 in zip(jc.nodes, tc.nodes, n_wal):
        assert [(r.kind, r.tid, r.payload) for r in jn.wal[n0:]] == \
            [(r.kind, r.tid, r.payload) for r in tn.wal]
    for k in hot:
        assert jc.read(k) == tc.read(k)
