"""The port's Cluster against the JAX package's on the same transactions:
per-txn results, registers, GIDs, stats, every WAL record and the hash
chain's head, and registers after crash recovery and warm-standby
failover must all agree exactly (the harness of tests/test_batch.py, with
the JAX cluster on one side and the port's on the other)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.hotset import build_hot_index as j_build_hot_index  # noqa: E402,E501
from repro.core.packets import ADDP, SwitchConfig  # noqa: E402
from repro.db.conflict import GAVE_UP as J_GAVE_UP  # noqa: E402
from repro.db.dbms import Cluster as JCluster  # noqa: E402
from repro.workloads import smallbank, ycsb  # noqa: E402
from repro_torch.convert import convert_state  # noqa: E402
from repro_torch.core.hotset import build_hot_index  # noqa: E402
from repro_torch.core.packets import SwitchConfig as TSwitchConfig  # noqa: E402,E501
from repro_torch.db.conflict import GAVE_UP as T_GAVE_UP  # noqa: E402
from repro_torch.db.dbms import Cluster as TCluster  # noqa: E402
from repro_torch.db.txn import Txn as TTxn  # noqa: E402

SW = SwitchConfig(n_stages=16, regs_per_stage=512, max_instrs=16)
TSW = TSwitchConfig(n_stages=16, regs_per_stage=512, max_instrs=16)


def _port_txns(txns):
    """Port Txns rebuilt from JAX Txns (the port keeps its own tid
    counter, so tids are carried explicitly)."""
    return [TTxn(t.kind, list(t.ops), t.home, tid=t.tid) for t in txns]


def _ycsb(n=240):
    p = ycsb.YCSBParams(n_nodes=4, keys_per_node=1000, hot_per_node=16,
                        variant="A")
    traces = ycsb.traces(ycsb.generate(np.random.default_rng(0), 1500, p))
    txns = ycsb.generate(np.random.default_rng(1), n, p)
    return traces, 64, txns, [], 4


def _smallbank(n=240, no_addp=False, top_k=16):
    p = smallbank.SmallBankParams(n_nodes=2, accounts_per_node=50,
                                  hot_per_node=4)
    traces = smallbank.traces(
        smallbank.generate(np.random.default_rng(0), 2000, p))
    txns = smallbank.generate(np.random.default_rng(1), n, p)
    if no_addp:
        txns = [t for t in txns if all(o != ADDP for o, _, _ in t.ops)]
    loads = [(k, 100) for k in smallbank.hot_keys(p)]
    return traces, top_k, txns, loads, 2


def _indexes(traces, top_k):
    jhi = j_build_hot_index(traces, top_k, SW)
    thi = build_hot_index(traces, top_k, TSW)
    assert dict(jhi.placement.slot) == dict(thi.placement.slot)
    return jhi, thi


def _same_results(r1, r2):
    """Equal per-txn results; each package has its own GAVE_UP sentinel
    (a txn that exhausted its retries)."""
    assert [("GAVE_UP" if r is J_GAVE_UP else r) for r in r1] == \
        [("GAVE_UP" if r is T_GAVE_UP else r) for r in r2]


def _wal(c):
    return [[(r.kind, r.tid, r.payload) for r in n.wal] for n in c.nodes]


def _assert_same(jc, tc):
    np.testing.assert_array_equal(jc.switch.read_all(), tc.switch.read_all())
    assert jc.switch.next_gid == tc.switch.next_gid
    assert dict(jc.stats) == dict(tc.stats)
    assert _wal(jc) == _wal(tc)
    for jn, tn in zip(jc.nodes, tc.nodes):
        assert jn.wal[-1].hash == tn.wal[-1].hash


def _clusters(jhi, thi, loads, n_nodes, mode, async_hot=False):
    jc = JCluster(n_nodes, SW, jhi, switch_mode=mode, standby=True,
                  async_hot=async_hot)
    tc = TCluster(n_nodes, TSW, thi, switch_mode=mode, standby=True,
                  async_hot=async_hot, device="cpu")
    for k, v in loads:
        # A reference load is a WRITE-only dispatch: its result plane has
        # no device rows, so nothing waits for the dispatch, and a few
        # loads later the recycled staging buffer is rewritten before the
        # reference's asynchronous host-to-device copy has read it (a load
        # is then lost at random).  Waiting on the registers keeps the
        # reference exact; the port copies the buffer synchronously.
        jc.load(k, v)
        jc.switch.read_all()
        tc.load(k, v)
    assert all(tc.read(k) == v for k, v in loads)
    for c in (jc, tc):
        c.snapshot_offload()
    return jc, tc


def _assert_equivalent(work, mode, batch_size=64, async_hot=False):
    traces, top_k, txns, loads, n_nodes = work
    jc, tc = _clusters(*_indexes(traces, top_k), loads, n_nodes, mode,
                       async_hot)
    ttxns = _port_txns(txns)
    out1, out2 = [], []
    for i in range(0, len(txns), batch_size):
        out1.append(jc.run_batch(txns[i:i + batch_size]))
        out2.append(tc.run_batch(ttxns[i:i + batch_size]))
    # async results stay undrained until read here
    _same_results([r for out in out1 for r in out],
                  [r for out in out2 for r in out])
    assert jc.stats["hot"] > 0
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
    return jc, tc


@pytest.mark.parametrize("mode", ["pallas", "auto"])
def test_ycsb_matches_jax(mode):
    jc, _ = _assert_equivalent(_ycsb(), mode)
    assert jc.stats["cold"] > 0


def test_ycsb_async_matches_jax():
    """The async hot path (dispatch thread + lazy result plane, copied
    from the reference) against the JAX async cluster: WAL records land
    at drain, so both sides drain at the same points."""
    _assert_equivalent(_ycsb(), "pallas", async_hot=True)


def test_smallbank_no_addp_pallas_matches_jax():
    """CADD-bearing mix through the pallas path (ADDP excluded: the kernel
    has no ADDP opcode)."""
    _assert_equivalent(_smallbank(no_addp=True), "pallas", batch_size=50)


def test_smallbank_auto_matches_jax():
    """Full SmallBank in auto mode: CADD (serial), ADDP (staged), and a
    hot index too small for the hot set, so warm txns occur."""
    jc, _ = _assert_equivalent(_smallbank(top_k=8), "auto")
    assert jc.stats["warm"] > 0


def test_converted_state_continues_like_jax():
    """120 txns on a JAX cluster, its state carried into a port cluster by
    convert_state, then the next 120 txns on both."""
    traces, top_k, txns, loads, n_nodes = _ycsb(n=240)
    jhi, _ = _indexes(traces, top_k)
    jc = JCluster(n_nodes, SW, jhi, switch_mode="pallas")
    jc.snapshot_offload()
    jc.run_batch(txns[:120])
    regs, thi, stores = convert_state(
        jc.switch.read_all(), dict(jhi.placement.slot),
        [dict(n.store) for n in jc.nodes], device="cpu")
    assert regs.dtype == torch.int32 and regs.device.type == "cpu"
    tc = TCluster(n_nodes, TSW, thi, switch_mode="pallas", device="cpu")
    tc.switch.load_registers(regs)
    tc.switch.next_gid = jc.switch.next_gid
    for n, st in zip(tc.nodes, stores):
        n.store = st
    n_wal = [len(n.wal) for n in jc.nodes]
    r1 = jc.run_batch(txns[120:])
    r2 = tc.run_batch(_port_txns(txns[120:]))
    _same_results(r1, r2)
    np.testing.assert_array_equal(jc.switch.read_all(), tc.switch.read_all())
    assert jc.switch.next_gid == tc.switch.next_gid
    for jn, tn, n0 in zip(jc.nodes, tc.nodes, n_wal):
        assert [(r.kind, r.tid, r.payload) for r in jn.wal[n0:]] == \
            [(r.kind, r.tid, r.payload) for r in tn.wal]
        assert {k: v for k, v in jn.store.items() if v} == \
            {k: v for k, v in tn.store.items() if v}


def test_cluster_device_and_sharded_scan_paths():
    """The default device is cuda (raises without a GPU); an
    ``n_switches=2`` cluster builds the sharded plane on the cluster's
    device, and ``scan`` answers on the CPU."""
    traces, top_k, _, _, _ = _ycsb(n=1)
    thi = build_hot_index(traces, top_k, TSW)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TCluster(2, TSW, thi)
    from dataclasses import replace

    from repro_torch.core.engine import ShardedSwitchEngine
    cfg2 = replace(TSW, n_switches=2)
    c2 = TCluster(2, cfg2, build_hot_index(traces, top_k, cfg2),
                  device="cpu")
    assert isinstance(c2.switch, ShardedSwitchEngine)
    assert len(c2.switch.planes) == 2
    assert all(p.registers.device.type == "cpu" for p in c2.switch.planes)
    c = TCluster(4, TSW, thi, device="cpu")
    keys = sorted(thi.placement.slot)[:3]
    for i, k in enumerate(keys):
        c.load(k, 5 + i)
    assert c.scan(5, 6) == [(keys[0], 5), (keys[1], 6)]
    assert c.scan(0, 10, keys=keys, limit=1) == [(keys[2], 7)]
