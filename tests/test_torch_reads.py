"""The port's read tier against the JAX package's: ``Cluster.read_batch``,
``Cluster.read`` and ``Cluster.scan`` (with and without ``limit``) over
``execute_reads`` / ``execute_scan`` and the scan kernels, driven by the
randomized mixed stream of tests/test_reads.py on a JAX cluster and a
port cluster side by side.  Every read-class output, every run_batch
result, the registers, GIDs, stats and WAL records must agree exactly,
at one and two switches, sync and async, in ``auto`` and ``pallas``
mode, and through a migration (interrupted or completed) with the
port's ``migrate``."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.hotset import build_hot_index as j_build_hot_index  # noqa: E402,E501
from repro.core.packets import SwitchConfig  # noqa: E402
from repro.db.conflict import GAVE_UP as J_GAVE_UP  # noqa: E402
from repro.db.dbms import Cluster as JCluster  # noqa: E402
from repro.db.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro.db.faults import SimulatedCrash as JSimulatedCrash  # noqa: E402
from repro.db.faults import SwitchUnavailable as JSwitchUnavailable  # noqa: E402,E501
from repro.db.migrate import migrate as j_migrate  # noqa: E402
from repro.db.txn import key_of  # noqa: E402
from repro_torch.core.hotset import build_hot_index  # noqa: E402
from repro_torch.core.packets import SwitchConfig as TSwitchConfig  # noqa: E402,E501
from repro_torch.db.conflict import GAVE_UP as T_GAVE_UP  # noqa: E402
from repro_torch.db.dbms import Cluster as TCluster  # noqa: E402
from repro_torch.db.faults import FaultPlan  # noqa: E402
from repro_torch.db.faults import SimulatedCrash  # noqa: E402
from repro_torch.db.faults import SwitchUnavailable  # noqa: E402
from repro_torch.db.migrate import migrate  # noqa: E402
from repro_torch.db.txn import Txn as TTxn  # noqa: E402
from test_reads import _mixed_txns  # noqa: E402

S, R, MI = 4, 32, 8
N_NODES = 4


def _cfgs(n=1):
    kw = dict(n_stages=S, regs_per_stage=R, max_instrs=MI, n_switches=n)
    return SwitchConfig(**kw), TSwitchConfig(**kw)


def _port_txns(txns):
    return [TTxn(t.kind, list(t.ops), t.home, tid=t.tid) for t in txns]


def _indexes(keys, n):
    jcfg, tcfg = _cfgs(n)
    traces = [[(k, "W")] for k in keys]
    jhi = j_build_hot_index(traces, len(keys), jcfg)
    thi = build_hot_index(traces, len(keys), tcfg)
    assert dict(jhi.placement.slot) == dict(thi.placement.slot)
    assert set(thi.placement.slot) == set(keys)
    return jhi, thi


def _twins(n_switches=1, async_hot=False, mode="auto", seed=0, **kw):
    """(JAX cluster, port cluster, hot keys, cold keys) over one placement,
    loaded with the same seeded values (the fixture of test_reads.py)."""
    jcfg, tcfg = _cfgs(n_switches)
    hot = [key_of(nd, i) for nd in range(N_NODES) for i in range(12)]
    cold = [key_of(nd, 500 + i) for nd in range(N_NODES) for i in range(6)]
    jhi, thi = _indexes(hot, n_switches)
    jfp, tfp = kw.pop("fault_plans", (None, None))
    jc = JCluster(N_NODES, jcfg, jhi, async_hot=async_hot, switch_mode=mode,
                  fault_plan=jfp, **kw)
    tc = TCluster(N_NODES, tcfg, thi, async_hot=async_hot, switch_mode=mode,
                  fault_plan=tfp, device="cpu", **kw)
    rng = np.random.default_rng(seed)
    for k in hot + cold:
        v = int(rng.integers(0, 100))
        jc.load(k, v)
        jc.switch.read_all()    # the reference load race (test_torch_dbms)
        tc.load(k, v)
    for c in (jc, tc):
        c.snapshot_offload()
    return jc, tc, hot, cold


def _wal(c):
    return [[(r.kind, r.tid, r.payload) for r in n.wal] for n in c.nodes]


def _assert_same_state(jc, tc):
    np.testing.assert_array_equal(jc.switch.read_all(), tc.switch.read_all())
    assert jc.switch.next_gid == tc.switch.next_gid
    assert jc.switch.read_dispatch_count == tc.switch.read_dispatch_count
    assert dict(jc.stats) == dict(tc.stats)
    assert _wal(jc) == _wal(tc)


def _outcome(c, fn):
    """``fn(c)``'s value, or the unavailability it raised."""
    try:
        return "ok", fn(c)
    except (JSwitchUnavailable, SwitchUnavailable) as e:
        return "unavailable", str(e)


def _both(jc, tc, fn):
    """``fn`` on both clusters: equal values, or the same error."""
    a, b = _outcome(jc, fn), _outcome(tc, fn)
    assert a == b
    return a[1]


def _stream(jc, tc, hot, cold, seed=1, n_steps=12, allow_cadd=True):
    """tests/test_reads.py's differential stream, with the JAX cluster in
    the oracle's place: write batches interleaved with batch reads, point
    reads and scans with and without limit."""
    rng = np.random.default_rng(seed)
    all_keys = hot + cold
    for step in range(n_steps):
        txns = _mixed_txns(rng, hot, cold, int(rng.integers(1, 5)),
                           allow_cadd)
        r1 = jc.run_batch([copy.deepcopy(t) for t in txns])
        r2 = tc.run_batch(_port_txns(txns))
        assert [("GAVE_UP" if r is J_GAVE_UP else r) for r in r1] == \
            [("GAVE_UP" if r is T_GAVE_UP else r) for r in r2]
        if step % 2 == 0:
            ks = [int(k) for k in rng.choice(all_keys, size=10,
                                              replace=False)]
            _both(jc, tc, lambda c: c.read_batch(ks))
        if step % 3 == 0:
            k = int(rng.choice(all_keys))
            _both(jc, tc, lambda c: c.read(k))
        if step % 4 == 0:
            lo = int(rng.integers(-10, 60))
            hi_ = lo + int(rng.integers(0, 90))
            lim = int(rng.integers(1, 7))
            _both(jc, tc, lambda c: c.scan(lo, hi_))
            _both(jc, tc, lambda c: c.scan(lo, hi_, keys=all_keys,
                                           limit=lim))
    for c in (jc, tc):
        c.drain()
    assert _both(jc, tc, lambda c: c.read_batch(all_keys))
    _both(jc, tc, lambda c: c.scan(-10 ** 6, 10 ** 6, keys=all_keys,
                                   limit=5))
    _assert_same_state(jc, tc)


@pytest.mark.parametrize("async_hot", [False, True])
@pytest.mark.parametrize("n_switches", [1, 2])
@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_mixed_stream_matches_jax(n_switches, async_hot, mode):
    jc, tc, hot, cold = _twins(n_switches, async_hot, mode)
    _stream(jc, tc, hot, cold, allow_cadd=(mode == "auto"))
    # a truncated first pass (more than 16 matches) rescans at the exact
    # count: two scan dispatches per plane holding matches
    before = tc.switch.read_dispatch_count
    assert len(_both(jc, tc, lambda c: c.scan(-10 ** 6, 10 ** 6))) == \
        len(hot)
    assert tc.switch.read_dispatch_count - before == 2 * n_switches
    assert tc.stats["scans_switch"] > 0


@pytest.fixture(autouse=True)
def _fresh_migration_tids(monkeypatch):
    """Both packages number migrations from one module-level counter; a
    fresh one on each side keeps the WAL records comparable whatever ran
    before in this process."""
    import itertools

    import repro.db.migrate as jm
    import repro_torch.db.migrate as tm
    for m in (jm, tm):
        monkeypatch.setattr(m, "_MIG_TID", itertools.count(1 << 40))


def _rotated(hot, n, drop=8):
    keep = hot[drop:]
    return _indexes(keep, n), hot[:drop]


def test_reads_mid_migration_match_jax():
    """A migration interrupted after its evict step: evicted keys read
    from their home stores, every other hot key is unavailable, scans
    over the readable subset still answer, and recovery restores full
    service — the same on both sides."""
    jc, tc, hot, cold = _twins(fault_plans=(JFaultPlan("mid_migration"),
                                            FaultPlan("mid_migration")))
    _stream(jc, tc, hot, cold, n_steps=6)
    (jhi, thi), evicted = _rotated(hot, 1)
    with pytest.raises(JSimulatedCrash):
        j_migrate(jc, jhi)
    with pytest.raises(SimulatedCrash):
        migrate(tc, thi)
    readable = evicted + cold
    _both(jc, tc, lambda c: c.read_batch(readable))
    _both(jc, tc, lambda c: c.read(evicted[0]))
    assert _both(jc, tc, lambda c: c.read_batch([hot[-1]])).startswith(
        "hot keys")
    _both(jc, tc, lambda c: c.scan(0, 10 ** 6))
    _both(jc, tc, lambda c: c.scan(0, 10 ** 6, keys=readable))
    for c in (jc, tc):
        c.recover_switch()
    _both(jc, tc, lambda c: c.read_batch(hot + cold))
    _stream(jc, tc, hot, cold, seed=9, n_steps=4)


@pytest.mark.parametrize("n_switches", [1, 2])
def test_reads_after_completed_migration_match_jax(n_switches):
    """Keys a completed migration evicted are store-served with their
    values carried over; the rest stays switch-served."""
    jc, tc, hot, cold = _twins(n_switches)
    _stream(jc, tc, hot, cold, n_steps=6)
    (jhi, thi), evicted = _rotated(hot, n_switches)
    jplan, tplan = j_migrate(jc, jhi), migrate(tc, thi)
    assert jplan.summary() == tplan.summary()
    before = tc.stats["store_reads"]
    _both(jc, tc, lambda c: c.read_batch(evicted))
    assert tc.stats["store_reads"] - before == len(evicted)
    _both(jc, tc, lambda c: c.read_batch(hot + cold))
    assert len(_both(jc, tc, lambda c: c.scan(-10 ** 6, 10 ** 6))) == \
        len(hot) - len(evicted)
    _assert_same_state(jc, tc)
    _stream(jc, tc, hot, cold, seed=5, n_steps=4)
