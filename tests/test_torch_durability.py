"""The port's durability plane against the JAX package's, at the sizes of
tests/test_durability.py (2 nodes, 24 hot keys, ``SwitchConfig(8, 128,
8)``): the segmented WAL's record hashes and ``verify()`` outcomes, the
checkpoint chain, every crash point of ``db/faults.py`` (sync and async)
with its recovery, checkpoint-interval bounds, warm-standby takeover,
the double fault, same-log replay, and a WAL saved by either package
checked by the other's ``verify`` CLI.  Registers, replay counts, stats,
every WAL record and the hash-chain heads must agree exactly."""
import collections
import copy
import itertools
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.db.migrate as j_migrate_mod  # noqa: E402
import repro_torch.db.migrate as t_migrate_mod  # noqa: E402
from hypothesis_compat import given, settings, st  # noqa: E402
from repro.core.heat import HeatTracker as JHeatTracker  # noqa: E402
from repro.core.hotset import build_hot_index as j_build_hot_index  # noqa: E402,E501
from repro.core.packets import ADD, SwitchConfig as JSwitchConfig  # noqa: E402,E501
from repro.db import faults as j_faults  # noqa: E402
from repro.db import wal as j_wal  # noqa: E402
from repro.db.dbms import Cluster as JCluster  # noqa: E402
from repro.db.txn import Txn as JTxn, key_of  # noqa: E402
from repro_torch.core.heat import HeatTracker as THeatTracker  # noqa: E402
from repro_torch.core.hotset import build_hot_index  # noqa: E402
from repro_torch.core.packets import SwitchConfig as TSwitchConfig  # noqa: E402,E501
from repro_torch.db import faults as t_faults  # noqa: E402
from repro_torch.db import wal as t_wal  # noqa: E402
from repro_torch.db.dbms import Cluster as TCluster  # noqa: E402
from test_torch_dbms import (_assert_same, _port_txns,  # noqa: E402
                             _same_results)

SW = dict(n_stages=8, regs_per_stage=128, max_instrs=8)
KEYS = [key_of(n, i) for n in range(2) for i in range(12)]
COLD = [key_of(n, 100 + i) for n in range(2) for i in range(6)]
TRACES = [[(k, ADD)] for k in KEYS]
J = SimpleNamespace(name="jax", Cluster=JCluster, faults=j_faults,
                    wal=j_wal, migrate=j_migrate_mod, Heat=JHeatTracker,
                    cfg=JSwitchConfig(**SW),
                    hi=j_build_hot_index(TRACES, 32, JSwitchConfig(**SW)),
                    kw={})
T = SimpleNamespace(name="torch", Cluster=TCluster, faults=t_faults,
                    wal=t_wal, migrate=t_migrate_mod, Heat=THeatTracker,
                    cfg=TSwitchConfig(**SW),
                    hi=build_hot_index(TRACES, 32, TSwitchConfig(**SW)),
                    kw=dict(device="cpu"))
PKGS = (J, T)


@pytest.fixture(autouse=True)
def _fresh_migration_tids(monkeypatch):
    """Both packages number migrations from one module-level counter; a
    fresh one on each side keeps the WAL records comparable."""
    for m in (j_migrate_mod, t_migrate_mod):
        monkeypatch.setattr(m, "_MIG_TID", itertools.count(1 << 40))


def _txns(seed, n, n_ops=2, cold=False, home=None):
    """JAX Txns as tests/test_durability.py draws them (``cold`` adds the
    cold keys to the draw: their txns take the 2PC path); the port gets
    the same tids through ``_port_txns``."""
    pool = KEYS + COLD if cold else KEYS
    rng = np.random.default_rng(seed)
    return [JTxn("t", [(ADD, pool[rng.integers(len(pool))],
                        int(rng.integers(1, 9))) for _ in range(n_ops)],
                 home=int(rng.integers(2)) if home is None else home)
            for _ in range(n)]


def _side(pkg, txns):
    return copy.deepcopy(txns) if pkg.name == "jax" else _port_txns(txns)


def _cluster(pkg, plan=None, **kw):
    c = pkg.Cluster(2, pkg.cfg, pkg.hi,
                    fault_plan=pkg.faults.FaultPlan(**plan) if plan else None,
                    **kw, **pkg.kw)
    for k in KEYS:
        c.load(k, 5)
        # the reference's load() race (test_torch_dbms._clusters)
        c.switch.read_all()
    c.snapshot_offload()
    return c


def _twins(plan=None, **kw):
    return tuple(_cluster(pkg, plan, **kw) for pkg in PKGS)


def _regs(c):
    return np.asarray(c.switch.read_all()).copy()


def _stores(c):
    return [dict(n.store) for n in c.nodes]


def _same(jc, tc):
    _assert_same(jc, tc)
    assert _stores(jc) == _stores(tc)


def _both(jc, tc, fn):
    """``fn`` on each cluster: equal return values, or equal exception
    class names and messages."""
    out = []
    for c in (jc, tc):
        try:
            out.append(("ok", fn(c)))
        except Exception as e:          # the outcome under comparison
            out.append((type(e).__name__, str(e)))
    assert out[0] == out[1]
    return out[1]


# ===================================================================== #
#  SegmentedWAL and CheckpointStore                                     #
# ===================================================================== #

def _fill(wal, n):
    for i in range(n):
        wal.append("switch_send", i, dict(ops=[[ADD, KEYS[0], i]]))


def _flip(wal):
    _fill(wal, 6)
    wal[3].payload["ops"][0][2] += 1


def _reorder(wal):
    _fill(wal, 6)
    wal._records[2], wal._records[3] = wal._records[3], wal._records[2]


def _truncate(wal):
    _fill(wal, 9)
    del wal._records[5]


def _torn(wal):
    _fill(wal, 10)
    assert wal.tear_tail(5) == 2
    wal.append("switch_send", 99, dict(ops=[]))


WAL_CASES = {"intact": lambda w: _fill(w, 10), "flip": _flip,
             "reorder": _reorder, "truncate": _truncate, "torn": _torn}


@pytest.mark.parametrize("case", list(WAL_CASES))
def test_wal_hashes_and_verify_match_jax(case):
    """Flip, reorder, sealed truncation and a torn open tail give the same
    records, hashes and ``verify()`` outcome on both packages."""
    out = []
    for pkg in PKGS:
        wal = pkg.wal.SegmentedWAL(segment_size=4)
        WAL_CASES[case](wal)
        recs = [(r.lsn, r.kind, r.tid, r.payload, r.prev, r.hash)
                for r in wal]
        try:
            verdict = wal.verify()
        except pkg.wal.WALIntegrityError as e:
            verdict = ("WALIntegrityError", str(e))
        out.append((recs, verdict, len(wal._segments)))
    assert out[0] == out[1]
    assert isinstance(out[1][1], tuple) == \
        (case in ("flip", "reorder", "truncate"))


def test_checkpoint_store_matches_jax():
    out = []
    for pkg in PKGS:
        cs = pkg.wal.CheckpointStore()
        rng = np.random.default_rng(0)
        regs = rng.integers(0, 50, (4, 8)).astype(np.int32)
        entries = [cs.checkpoint(regs)]
        for _ in range(5):
            regs = regs.copy()
            regs[rng.integers(4), rng.integers(8)] += int(rng.integers(2))
            entries.append(cs.checkpoint(regs))
        np.testing.assert_array_equal(cs.reconstruct(), regs)
        out.append((entries, cs.diffs, cs.reconstruct().tolist()))
    assert out[0] == out[1]


def _corrupt(d):
    """Change the first record's tid on disk (its hash stays)."""
    seg = os.path.join(d, "seg-00000.jsonl")
    with open(seg) as f:
        lines = f.readlines()
    rec = json.loads(lines[0])
    rec["tid"] += 1
    lines[0] = json.dumps(rec) + "\n"
    with open(seg, "w") as f:
        f.writelines(lines)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_wal_cli_across_packages(writer, tmp_path, capsys):
    """A WAL saved by either package loads under both with equal records
    and passes both ``verify`` CLIs; one flipped byte fails both."""
    wpkg = J if writer == "jax" else T
    wal = wpkg.wal.SegmentedWAL(segment_size=4)
    _fill(wal, 11)
    d = str(tmp_path / "wal")
    wal.save(d)
    loaded = [pkg.wal.SegmentedWAL.load(d) for pkg in PKGS]
    assert [[(r.kind, r.tid, r.payload, r.hash) for r in w]
            for w in loaded] == [[(r.kind, r.tid, r.payload, r.hash)
                                  for r in wal]] * 2
    assert [pkg.wal.main(["verify", d]) for pkg in PKGS] == [0, 0]
    _corrupt(d)
    assert [pkg.wal.main(["verify", d]) for pkg in PKGS] == [1, 1]
    capsys.readouterr()


def test_wal_verify_module_entry(tmp_path):
    """``python -m repro_torch.db.wal verify <dir>`` as an operator runs
    it: exit 0 on a cluster's saved WAL, 1 once a byte is flipped."""
    c = _cluster(T)
    c.run_batch(_port_txns(_txns(43, 30)))
    d = str(tmp_path / "node0")
    c.nodes[0].wal.save(d)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    cmd = [sys.executable, "-m", "repro_torch.db.wal", "verify", d]
    ok = subprocess.run(cmd, env=env, capture_output=True, text=True,
                        timeout=120)
    assert ok.returncode == 0 and ok.stdout.startswith("OK:"), ok.stderr
    _corrupt(d)
    bad = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=120)
    assert bad.returncode == 1 and bad.stdout.startswith("FAIL:")


@pytest.mark.parametrize("async_hot", [False, True])
def test_segmented_wal_equals_list_mode_and_jax(async_hot):
    """``wal_mode="list"`` and the segmented default give the same
    results, registers, stats and record stream on both packages, and
    the same recovery."""
    txns = _txns(7, 60)
    outs = []
    for pkg in PKGS:
        for wal_mode in ("segmented", "list"):
            c = _cluster(pkg, async_hot=async_hot, wal_mode=wal_mode)
            res = list(c.run_batch(_side(pkg, txns)))
            c.drain()
            outs.append((res, _regs(c).tolist(), dict(c.stats),
                         [[(e.kind, e.tid, e.payload) for e in n.wal]
                          for n in c.nodes],
                         c.crash_switch_and_recover(), _regs(c).tolist()))
    assert outs[0] == outs[1] == outs[2] == outs[3]


# ===================================================================== #
#  The crash-point matrix                                               #
# ===================================================================== #

def _run_until_crash(pkg, c, txns, chunk=10):
    with pytest.raises(pkg.faults.SimulatedCrash) as exc:
        for lo in range(0, len(txns), chunk):
            c.run_batch(_side(pkg, txns[lo:lo + chunk]))
        pytest.fail("fault plan never fired")
    return exc.value.point, exc.value.ctx


def _survivors(txns, c):
    """The txns whose sends survived in ``c``'s WALs, in admission order
    (a stream may repeat a txn: each logged send stands for one run)."""
    sent = collections.Counter(e.tid for n in c.nodes for e in n.wal
                               if e.kind == "switch_send")
    out = []
    for t in txns:
        if sent[t.tid]:
            sent[t.tid] -= 1
            out.append(t)
    return out


def _reference_regs(txns):
    """Registers of an uncrashed port cluster that ran only ``txns``
    (tests/test_durability.py:110-118)."""
    ref = _cluster(T)
    ref.run_batch(_port_txns(txns))
    ref.drain()
    return _regs(ref)


def _skewed(seed):
    """tests/test_durability.py:227-228's stream, each repeat a txn of its
    own (recovery keys sends by tid)."""
    txns = _txns(seed, 80)
    skew = [t for t in txns if all(k in KEYS[:6] for _, k, _ in t.ops)]
    return [JTxn(t.kind, list(t.ops), t.home) for t in (skew * 8)[:40]]


# point -> (FaultPlan kwargs, cluster kwargs, txns, async cases)
CRASHES = {
    "mid_group_dispatch": (dict(after=3), {}, lambda: _txns(17, 50)),
    "undrained_async": (dict(after=4), dict(max_inflight=4),
                        lambda: _txns(19, 60)),
    "torn_tail": (dict(after=3, tear_records=2, tear_node=0), {},
                  lambda: _txns(23, 30, n_ops=1, home=0)),
    "mid_migration": ({}, {}, lambda: _skewed(29)),
    "mid_2pc_prepare": (dict(after=5), {}, lambda: _txns(31, 50, cold=True)),
    "mid_failover": ({}, dict(checkpoint_interval=16, standby=True),
                     lambda: _txns(11, 48)),
}
MATRIX = [(p, a) for p in CRASHES for a in (False, True)
          if (p, a) != ("undrained_async", False)]


@pytest.mark.parametrize("point,async_hot", MATRIX)
def test_crash_point_recovers_like_jax(point, async_hot):
    """Each crash point on twin clusters: the same point fires with the
    same context and leaves the same WALs; recovery (``recover_switch``,
    or ``fail_over`` falling back to it on the double fault) replays the
    same known/unknown sends to registers equal to an uncrashed cluster
    of the surviving txns; ``verify_wals`` passes; and the recovered
    clusters commit the next batch alike."""
    plan, kw, make = CRASHES[point]
    txns = make()
    jc, tc = _twins(dict(point=point, **plan), async_hot=async_hot, **kw)
    if point == "mid_migration":
        for pkg, c in zip(PKGS, (jc, tc)):
            pkg.migrate.EpochController(c, pkg.Heat(), interval=20, top_k=4)
    if point == "mid_failover":
        for pkg, c in zip(PKGS, (jc, tc)):
            for lo in range(0, len(txns), 24):
                c.run_batch(_side(pkg, txns[lo:lo + 24]))
            c.drain()
        before = _regs(tc)
        crashed = []
        for pkg, c in zip(PKGS, (jc, tc)):
            with pytest.raises(pkg.faults.SimulatedCrash) as exc:
                c.fail_over()
            crashed.append((exc.value.point, exc.value.ctx))
            assert c._standby is None and c._switch_down
    else:
        crashed = [_run_until_crash(pkg, c, txns)
                   for pkg, c in zip(PKGS, (jc, tc))]
    assert crashed[0] == crashed[1] and crashed[1][0] == point
    assert not tc._inflight and tc._switch_down
    assert [[(r.kind, r.tid, r.payload, r.hash) for r in n.wal]
            for n in jc.nodes] == \
        [[(r.kind, r.tid, r.payload, r.hash) for r in n.wal]
         for n in tc.nodes]
    if point == "mid_migration":
        evicted = sorted(tc._mid_migration_evicted)
        assert evicted and evicted == sorted(jc._mid_migration_evicted)
        live = next(k for k in KEYS if k not in evicted)
        _both(jc, tc, lambda c: c.read(evicted[0]))
        assert _both(jc, tc, lambda c: c.read(live))[0] == \
            "SwitchUnavailable"
    replayed = [c.recover_switch() for c in (jc, tc)]
    assert replayed[0] == replayed[1]
    if point in ("mid_group_dispatch", "undrained_async"):
        assert replayed[1][1] > 0     # the lost group replays as unknown
    _same(jc, tc)
    if point == "mid_failover":
        np.testing.assert_array_equal(_regs(tc), before)
    else:
        np.testing.assert_array_equal(
            _regs(tc), _reference_regs(_survivors(txns, tc)))
    assert jc.verify_wals() == tc.verify_wals()
    nxt = _txns(99, 8)
    _same_results(jc.run_batch(_side(J, nxt)), tc.run_batch(_side(T, nxt)))
    for c in (jc, tc):
        c.drain()
    _same(jc, tc)


# ===================================================================== #
#  Checkpoints bound recovery; warm-standby failover                    #
# ===================================================================== #

def test_checkpoint_interval_bounds_recovery_like_jax():
    txns = _txns(11, 80)
    replayed = {}
    for interval in (0, 16):
        jc, tc = _twins(checkpoint_interval=interval)
        for lo in range(0, len(txns), 20):
            for pkg, c in zip(PKGS, (jc, tc)):
                c.run_batch(_side(pkg, txns[lo:lo + 20]))
        before = _regs(tc)
        out = [c.crash_switch_and_recover() for c in (jc, tc)]
        assert out[0] == out[1]
        np.testing.assert_array_equal(before, _regs(tc))
        assert jc.ckpts.diffs == tc.ckpts.diffs
        _same(jc, tc)
        replayed[interval] = sum(out[1])
    assert replayed[16] <= 20 and replayed[16] < replayed[0]


def test_migration_checkpoints_match_jax():
    jc, tc = _twins()
    for pkg, c in zip(PKGS, (jc, tc)):
        pkg.migrate.EpochController(c, pkg.Heat(), interval=30, top_k=16)
    for lo in range(0, 90, 30):
        txns = _txns(13 + lo, 30)
        for pkg, c in zip(PKGS, (jc, tc)):
            c.run_batch(_side(pkg, txns))
    assert tc.stats["migrations"] >= 1
    assert jc.ckpts.diffs == tc.ckpts.diffs
    before = _regs(tc)
    assert jc.crash_switch_and_recover() == tc.crash_switch_and_recover()
    np.testing.assert_array_equal(before, _regs(tc))
    _same(jc, tc)


def test_warm_standby_takeover_like_jax():
    """Takeover replays exactly the sends since the last checkpoint, on
    both packages, and new txns draw GIDs above the pre-crash stream."""
    jc, tc = _twins(checkpoint_interval=16, standby=True)
    for lo in range(0, 72, 24):
        txns = _txns(31 + lo, 24)
        for pkg, c in zip(PKGS, (jc, tc)):
            c.run_batch(_side(pkg, txns))
    before, since = _regs(tc), tc._sends_since_ckpt
    gid = tc.switch.next_gid
    assert jc._sends_since_ckpt == since
    out = [c.fail_over() for c in (jc, tc)]
    assert out[0] == out[1] and sum(out[1]) == since
    np.testing.assert_array_equal(before, _regs(tc))
    assert tc.stats["failovers"] == 1 and tc.switch.next_gid >= gid
    nxt = _txns(37, 10)
    _same_results(jc.run_batch(_side(J, nxt)), tc.run_batch(_side(T, nxt)))
    _same(jc, tc)


def test_failover_replays_less_than_cold_recovery_like_jax():
    txns = _txns(41, 60)
    counts = []
    for pkg in PKGS:
        cold = _cluster(pkg)
        cold.run_batch(_side(pkg, txns))
        warm = _cluster(pkg, checkpoint_interval=16, standby=True)
        for lo in range(0, len(txns), 20):
            warm.run_batch(_side(pkg, txns[lo:lo + 20]))
        counts.append((cold.crash_switch_and_recover(), warm.fail_over()))
    assert counts[0] == counts[1]
    assert sum(counts[1][1]) < sum(counts[1][0])


def test_failover_without_standby_raises_like_jax():
    jc, tc = _twins()
    assert _both(jc, tc, lambda c: c.fail_over())[0] == "RuntimeError"


def test_load_then_failover_like_jax():
    """A load after the last checkpoint is a logged write: takeover
    recovers the loaded value on both packages."""
    k = key_of(0, 0)
    txn = JTxn("t", [(ADD, k, 1)], 0)
    out = []
    for pkg in PKGS:
        sw = type(pkg.cfg)(n_stages=4, regs_per_stage=16, max_instrs=4)
        hi = (j_build_hot_index if pkg is J else build_hot_index)(
            [[(k, ADD)]], 1, sw)
        c = pkg.Cluster(1, sw, hi, use_switch=True, standby=True, **pkg.kw)
        c.load(k, 100)
        c.switch.read_all()
        c.snapshot_offload()
        c.run(_side(pkg, [txn])[0])
        c.load(k, 500)
        c.switch.read_all()
        out.append((c.fail_over(), c.read(k), c.nodes[0].store[k],
                    [(r.kind, r.tid, r.payload, r.hash)
                     for r in c.nodes[0].wal]))
    assert out[0] == out[1] and out[1][1:3] == (500, 500)


# ===================================================================== #
#  Deterministic replay                                                 #
# ===================================================================== #

@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_same_log_replays_identically_and_like_jax(seed):
    """Two replays of one port cluster's log agree with each other and
    with the JAX package's replay of its twin's log; crash + recover is
    a fixed point."""
    jc, tc = _twins(checkpoint_interval=8)
    txns = _txns(seed, 25)
    for pkg, c in zip(PKGS, (jc, tc)):
        c.run_batch(_side(pkg, txns))
        c.drain()
    e1, e2, ej = tc._fresh_engine(), tc._fresh_engine(), jc._fresh_engine()
    assert tc._replay_into(e1) == tc._replay_into(e2) == jc._replay_into(ej)
    np.testing.assert_array_equal(e1.read_all(), e2.read_all())
    np.testing.assert_array_equal(e1.read_all(), np.asarray(ej.read_all()))
    assert e1.next_gid == e2.next_gid == ej.next_gid
    before = _regs(tc)
    for _ in range(2):
        assert jc.crash_switch_and_recover() == tc.crash_switch_and_recover()
        np.testing.assert_array_equal(before, _regs(tc))
    _same(jc, tc)


def test_wal_disk_roundtrip_replays_across_packages(tmp_path):
    """Each node's port WAL, saved and reloaded by the JAX package and
    spliced back, still recovers the port cluster's registers; the JAX
    twin does the same the other way round."""
    jc, tc = _twins()
    txns = _txns(43, 30)
    for pkg, c in zip(PKGS, (jc, tc)):
        c.run_batch(_side(pkg, txns))
        c.drain()
    before = _regs(tc)
    for c, loader in ((tc, J), (jc, T)):
        for n in c.nodes:
            d = str(tmp_path / f"{loader.name}{n.id}")
            n.wal.save(d)
            n.wal = loader.wal.SegmentedWAL.load(d)
            n.wal.verify()
    assert jc.crash_switch_and_recover() == tc.crash_switch_and_recover()
    np.testing.assert_array_equal(before, _regs(tc))
    np.testing.assert_array_equal(before, _regs(jc))
