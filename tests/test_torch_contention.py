"""The port's contention-resilience plane against the JAX package's:
``RetryPolicy`` schedules, ``ConflictDetector`` decisions on seeded
intent streams, the interleaved ``ContentionArena`` on both storms under
both protocols with early abort off and on (at ``StormParams(n_nodes=4,
p_hot_txn=0.4)`` on ``SwitchConfig(16, 512, 16)``, 120 txns, 16 workers:
hot and warm fibers reach the switch), the ``mid_2pc_prepare`` lock-leak
property, and brown-out enter / exit / cap / validation.  Every
``ArenaResult`` field, the registers, stores, stats and WAL records must
agree exactly."""
import copy
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

from hypothesis_compat import given, settings, st  # noqa: E402
from repro.core.hotset import build_hot_index as j_build_hot_index  # noqa: E402,E501
from repro.core.packets import ADD, SwitchConfig as JSwitchConfig  # noqa: E402,E501
from repro.db import conflict as j_conflict  # noqa: E402
from repro.db.txn import Txn as JTxn, key_of, node_of  # noqa: E402
from repro.workloads import storms as j_storms  # noqa: E402
from repro_torch.core.hotset import build_hot_index  # noqa: E402
from repro_torch.core.packets import SwitchConfig as TSwitchConfig  # noqa: E402,E501
from repro_torch.db import conflict as t_conflict  # noqa: E402
from repro_torch.workloads import storms as t_storms  # noqa: E402
from test_torch_dbms import _assert_same  # noqa: E402
from test_torch_durability import (J as DJ, T as DT, _both,  # noqa: E402
                                   _side, _stores)

PROTOCOLS = ("NO_WAIT", "WAIT_DIE")
J = SimpleNamespace(**vars(DJ), conflict=j_conflict, storms=j_storms,
                    build=j_build_hot_index, SW=JSwitchConfig)
T = SimpleNamespace(**vars(DT), conflict=t_conflict, storms=t_storms,
                    build=build_hot_index, SW=TSwitchConfig)
# benchmarks/bench_contention.py:62-71 with tests/test_contention.py:386-
# 388's hot share
ARENA_P = dict(n_nodes=4, p_hot_txn=0.4)
ARENA_SW = dict(n_stages=16, regs_per_stage=512, max_instrs=16)


def _gave_up(r, pkg):
    return ["GAVE_UP" if x is pkg.conflict.GAVE_UP else x for x in r]


# ===================================================================== #
#  RetryPolicy and ConflictDetector                                     #
# ===================================================================== #

@pytest.mark.parametrize("proto", PROTOCOLS)
@pytest.mark.parametrize("kw", [dict(max_retries=8, seed=3),
                                dict(max_retries=50, cap=64.0, jitter=0.0,
                                     deadline=10.0),
                                dict(max_retries=24, seed=1, base=2.0)])
def test_retry_policy_matches_jax(proto, kw):
    out = []
    for pkg in (J, T):
        p = pkg.conflict.RetryPolicy.for_protocol(proto, **kw)
        out.append(([list(p.schedule(tid)) for tid in (1, 42, 43, 1 << 40)],
                    [p.backoff(7, a) for a in range(1, 40)],
                    (p.multiplier, p.jitter)))
    assert out[0] == out[1]


def _intent_stream(seed, n=300):
    """Seeded admit / release events over a small key space: overlaps,
    read-read sharing, wounds and vetoes all occur."""
    rng = np.random.default_rng(seed)
    ev = []
    for i in range(n):
        if i and rng.random() < 0.35:
            ev.append(("release", int(rng.integers(i))))
            continue
        keys = rng.integers(0, 12, int(rng.integers(1, 4)))
        rd = {int(k) for k in keys if rng.random() < 0.5}
        ev.append(("admit", i, int(rng.integers(1, 1000)), rd,
                   {int(k) for k in keys} - rd, rng.random() < 0.8))
    return ev


@pytest.mark.parametrize("proto", PROTOCOLS)
@pytest.mark.parametrize("seed", [0, 1])
def test_conflict_detector_matches_jax(proto, seed):
    out = []
    for pkg in (J, T):
        d = pkg.conflict.ConflictDetector(proto)
        trace = []
        for e in _intent_stream(seed):
            if e[0] == "release":
                d.release(e[1])
                continue
            _, tid, ts, reads, writes, woundable = e
            ok, wounded = d.admit(tid, ts, reads, writes,
                                  woundable=lambda it, w=woundable: w)
            trace.append((ok, [it.tid for it in wounded],
                          sorted(d.inflight)))
        out.append((trace, dict(d.stats)))
    assert out[0] == out[1]
    stats = out[1][1]
    assert stats["early_aborts"] > 0 and stats["conflicts"] > 0
    if proto == "WAIT_DIE":
        assert stats["wounds"] > 0


def test_gave_up_sentinel_matches_jax():
    for pkg in (J, T):
        g = pkg.conflict.GAVE_UP
        assert not g and g is not None and repr(g) == "GAVE_UP"
        assert copy.deepcopy(g) is g and pkg.conflict._GaveUp() is g


# ===================================================================== #
#  ContentionArena                                                      #
# ===================================================================== #

def _storm_txns(storm, n=120, **kw):
    p = j_storms.StormParams(**{**ARENA_P, **kw})
    return getattr(j_storms, storm)(np.random.default_rng(0), n, p), p


def _arena_cluster(pkg, proto, p, **kw):
    sw = pkg.SW(**ARENA_SW)
    hot = pkg.storms.hot_keys(p)
    hi = pkg.build([[(k, ADD)] for k in hot], 32, sw)
    c = pkg.Cluster(p.n_nodes, sw, hi, use_switch=True, protocol=proto,
                    switch_mode="pallas", **kw, **pkg.kw)
    for k in hot:
        c.load(k, 10)
        c.switch.read_all()
    c.snapshot_offload()
    return c


def _arena_fields(r, pkg):
    return (_gave_up(r.results, pkg), r.latencies, r.retries, r.committed,
            r.gave_up, r.wasted_ops, r.early_aborts, r.wounds, r.aborts,
            r.conflicts, r.ticks, r.percentile(0.99))


def _arena_twins(txns, p, proto, ea, workers=16, max_retries=24):
    out = []
    for pkg in (J, T):
        c = _arena_cluster(pkg, proto, p)
        pol = pkg.conflict.RetryPolicy.for_protocol(
            proto, max_retries=max_retries, seed=1)
        r = pkg.conflict.ContentionArena(c, policy=pol, early_abort=ea).run(
            _side(pkg, txns), workers=workers)
        out.append((c, r))
    (jc, jr), (tc, tr) = out
    assert _arena_fields(jr, J) == _arena_fields(tr, T)
    _assert_same(jc, tc)
    assert _stores(jc) == _stores(tc)
    return tc, tr


ARENA_CASES = [
    ("ycsb_a_storm", "WAIT_DIE"),
    ("tpcc_payment_storm", "NO_WAIT"),
    pytest.param("ycsb_a_storm", "NO_WAIT", marks=pytest.mark.slow),
    pytest.param("tpcc_payment_storm", "WAIT_DIE", marks=pytest.mark.slow),
]


@pytest.mark.parametrize("storm,proto", ARENA_CASES)
def test_arena_matches_jax_early_abort_off_and_on(storm, proto):
    """Each arena run equals the JAX package's field for field, and early
    abort off and on reach the same committed state."""
    txns, p = _storm_txns(storm)
    # the retry budget of tests/test_contention.py:231-232, under which
    # no txn gives up (NO_WAIT gives some up at the benchmark's 24)
    off_c, off_r = _arena_twins(txns, p, proto, ea=False, max_retries=64)
    on_c, on_r = _arena_twins(txns, p, proto, ea=True, max_retries=64)
    assert off_r.committed == on_r.committed and not off_r.gave_up
    assert _stores(off_c) == _stores(on_c)
    np.testing.assert_array_equal(off_c.switch.read_all(),
                                  on_c.switch.read_all())
    assert on_r.early_aborts > 0
    if storm == "ycsb_a_storm":
        assert on_c.stats["warm"] > 0     # warm fibers reached the switch


def test_arena_gave_up_matches_jax():
    """A brutal budget, and the benchmark's 24 retries under NO_WAIT: the
    same txns give up on both packages, each holding its own GAVE_UP."""
    _, r = _arena_twins(*_storm_txns("ycsb_a_storm"), "NO_WAIT", ea=False,
                        workers=None, max_retries=2)
    _, r24 = _arena_twins(*_storm_txns("ycsb_a_storm"), "NO_WAIT", ea=True)
    assert r.gave_up and r24.gave_up


def test_arena_storm_recovers_like_jax():
    """After an early-abort storm every node's WAL recovers the committed
    stores on both packages (early-aborted attempts never replay)."""
    txns, p = _storm_txns("ycsb_a_storm", n=80)
    out = []
    for pkg in (J, T):
        c = _arena_cluster(pkg, "WAIT_DIE", p)
        r = pkg.conflict.ContentionArena(
            c, policy=pkg.conflict.RetryPolicy.for_protocol(
                "WAIT_DIE", max_retries=48, seed=1),
            early_abort=True).run(_side(pkg, txns), workers=8)
        before = _stores(c)
        for nid in range(len(c.nodes)):
            c.crash_node_and_recover(nid)
        for nid, n in enumerate(c.nodes):
            assert all(before[nid][k] == v for k, v in n.store.items())
        c.crash_switch_and_recover()
        out.append((r.wounds, _stores(c), c.switch.read_all().tolist()))
    assert out[0] == out[1] and out[1][0] > 0


@settings(max_examples=12, deadline=None)
@given(st.integers(0, 100), st.integers(1, 40))
def test_no_lock_leak_at_mid_2pc_prepare_like_jax(seed, after):
    """tests/test_contention.py:274's property on the port, beside the
    JAX package: whatever the arena meets (early aborts, wounds mid-2PC-
    prepare, exhausted retries, the ``mid_2pc_prepare`` crash), no txn
    leaves a lock behind, and both packages crash (or finish) alike."""
    p = j_storms.StormParams(n_nodes=2, keys_per_node=200,
                             contended_per_node=2, hot_per_node=4)
    txns = j_storms.ycsb_a_storm(np.random.default_rng(seed), 30, p)
    sw = dict(n_stages=8, regs_per_stage=128, max_instrs=8)
    out = []
    for pkg in (J, T):
        c = pkg.Cluster(2, pkg.SW(**sw), hot_index=None, use_switch=False,
                        protocol="WAIT_DIE",
                        fault_plan=pkg.faults.FaultPlan("mid_2pc_prepare",
                                                        after=after),
                        **pkg.kw)
        arena = pkg.conflict.ContentionArena(
            c, policy=pkg.conflict.RetryPolicy.for_protocol(
                "WAIT_DIE", max_retries=3, seed=seed), early_abort=True)
        try:
            arena.run(_side(pkg, txns), workers=6)
            crash = None
        except pkg.faults.SimulatedCrash as e:
            crash = (e.point, e.ctx)
        tids = {t.tid for t in txns}
        for n in c.nodes:
            for key, (_, owners) in n.locks.items():
                assert not set(owners) & tids, f"lock {key} leaked"
        assert not set(arena.detector.inflight) & tids
        out.append((crash, _stores(c), dict(c.stats),
                    [[(r.kind, r.tid, r.payload) for r in n.wal]
                     for n in c.nodes]))
    assert out[0] == out[1]


# ===================================================================== #
#  Brown-out                                                            #
# ===================================================================== #

BSW = dict(n_stages=4, regs_per_stage=16, max_instrs=4)
BKEYS = [key_of(n, i) for n in range(2) for i in range(4)]


def _hot_twins(**kw):
    out = []
    for pkg in (J, T):
        sw = pkg.SW(**BSW)
        hi = pkg.build([[(k, ADD)] for k in BKEYS], 16, sw)
        c = pkg.Cluster(2, sw, hi, use_switch=True, **kw, **pkg.kw)
        for k in BKEYS:
            c.load(k, 10)
            c.switch.read_all()
        c.snapshot_offload()
        out.append(c)
    return tuple(out)


def _one(k, v=1):
    return JTxn("t", [(ADD, k, v)], node_of(k))


def test_brownout_enter_exit_matches_jax():
    """Enter, demoted txns, exit: equal registers, stores, stats and WALs
    on both packages, equal to a cluster that never browned out, and the
    logged eviction and reload survive switch recovery."""
    rng = np.random.default_rng(3)
    txns = [JTxn("t", [(ADD, BKEYS[int(rng.integers(len(BKEYS)))],
                        int(rng.integers(1, 9)))], 0) for _ in range(30)]
    jc, tc = _hot_twins()
    jref, tref = _hot_twins()
    for pkg, c, ref in ((J, jc, jref), (T, tc, tref)):
        for t in txns[:15]:
            c.run(_side(pkg, [t])[0])
        c.enter_brownout()
        c.enter_brownout()                  # idempotent while active
        for t in txns[15:]:
            c.run(_side(pkg, [t])[0])
        c.exit_brownout()
        for t in txns:
            ref.run(_side(pkg, [t])[0])
    assert tc.stats["brownouts"] == 1
    assert tc.stats["demoted_brownout"] == 15
    _assert_same(jc, tc)
    assert _stores(jc) == _stores(tc)
    np.testing.assert_array_equal(tc.switch.read_all(),
                                  tref.switch.read_all())
    assert [tc.read(k) for k in BKEYS] == [tref.read(k) for k in BKEYS]
    assert jc.crash_switch_and_recover() == tc.crash_switch_and_recover()
    np.testing.assert_array_equal(tc.switch.read_all(),
                                  tref.switch.read_all())
    _assert_same(jc, tc)


def test_brownout_cap_sheds_like_jax():
    jc, tc = _hot_twins()
    for pkg, c in ((J, jc), (T, tc)):
        c.enter_brownout(pkg.faults.Brownout(demote_cap=2))
    txns = [_one(k) for k in BKEYS]
    for t in txns:
        _both(jc, tc, lambda c, t=t: c.run(_side(J if c is jc else T,
                                                 [t])[0]))
    assert tc.stats["demoted_brownout"] == 2
    for c in (jc, tc):
        c.exit_brownout()
    t = _one(BKEYS[0])
    _both(jc, tc, lambda c: c.run(_side(J if c is jc else T, [t])[0]))
    assert tc.stats["hot"] > 0
    _assert_same(jc, tc)
    assert _stores(jc) == _stores(tc)


@pytest.mark.parametrize("kw", [dict(demote_cap=-1), dict(slow_factor=0.5),
                                dict(demote_cap=0), dict(slow_factor=1.0)])
def test_brownout_validation_matches_jax(kw):
    out = []
    for pkg in (J, T):
        try:
            out.append(repr(pkg.faults.Brownout(**kw)).split("(", 1)[1])
        except ValueError as e:
            out.append(("ValueError", str(e)))
    assert out[0] == out[1]
    jc, tc = _hot_twins()
    _both(jc, tc, lambda c: c.exit_brownout())     # not in brown-out
    assert not tc._brownout
