"""The port's TPC-C, storm and drift generators against the JAX package's:
the same seed gives the same (kind, ops, home) stream, hot-key lists and
traces.  Txns are compared by content, not by tid: each package keeps
its own tid counter."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.workloads import drift as j_drift  # noqa: E402
from repro.workloads import storms as j_storms  # noqa: E402
from repro.workloads import tpcc as j_tpcc  # noqa: E402
from repro_torch.workloads import drift as t_drift  # noqa: E402
from repro_torch.workloads import storms as t_storms  # noqa: E402
from repro_torch.workloads import tpcc as t_tpcc  # noqa: E402


def _sig(txns):
    return [(t.kind, tuple(t.ops), t.home) for t in txns]


def _rng(seed=7):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("kw", [
    dict(n_nodes=2, n_warehouses=2),                      # conftest.py:37
    dict(n_nodes=4, n_warehouses=8),                      # test_dbms.py:46
    dict(n_nodes=4, n_warehouses=8, dist_frac=0.0),
    dict(n_nodes=8, n_warehouses=32, dist_frac=0.2),      # Fig 14, widest
], ids=["2w", "8w", "8w_local", "32w"])
def test_tpcc_streams_match_jax(kw):
    jp, tp = j_tpcc.TPCCParams(**kw), t_tpcc.TPCCParams(**kw)
    a = j_tpcc.generate(_rng(), 300, jp)
    b = t_tpcc.generate(_rng(), 300, tp)
    assert _sig(a) == _sig(b)
    assert j_tpcc.traces(a) == t_tpcc.traces(b)
    assert j_tpcc.hot_keys(jp) == t_tpcc.hot_keys(tp)
    assert {t.kind for t in b} == {"neworder", "payment"}
    assert (j_tpcc.N_DISTRICTS, j_tpcc.HOT_ITEMS) == \
        (t_tpcc.N_DISTRICTS, t_tpcc.HOT_ITEMS)


STORM_KW = [
    # tests/test_contention.py:386-388 (DIFF_P)
    dict(n_nodes=2, keys_per_node=60, contended_per_node=2, hot_per_node=4,
         p_hot_txn=0.4),
    {},
]


@pytest.mark.parametrize("kw", STORM_KW, ids=["diff_p", "defaults"])
@pytest.mark.parametrize("gen", ["ycsb_a_storm", "tpcc_payment_storm"])
def test_storm_streams_match_jax(kw, gen):
    jp, tp = j_storms.StormParams(**kw), t_storms.StormParams(**kw)
    a = getattr(j_storms, gen)(_rng(9), 200, jp)
    b = getattr(t_storms, gen)(_rng(9), 200, tp)
    assert _sig(a) == _sig(b)
    assert j_storms.traces(a) == t_storms.traces(b)
    assert j_storms.contended_keys(jp) == t_storms.contended_keys(tp)
    assert j_storms.hot_keys(jp) == t_storms.hot_keys(tp)


# the shapes of tests/test_adaptive.py:27-41
DRIFT = [
    ("YCSBHotspotShift", dict(n_nodes=4, keys_per_node=2000, hot_per_node=16,
                              n_blocks=4, p_hot_txn=0.9)),
    ("RotatingZipf", dict(n_nodes=4, keys_per_node=1000, hot_per_node=16)),
    ("TPCCWarehouseRotation", dict(n_nodes=4, n_warehouses=8, active=2)),
    ("YCSBHotspotShift", {}),
]


@pytest.mark.parametrize("name,kw", DRIFT,
                         ids=["ycsb_shift", "rotating_zipf", "tpcc_rotation",
                              "ycsb_shift_defaults"])
def test_drift_streams_match_jax(name, kw):
    jg, tg = getattr(j_drift, name)(**kw), getattr(t_drift, name)(**kw)
    for phase in (0, 1, 3):
        a = jg.sample_phase(_rng(7 + phase), phase, 120)
        b = tg.sample_phase(_rng(7 + phase), phase, 120)
        assert _sig(a) == _sig(b)
        assert j_drift.traces(a) == t_drift.traces(b)
    ts = [0.0, 0.4 * jg.period, jg.period, 2.5 * jg.period, 7 * jg.period]
    assert [jg.phase_of(t) for t in ts] == [tg.phase_of(t) for t in ts]
    assert [jg.hot_keys_at(t) for t in ts] == [tg.hot_keys_at(t) for t in ts]
    ra, rb = _rng(3), _rng(3)
    for i, t in enumerate(ts * 8):
        home = None if i % 2 else i % 4
        a, b = jg.sample(ra, t, home=home), tg.sample(rb, t, home=home)
        assert _sig([a]) == _sig([b])
