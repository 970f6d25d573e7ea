"""The port's open-loop serving front end (``repro_torch.obs.load``)
against the JAX package's: arrival processes are bitwise equal, and
``serve_open_loop`` under a deterministic clock gives the same result
row, registers and WAL on a JAX cluster and on a port cluster."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.obs import load as j_load  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402
from repro_torch.obs import load as t_load  # noqa: E402
from test_torch_dbms import (_assert_same, _clusters, _indexes,  # noqa: E402
                             _port_txns, _ycsb)


def test_obs_exports_the_load_names():
    for name in ("poisson_arrivals", "bursty_arrivals", "serve_open_loop",
                 "find_knee"):
        assert name in t_obs.__all__
        assert getattr(t_obs, name) is getattr(t_load, name)


@pytest.mark.parametrize("rate,n,seed,t0", [
    (1e4, 5000, 5, 0.0), (3.5e3, 1, 0, 2.0), (1e6, 20_000, 9, 0.25),
    (1e3, 0, 1, 0.0)])
def test_poisson_arrivals_bitwise(rate, n, seed, t0):
    a = j_load.poisson_arrivals(rate, n, seed=seed, t0=t0)
    b = t_load.poisson_arrivals(rate, n, seed=seed, t0=t0)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kw", [
    dict(rate=1e4, n=3000, seed=9), dict(rate=1e4, n=3000, seed=9, burst=4,
                                         cv=2.0),
    dict(rate=5e5, n=777, seed=2, t0=1.0, burst=64, cv=8.0),
    dict(rate=1e3, n=0)])
def test_bursty_arrivals_bitwise(kw):
    a, b = j_load.bursty_arrivals(**kw), t_load.bursty_arrivals(**kw)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_find_knee_matches_jax():
    rows = [dict(offered_rate=r, achieved_rate=a) for r, a in
            [(100, 100), (200, 199), (400, 390), (800, 500), (1600, 510),
             (50, 0)]]
    for frac in (0.5, 0.6, 0.9, 0.99):
        assert j_load.find_knee(rows, frac) == t_load.find_knee(rows, frac)
    assert j_load.find_knee([]) == t_load.find_knee([]) == 0.0


class _StepClock:
    """Each call advances a fixed step: every batch's service time is
    exactly one step, whatever the host does."""

    def __init__(self, step):
        self.step, self.t = step, 0.0

    def __call__(self):
        self.t += self.step
        return self.t


@pytest.mark.parametrize("kw", [
    dict(rate=2e4, step=1e-3, batch=32),
    dict(rate=2e5, step=2e-3, batch=16, max_backlog=48, lanes=2),
    dict(rate=5e3, step=1e-4, batch=32, gather_window=2e-3),
], ids=["below", "overload", "window"])
def test_serve_open_loop_matches_jax(kw):
    traces, top_k, txns, loads, n_nodes = _ycsb(n=320)
    jc, tc = _clusters(*_indexes(traces, top_k), loads, n_nodes, "pallas")
    rate, step = kw.pop("rate"), kw.pop("step")
    arr = j_load.poisson_arrivals(rate, len(txns), seed=3)
    res = [load.serve_open_loop(c, t, arr, clock=_StepClock(step), **kw)
           for load, c, t in ((j_load, jc, txns),
                              (t_load, tc, _port_txns(txns)))]
    assert dict(res[0]) == dict(res[1])
    assert type(res[1]).__name__ == "ServeResult"
    assert res[1]["served"] + res[1]["dropped"] == len(txns)
    if "max_backlog" in kw:
        assert res[1]["dropped"] > 0
    _assert_same(jc, tc)
    assert jc.stats["hot"] > 0 and jc.stats["cold"] > 0
