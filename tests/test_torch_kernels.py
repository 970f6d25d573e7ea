"""The port's switch_txn kernel ops against the JAX package's Pallas
kernels (interpret mode on the CPU) and serial oracles.

On the CPU the port's launchers run their plain PyTorch versions; the CUDA
kernels themselves are held against those plain versions on the card by
``chip_smoke.py``.  Every value on this path is int32 with exactly one
right answer, so every comparison is exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.switch_txn import ops as jops  # noqa: E402
from repro.kernels.switch_txn.ref import switch_exec_ref as jref  # noqa: E402
from repro_torch.kernels.switch_txn import ops as tops  # noqa: E402
from repro_torch.kernels.switch_txn import switch_txn as tk  # noqa: E402
from repro_torch.kernels.switch_txn.ref import switch_exec_ref as tref  # noqa: E402,E501


def _both(regs, op, st, rg, vl):
    """Run one stream through the JAX kernel, the JAX oracle, the port's
    op and the port's oracle; assert all four agree exactly."""
    t = lambda a: torch.tensor(a, dtype=torch.int32)
    j = lambda a: jnp.asarray(a, jnp.int32)
    r1, res1, ok1 = jref(j(regs), j(op), j(st), j(rg), j(vl))
    r2, res2, ok2 = jops.switch_exec(j(regs), j(op), j(st), j(rg), j(vl))
    tregs = t(regs)
    r3, res3, ok3 = tops.switch_exec(tregs, t(op), t(st), t(rg), t(vl))
    r4, res4, ok4 = tref(t(regs), t(op), t(st), t(rg), t(vl))
    assert r3.data_ptr() == tregs.data_ptr()          # updated in place
    assert res3.dtype == torch.int32 and ok3.dtype == torch.bool
    for r, res, ok in ((r2, res2, ok2), (r3, res3, ok3), (r4, res4, ok4)):
        np.testing.assert_array_equal(np.asarray(r1), np.asarray(r))
        np.testing.assert_array_equal(np.asarray(res1), np.asarray(res))
        np.testing.assert_array_equal(np.asarray(ok1), np.asarray(ok))
    return np.asarray(r1), np.asarray(res1), np.asarray(ok1)


@pytest.mark.parametrize("S,R,B,K", [
    (4, 8, 16, 3),
    (6, 32, 64, 5),
    (12, 64, 100, 8),
    (6, 32, 37, 5),
    (4, 16, 1, 7),
])
def test_switch_exec_matches_jax(S, R, B, K):
    rng = np.random.default_rng(S * 1000 + B)
    _both(rng.integers(-50, 100, (S, R)), rng.integers(0, 5, (B, K)),
          rng.integers(0, S, (B, K)), rng.integers(0, R, (B, K)),
          rng.integers(-30, 30, (B, K)))


def test_switch_exec_hot_skew():
    """Half the stream lands on three slots: long per-slot segments, the
    P4DB hot-tuple case."""
    rng = np.random.default_rng(11)
    S, R, B, K = 8, 64, 64, 8
    st = rng.integers(0, S, (B, K))
    rg = rng.integers(0, R, (B, K))
    hot = rng.random((B, K)) < 0.5
    pick = rng.integers(0, 3, (B, K))
    st = np.where(hot, np.array([0, 3, 7])[pick], st)
    rg = np.where(hot, np.array([5, 5, 63])[pick], rg)
    _, _, ok = _both(rng.integers(0, 200, (S, R)), rng.integers(0, 5, (B, K)),
                     st, rg, rng.integers(-60, 60, (B, K)))
    assert not ok.all()                       # some CADDs were refused


def test_switch_exec_int32_wraparound():
    """Registers near +-2**31 under ADD and CADD: sums wrap like int32, and
    CADD's >= 0 test is taken on the wrapped value."""
    rng = np.random.default_rng(5)
    S, R, B, K = 2, 4, 32, 4
    edge = np.array([2**31 - 1, 2**31 - 5, -2**31, -2**31 + 3, 0, -1])
    regs = edge[rng.integers(0, len(edge), (S, R))]
    op = rng.choice([1, 3, 4], (B, K))
    vl = rng.choice([1, 7, -1, -9, 2**31 - 1, -2**31], (B, K))
    r, res, _ = _both(regs, op, rng.integers(0, S, (B, K)),
                      rng.integers(0, R, (B, K)), vl)
    assert (r == -2**31).any() or (res < 0).any()


@pytest.mark.parametrize("B,K,m", [
    (16, 3, 7),
    (64, 5, 64),
    (100, 8, 301),
    (1, 7, 1),
])
def test_gather_results_matches_jax(B, K, m):
    rng = np.random.default_rng(B * 100 + m)
    res = rng.integers(-50, 100, (B, K))
    idx = rng.integers(0, B * K + 3, m)               # some out of range
    want = np.asarray(jops.gather_results(jnp.asarray(res, jnp.int32),
                                          jnp.asarray(idx, jnp.int32)))
    got = tops.gather_results(torch.tensor(res, dtype=torch.int32),
                              torch.tensor(idx, dtype=torch.int32))
    np.testing.assert_array_equal(want, got.numpy())


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor runs the plain version and launches no kernel."""
    before = dict(tk.LAUNCHES)
    regs = torch.zeros(8, dtype=torch.int32)
    one = torch.ones(4, dtype=torch.int32)
    tk.switch_txn_call(regs, one * 3, torch.arange(4, dtype=torch.int32),
                       one)
    out = tk.result_gather_call(regs, torch.tensor([0, 9, -1],
                                                   dtype=torch.int32))
    assert regs.tolist() == [1, 1, 1, 1, 0, 0, 0, 0]
    assert out.tolist() == [1, 0, 1]                  # clamped both ways
    assert tk.LAUNCHES == before


@pytest.mark.parametrize("bad,err", [
    (lambda x: x.to(torch.int64), TypeError),
    (lambda x: x.reshape(2, 2), ValueError),
    (lambda x: torch.stack([x, x], 1)[:, 0], ValueError),  # strided
    (lambda x: x[:3], ValueError),                          # wrong length
])
def test_launchers_reject_bad_inputs(bad, err):
    regs = torch.zeros(8, dtype=torch.int32)
    x = torch.arange(4, dtype=torch.int32)
    with pytest.raises(err):
        tk.switch_txn_call(regs, x, bad(x), x)
    if err is TypeError:
        with pytest.raises(err):
            tk.result_gather_call(regs, bad(x))
