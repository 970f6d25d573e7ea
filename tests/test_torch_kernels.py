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
from repro.kernels.switch_txn.ref import \
    scan_prune_ref as j_scan_prune_ref  # noqa: E402
from repro.kernels.switch_txn.ref import switch_exec_ref as jref  # noqa: E402
from repro_torch.kernels.switch_txn import ops as tops  # noqa: E402
from repro_torch.kernels.switch_txn import switch_txn as tk  # noqa: E402
from repro_torch.kernels.switch_txn.ref import switch_exec_ref as tref  # noqa: E402,E501
from repro_torch.kernels.switch_txn.ref import \
    scan_prune_ref as t_scan_prune_ref  # noqa: E402
from repro_torch.kernels.switch_txn.ref import \
    scan_topk_ref as t_scan_topk_ref  # noqa: E402


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
    with pytest.raises(err):
        tk.switch_txn_gather_call(regs, x, bad(x), x, x, 2, x)
    y = bad(x)
    if err is TypeError or y.dim() != 1 or not y.is_contiguous():
        with pytest.raises(err):                  # any length is an idx
            tk.result_gather_call(regs, y)
        with pytest.raises(err):
            tk.switch_txn_gather_call(regs, x, x, x, x, 2, y)


def test_gather_launchers_reject_empty_src_and_other_devices():
    """result_gather's lean launcher keeps every check: a non-tensor, an
    empty src, and tensors on an unsupported device or on two devices."""
    x = torch.arange(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        tk.result_gather_call([1, 2], x)
    with pytest.raises(ValueError):
        tk.result_gather_call(torch.zeros(0, dtype=torch.int32), x)
    meta = x.to("meta")
    for src, idx in ((meta, meta), (x, meta), (meta, x)):
        with pytest.raises(ValueError):
            tk.result_gather_call(src, idx)
    for regs, idx in ((meta, x), (x, meta)):
        with pytest.raises(ValueError):
            tk.switch_txn_gather_call(regs, x, x, x, x, 2, idx)
    with pytest.raises(ValueError):
        tk.switch_txn_gather_call(x[:0], x, x, x, x, 2, x)   # no registers


# ------------------------------------------------------------ scan tier --

S_SCAN, R_SCAN = 4, 32                        # tests/test_reads.py sizes


def _scan_case(seed, n, selectivity, values="uniform"):
    """A [4, 32] register file, an [n] slot stream over it (slots may
    repeat) and an inclusive range that keeps about ``selectivity``% of
    the gathered values: 0 and 100 are the empty and all-pass edges."""
    rng = np.random.default_rng(seed)
    if values == "ties":                       # few distinct values
        regs = rng.choice([-5, 0, 3, 3, 9], (S_SCAN, R_SCAN))
    elif values == "wrap":                     # sums past +-2**31
        regs = rng.choice([2**31 - 1, 2**31 - 7, 2**30, -2**31, -2**31 + 9],
                          (S_SCAN, R_SCAN))
    else:
        regs = rng.integers(-1000, 1000, (S_SCAN, R_SCAN))
    idx = rng.integers(0, S_SCAN * R_SCAN, n)
    src = regs.reshape(-1)[idx]
    if selectivity == 0:                       # a range between values
        u = np.unique(src).astype(np.int64)
        gap = np.flatnonzero(np.diff(u) > 1)
        lo = hi = int(u[gap[0]] + 1) if len(gap) else int(u[-1]) + 1
    elif selectivity == 100:
        lo, hi = int(src.min()), int(src.max())
    else:
        lo = int(np.percentile(src, max(0, 50 - selectivity // 2)))
        hi = int(np.percentile(src, min(100, 50 + selectivity // 2)))
    return regs.astype(np.int32), idx.astype(np.int32), src, lo, hi


@pytest.mark.parametrize("n,selectivity,cap,values", [
    (1, 100, 1, "uniform"),
    (37, 0, 5, "uniform"),
    (64, 30, 1, "uniform"),
    (64, 30, 64, "uniform"),
    (100, 50, 7, "ties"),
    (257, 100, 257, "wrap"),
    (300, 10, 300, "uniform"),
])
def test_scan_prune_matches_jax(n, selectivity, cap, values):
    """ops.scan_prune (gather + scan-prune) against the JAX op (Pallas in
    interpret mode) and the numpy oracle, exactly."""
    regs, idx, src, lo, hi = _scan_case(n * 7 + cap, n, selectivity, values)
    want = jops.scan_prune(jnp.asarray(regs), jnp.asarray(idx), lo, hi,
                           cap=cap)
    got = tops.scan_prune(torch.tensor(regs), torch.tensor(idx), lo, hi,
                          cap)
    for w, g, o, p in zip(want, got, t_scan_prune_ref(src, lo, hi, cap),
                          j_scan_prune_ref(src, lo, hi, cap)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
        np.testing.assert_array_equal(o, g.numpy())
        np.testing.assert_array_equal(p, o)


@pytest.mark.parametrize("values", ["uniform", "ties", "wrap"])
@pytest.mark.parametrize("selectivity", [0, 5, 40, 100])
def test_scan_prune_every_cap_matches_ref(selectivity, values):
    """Every cap from 1 to n (truncated, exact and padded outputs) on one
    stream, against the port's and the JAX package's numpy oracles."""
    n = 40
    regs, idx, src, lo, hi = _scan_case(selectivity + len(values), n,
                                        selectivity, values)
    for cap in range(1, n + 1):
        got = tops.scan_prune(torch.tensor(regs), torch.tensor(idx), lo, hi,
                              cap)
        for g, o, p in zip(got, t_scan_prune_ref(src, lo, hi, cap),
                           j_scan_prune_ref(src, lo, hi, cap)):
            np.testing.assert_array_equal(o, g.numpy())
            np.testing.assert_array_equal(p, o)
    if values == "wrap" and selectivity == 100:
        exact = int(src.astype(np.int64).sum())
        assert not -2**31 <= exact < 2**31          # the sum did wrap
        assert int(got[2][1]) == np.int64(exact).astype(np.int32)


def test_scan_prune_empty_and_inverted_ranges():
    """lo > hi, an empty stream and cap 0 give the empty result with the
    identities: (0, 0, INT32_MAX, INT32_MIN)."""
    src = torch.tensor([5, -3, 7], dtype=torch.int32)
    empty = [0, 0, tk.AGG_MIN_EMPTY, tk.AGG_MAX_EMPTY]
    vals, idx, agg = tk.scan_prune_call(src, 6, 4, 2)
    assert vals.tolist() == [0, 0] and idx.tolist() == [-1, -1]
    assert agg.tolist() == empty
    vals, idx, agg = tk.scan_prune_call(src[:0], -10, 10, 3)
    assert idx.tolist() == [-1] * 3 and agg.tolist() == empty
    vals, idx, agg = tk.scan_prune_call(src, -10, 10, 0)
    assert vals.numel() == 0 and agg.tolist() == [3, 9, -3, 7]
    with pytest.raises(OverflowError):
        tk.scan_prune_call(src, 0, 2**31, 1)


@pytest.mark.parametrize("n,selectivity,values", [
    (1, 100, "uniform"),
    (50, 0, "uniform"),
    (64, 40, "ties"),
    (128, 100, "ties"),
    (200, 20, "wrap"),
])
def test_scan_topk_matches_jax(n, selectivity, values):
    """ops.scan_topk against the JAX op (``lax.top_k``) and the numpy
    oracle for every k, ties included: equal values go to the lower
    position, the masked int32-min entries too."""
    regs, idx, src, lo, hi = _scan_case(n + selectivity, n, selectivity,
                                        values)
    jr, ji, tr, ti = (jnp.asarray(regs), jnp.asarray(idx),
                      torch.tensor(regs), torch.tensor(idx))
    for k in sorted({1, min(2, n), n // 2 or 1, n}):
        wv, wp, wc = jops.scan_topk(jr, ji, lo, hi, k=k)
        gv, gp, gc = tops.scan_topk(tr, ti, lo, hi, k)
        ov, op_, oc = t_scan_topk_ref(src, lo, hi, k)
        assert gv.dtype == gp.dtype == torch.int32
        assert int(gc) == int(wc) == oc
        np.testing.assert_array_equal(np.asarray(wv), gv.numpy())
        np.testing.assert_array_equal(np.asarray(wp), gp.numpy())
        np.testing.assert_array_equal(ov, gv.numpy())
        np.testing.assert_array_equal(op_, gp.numpy())


def test_scan_launches_only_on_cuda_tensors():
    before = dict(tk.LAUNCHES)
    regs = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    tops.scan_prune(regs, torch.arange(8, dtype=torch.int32), 2, 5, 3)
    assert tk.LAUNCHES == before
