"""The fused scan_prune kernel's algorithm, held against the JAX package's
``ops.scan_prune`` (Pallas ``result_gather`` + ``scan_prune``, interpret
mode on the CPU) and its engine's ``execute_scan``.

``scan_ref`` transcribes the CUDA scan (``src/repro_torch/kernels/
switch_txn/csrc/switch_txn.cu``) in numpy, launch by launch: the route
and tile chosen by M alone, the blocked load with the fused gather
clamped from both sides, the threads' match counts and their exclusive
block scan (each match's rank in stream order), the writes of ranks
below cap, the uint32 sum and the signed min and max, and the pads and
aggregates that make the packed buffer ``vals | pos | agg`` whole; past
``SCAN_SMEM_MAX`` the two launches over tiles of 4,096 (each tile's
aggregates to scratch, then each block's offset from the tiles before
it, its matches ranked into shared memory and written from the offset
as one run, and block 0's fold).  The output starts poisoned, as the launcher
pre-fills nothing.  The CUDA kernel itself runs only on the card, where
``chip_smoke.py`` holds it against the plain version; here the
transcription, the port's CPU ``ops.scan_prune`` and the port's CPU
``SwitchEngine.execute_scan`` must all equal JAX exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import engine as jeng  # noqa: E402
from repro.core import packets as jpk  # noqa: E402
from repro.kernels.switch_txn import ops as jops  # noqa: E402
from repro.kernels.switch_txn.ref import \
    scan_prune_ref as j_scan_prune_ref  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import packets as tpk  # noqa: E402
from repro_torch.kernels.switch_txn import ops as tops  # noqa: E402
from repro_torch.kernels.switch_txn import switch_txn as tk  # noqa: E402

TILES = ((128, 4), (256, 8), (512, 8), (1024, 16))   # threads x items
LARGE_T, LARGE_IPT = 256, 16
POISON = 123456789                 # no test value; every word is written
S, R = 8, 4096                     # a [8, 4096] register file
INT32_MAX, INT32_MIN = 2**31 - 1, -2**31


def _agg(v, hit):
    """(count, sum mod 2^32, min, max) of the matches, as Python ints."""
    h = v[hit].astype(np.int64)
    if not len(h):
        return [0, 0, INT32_MAX, INT32_MIN]
    return [len(h), int(h.sum()) % 2**32, int(h.min()), int(h.max())]


def _fold(aggs):
    t = [0, 0, INT32_MAX, INT32_MIN]
    for c, s, lo, hi in aggs:
        t = [t[0] + c, (t[1] + s) % 2**32, min(t[2], lo), max(t[3], hi)]
    return t


def _load(src, idx, m, length):
    """The values at positions 0 .. length - 1 (0 past m), read through
    idx clamped into src from both sides."""
    p = np.arange(length)
    k = np.zeros(length, np.int64)
    k[:m] = np.arange(m) if idx is None else idx
    j = np.clip(k, 0, len(src) - 1) if len(src) else k
    v = np.where(p < m, src[j] if len(src) else 0, 0).astype(np.int32)
    return v


def _write(out, v, hit, rank, pos, cap):
    sel = hit & (rank < cap)
    out[rank[sel]] = v[sel]
    out[cap + rank[sel]] = pos[sel]


def _finish(out, t, cap):
    """Pads past the count, then agg (the sum's bits as int32)."""
    r = np.arange(t[0], cap)
    out[r], out[cap + r] = 0, -1
    out[2 * cap:] = [t[0], np.uint32(t[1]).view(np.int32), t[2], t[3]]


def _ranks(hit2):
    """[threads, items]: each thread's count, their exclusive block scan,
    then the thread's own running count in stream order."""
    cnt = hit2.sum(1)
    return (np.cumsum(cnt) - cnt)[:, None] + np.cumsum(hit2, 1) - hit2


def scan_ref(src, idx, lo, hi, cap):
    """numpy transcription of the CUDA scan.  src: [n] int32; idx: [M]
    int32 or None (then v = src).  Returns (out [2 cap + 4] int32, route:
    "single" or "large")."""
    src = np.asarray(src, np.int32)
    m = len(src) if idx is None else len(idx)
    out = np.full(2 * cap + 4, POISON, np.int32)
    if m <= tk.SCAN_SMEM_MAX:
        T, ipt = next((t, i) for t, i in TILES if t * i >= m)
        v = _load(src, idx, m, T * ipt)
        hit = (np.arange(T * ipt) < m) & (v >= lo) & (v <= hi)
        rank = _ranks(hit.reshape(T, ipt)).reshape(-1)
        _write(out, v, hit, rank, np.arange(T * ipt), cap)
        _finish(out, _agg(v, hit), cap)
        route = "single"
    else:
        tile = LARGE_T * LARGE_IPT
        n_tiles = -(-m // tile)
        v = _load(src, idx, m, n_tiles * tile)
        hit = (np.arange(n_tiles * tile) < m) & (v >= lo) & (v <= hi)
        # pass 1: each tile's aggregates to scratch
        scratch = [_agg(v[b * tile:(b + 1) * tile],
                        hit[b * tile:(b + 1) * tile]) for b in range(n_tiles)]
        # pass 2: block b's offset; block 0 folds every tile
        for b in range(n_tiles):
            before = _fold(scratch[:n_tiles if b == 0 else b])
            if b == 0:
                _finish(out, before, cap)
            offset = 0 if b == 0 else before[0]
            if offset >= cap:
                continue
            # the block's matches, ranked into shared memory, then the
            # ones below cap written as one run from offset
            sl = slice(b * tile, (b + 1) * tile)
            rank = _ranks(hit[sl].reshape(LARGE_T, LARGE_IPT)).reshape(-1)
            s_val = np.zeros(tile, np.int32)
            s_pos = np.zeros(tile, np.int32)
            s_val[rank[hit[sl]]] = v[sl][hit[sl]]
            s_pos[rank[hit[sl]]] = np.arange(b * tile, (b + 1) * tile)[hit[sl]]
            n_out = min(int(hit[sl].sum()), cap - offset)
            out[offset:offset + n_out] = s_val[:n_out]
            out[cap + offset:cap + offset + n_out] = s_pos[:n_out]
        route = "large"
    assert not (out == POISON).any(), "a word of the packed buffer unwritten"
    return out, route


def _case(seed, m, selectivity, values="uniform", oob=0):
    """An [S, R] register file, an [m] slot stream over it (``oob`` of its
    entries at or past n_slots) and a range keeping about
    ``selectivity``% of the gathered values."""
    rng = np.random.default_rng(seed)
    if values == "edges":                     # sums past +-2**31
        regs = rng.choice([INT32_MAX, INT32_MAX - 7, 2**30, INT32_MIN,
                           INT32_MIN + 9, 0, -1], (S, R))
    else:
        regs = rng.integers(-2**30, 2**30, (S, R))
    idx = rng.integers(0, S * R, m)
    idx[rng.choice(m, min(oob, m), replace=False)] = rng.choice(
        [S * R, S * R + 5, INT32_MAX], min(oob, m))
    src = regs.reshape(-1)[np.clip(idx, 0, S * R - 1)]
    if selectivity == 0:
        lo, hi = 2**30 + 1, 2**30 + 2           # between every value
        if values == "edges":
            lo, hi = 5, 6
    elif selectivity == 100:
        lo, hi = INT32_MIN, INT32_MAX
    else:
        q = np.sort(src)
        lo = int(q[0])
        hi = int(q[max(0, int(selectivity / 100 * m) - 1)])
    return regs.astype(np.int32), idx.astype(np.int32), lo, hi


def _jax_packed(regs, idx, lo, hi, cap):
    """JAX's packed result.  Pallas takes no zero-row output block, so at
    cap 0 the JAX package's numpy oracle stands in for its kernel."""
    if cap == 0:
        src = regs.reshape(-1)[np.clip(idx, 0, regs.size - 1)]
        return np.concatenate(j_scan_prune_ref(src, lo, hi, 0))
    vals, pos, agg = jops.scan_prune(jnp.asarray(regs), jnp.asarray(idx), lo,
                                     hi, cap=cap)
    return np.concatenate([np.asarray(vals), np.asarray(pos),
                           np.asarray(agg)])


def _all_equal(regs, idx, lo, hi, cap, want=None):
    """JAX, the transcription, the port's ops (split and packed) and the
    port's CPU engine, all exactly equal.  Returns (packed, route)."""
    if want is None:
        want = _jax_packed(regs, idx, lo, hi, cap)
    got, route = scan_ref(regs.reshape(-1), idx, lo, hi, cap)
    np.testing.assert_array_equal(want, got, err_msg="transcription")
    t_regs, t_idx = torch.tensor(regs), torch.tensor(idx)
    split = tops.scan_prune(t_regs, t_idx, lo, hi, cap)
    packed = tops.scan_prune_packed(t_regs, t_idx, lo, hi, cap)
    assert packed.dtype == torch.int32 and packed.shape == (2 * cap + 4,)
    np.testing.assert_array_equal(want, packed.numpy(), err_msg="packed")
    np.testing.assert_array_equal(
        want, torch.cat(split).numpy(), err_msg="ops.scan_prune")
    cfg = tpk.SwitchConfig(n_stages=S, regs_per_stage=R, max_instrs=4)
    eng = teng.SwitchEngine(cfg, regs, device="cpu")
    rp = tpk.ReadPacket(switch=np.zeros(len(idx), np.int32),
                        stage=idx // R, reg=idx % R)
    host = eng.execute_scan(rp, lo, hi, cap=cap)
    np.testing.assert_array_equal(want, np.concatenate(host),
                                  err_msg="SwitchEngine.execute_scan")
    return want, route


@pytest.mark.parametrize("values", ["uniform", "edges"])
@pytest.mark.parametrize("selectivity", [0, 5, 40, 100])
def test_fused_scan_matches_jax_every_selectivity_and_cap(selectivity,
                                                          values):
    """The main path's M = 4,096 (the scan cluster's hot keys) at caps 0,
    1, 16, the exact match count and M, with slots past the file."""
    m = 4096
    regs, idx, lo, hi = _case(selectivity * 3 + len(values), m, selectivity,
                              values, oob=16)
    count = None
    for cap in (0, 1, 16, None, m):
        if cap is None:
            cap = count
        want, route = _all_equal(regs, idx, lo, hi, cap)
        count = int(want[2 * cap])
        assert route == "single"
    assert (count == 0) == (selectivity == 0)
    assert (count == m) == (selectivity == 100)
    if values == "edges" and selectivity == 100:
        exact = int(regs.reshape(-1)[np.clip(idx, 0, S * R - 1)]
                    .astype(np.int64).sum())
        assert not INT32_MIN <= exact <= INT32_MAX      # the sum wrapped
        assert int(want[2 * m + 1]) == np.int64(exact).astype(np.int32)


@pytest.mark.parametrize("m", [1, 400, 512, 513, 2048, 2049, 4097, 16384,
                               16385, 20000])
def test_fused_scan_sizes_and_route(m, monkeypatch):
    """Every tile boundary, SCAN_SMEM_MAX and past it: the transcription
    and the wrapper take the large path exactly when M > SCAN_SMEM_MAX
    (spied on the wrapper's ``_scan_large``), at cap 16 and at the exact
    count, equal to JAX."""
    calls = []
    large = tk._scan_large
    monkeypatch.setattr(tk, "_scan_large",
                        lambda *a: calls.append(a[-1]) or large(*a))
    regs, idx, lo, hi = _case(m, m, 5, oob=3)
    want, route = _all_equal(regs, idx, lo, hi, 16)
    count = int(want[2 * 16])
    _all_equal(regs, idx, lo, hi, count)
    assert route == ("large" if m > tk.SCAN_SMEM_MAX else "single")
    # _all_equal's packed and split calls and the engine's, per cap
    assert calls == ([m] * 6 if m > tk.SCAN_SMEM_MAX else [])


def test_large_path_cap_spans_tiles():
    """Past SCAN_SMEM_MAX with a cap that reaches into later tiles (cap
    = M at 100%, and a cap ending inside the third tile): every block
    below cap writes its ranks, block 0 folds every tile."""
    m = 3 * 4096 * 2 + 77
    regs, idx, lo, hi = _case(7, m, 100, "edges")
    for cap in (m, 2 * 4096 + 100):
        want, route = _all_equal(regs, idx, lo, hi, cap)
        assert route == "large" and int(want[2 * cap]) == m


def test_negative_idx_clamps_to_zero():
    """A negative slot clamps to 0 in the kernel and the plain version
    (the port clamps from below too; the TPU kernel only from above and
    JAX wraps a negative index, so this is held against the port's plain
    composition and numpy, not JAX)."""
    regs, idx, lo, hi = _case(11, 600, 40, oob=20)
    idx[::7] = np.array([-1, -5, INT32_MIN])[np.arange(len(idx[::7])) % 3]
    src = regs.reshape(-1)[np.clip(idx, 0, S * R - 1)]
    for cap in (0, 16, 600):
        want = np.concatenate(tk.scan_prune_plain(torch.tensor(src), lo, hi,
                                                  cap))
        got = np.concatenate(tk.scan_prune_gather_plain(
            torch.tensor(regs.reshape(-1)), torch.tensor(idx), lo, hi, cap))
        np.testing.assert_array_equal(want, got)
        _all_equal(regs, idx, lo, hi, cap, want=want)


def test_scan_prune_call_packs_and_routes_without_idx(monkeypatch):
    """``scan_prune_call`` (no gather) takes the same packed route by M:
    its three outputs are the packed buffer's thirds, equal to the
    transcription with idx = None, and the large path past
    SCAN_SMEM_MAX."""
    calls = []
    large = tk._scan_large
    monkeypatch.setattr(tk, "_scan_large",
                        lambda *a: calls.append(a[-1]) or large(*a))
    rng = np.random.default_rng(5)
    for m in (0, 1, 4096, tk.SCAN_SMEM_MAX + 1):
        src = rng.integers(-50, 50, m).astype(np.int32)
        for cap in (0, 3, m):
            got = tk.scan_prune_call(torch.tensor(src), -10, 10, cap)
            want, route = scan_ref(src, None, -10, 10, cap)
            np.testing.assert_array_equal(want, torch.cat(got).numpy())
            assert [g.numel() for g in got] == [cap, cap, 4]
    assert calls == [tk.SCAN_SMEM_MAX + 1] * 3


def test_execute_scan_copies_the_slot_list_once():
    """A repeated scan over the same slots (and the truncated scan's
    rescan) reuses the engine's device copy of the slot list; other
    slots are copied anew."""
    regs, idx, lo, hi = _case(3, 300, 40)
    cfg = tpk.SwitchConfig(n_stages=S, regs_per_stage=R, max_instrs=4)
    eng = teng.SwitchEngine(cfg, regs, device="cpu")
    puts = []
    put = eng._put
    eng._put = lambda x: puts.append(len(x)) or put(x)
    rp = lambda ix: tpk.ReadPacket(switch=np.zeros(len(ix), np.int32),
                                   stage=ix // R, reg=ix % R)
    first = eng.execute_scan(rp(idx), lo, hi, cap=16)
    again = eng.execute_scan(rp(idx.copy()), lo, hi, cap=300)
    eng.execute_scan(rp(idx[:100]), lo, hi, cap=16)
    assert puts == [300, 100]
    want = _jax_packed(regs, idx, lo, hi, 16)
    np.testing.assert_array_equal(want, np.concatenate(first))
    np.testing.assert_array_equal(_jax_packed(regs, idx, lo, hi, 300),
                                  np.concatenate(again))
    je = jeng.SwitchEngine(jpk.SwitchConfig(n_stages=S, regs_per_stage=R,
                                            max_instrs=4), regs)
    jrp = jpk.ReadPacket(switch=np.zeros(300, np.int32), stage=idx // R,
                         reg=idx % R)
    np.testing.assert_array_equal(
        np.concatenate(je.execute_scan(jrp, lo, hi, cap=16)), want)


def test_fused_launchers_reject_bad_inputs():
    """The lean launcher keeps every check: dtype, shape, an empty file
    to gather from, a negative cap, bounds out of int32, two devices."""
    regs = torch.zeros(8, dtype=torch.int32)
    x = torch.arange(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        tk.scan_prune_gather_call(regs, x.to(torch.int64), 0, 1, 2)
    with pytest.raises(ValueError):
        tk.scan_prune_gather_call(regs.reshape(2, 4), x, 0, 1, 2)
    with pytest.raises(ValueError):
        tk.scan_prune_gather_call(regs[:0], x, 0, 1, 2)
    with pytest.raises(ValueError):
        tk.scan_prune_gather_call(regs, x, 0, 1, -1)
    with pytest.raises(OverflowError):
        tk.scan_prune_gather_call(regs, x, 0, 2**31, 1)
    with pytest.raises(ValueError):
        tk.scan_prune_gather_call(regs, x.to("meta"), 0, 1, 2)
    before = dict(tk.LAUNCHES)
    tk.scan_prune_gather_call(regs, x, 0, 1, 2)
    assert tk.LAUNCHES == before                    # CPU: no launch
