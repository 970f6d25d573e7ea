"""The switch-engine walk kernels' algorithm, held against the plain
versions and the JAX package's compiled engines.

``walk_ref`` transcribes ``csrc/switch_engine.cu`` (``src/repro_torch/
kernels/switch_engine``) step by step in numpy.  The single-CTA route (N <=
``WALK_SMEM_MAX``): the per-mode key, seed, opcode and flag rule with int32
wraparound (serial's same-chain ADDP flag, staged's dense keys when every
live reg lies in [0, R)), the tile chosen by N and its sentinel padding,
the block min / max and the stable sort of ``key - min`` over
``bit_length(max - min)`` bits (as uint32 keys unless a staged range needs
more), run heads and ends, then affine and staged: the segmented scan of
(a, b) maps applied to each chain's seed, staged in rounds while a
forwarded ADDP's addend changes; serial: one walk a chain in stream order
in rounds while a cross-chain ADDP addend changes, at most ``ROUND_CAP``,
then the one-thread walk from scratch; the two-phase write-back and the
compaction gather.  The large route: the full keys' stable sort, the scan
over tiles of 2,048 (tile aggregates, their exclusive prefix, each tile
rescanned from it) or the chain walks, each round behind a gather of the
addends, ``ROUND_CAP`` rounds then the one-thread walk, and the one-pass
write-back in which a negative chain yields to its target's own chain.
The CUDA kernels run only on the card, where ``chip_smoke.py`` phase 21
holds them against the plain versions; here the transcription must equal
the plain versions and the JAX engines exactly (registers, res, ok,
compact) on streams with every opcode each mode takes, out-of-range and
negative slots, slots that wrap int32, sums past +-2^31, one hot chain the
length of the stream, ADDP sources deeper than the round cap and keys
whose range needs the full width."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import engine as jeng  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.packets import SwitchConfig as TSwitchConfig  # noqa: E402,E501
from repro_torch.kernels.switch_engine import switch_engine as kw  # noqa: E402,E501
from test_engine import CFG  # noqa: E402

NOP, READ, WRITE, ADD, CADD, ADDP = 0, 1, 2, 3, 4, 5
TILES = ((32, 1), (256, 1), (256, 4), (512, 8), (512, 16))  # threads x items
SCAN_TILE = 2048                       # the large route's scan tile
SIGN = 1 << 31
MASK32 = (1 << 32) - 1
NO_DENSE = MASK32
CAP = kw.ROUND_CAP
S, R = CFG.n_stages, CFG.regs_per_stage
# (N, B, K) of each case: N = B * K
SHAPES = {1: (1, 1), 16: (1, 16), 4096: (256, 16), 8192: (512, 16),
          8193: (2731, 3)}
_JIT = {m: jax.jit(jeng._ENGINE_IMPLS[m]) for m in kw.MODES}


def _wrap(x):
    """int64 -> int32 value with two's-complement wraparound, as int64."""
    return ((np.asarray(x, np.int64) + SIGN) & MASK32) - SIGN


def _prep(mode, S, n_slots, K, op, st, rg, v):
    """Step 1: key (uint64), seed (-1: none), opcode class, write-enable,
    forward and same-chain flags, operand (an ADDP's source position) and
    the staged dense key."""
    n = op.shape[0]
    R_ = n_slots // S
    code = np.where((op >= NOP) & (op <= ADDP), op, READ)
    g = _wrap(st.astype(np.int64) * R_ + rg)
    pos = np.arange(n)
    src = pos - pos % K + np.clip(v, 0, K - 1)
    wen = np.zeros(n, bool)
    fwd = np.zeros(n, bool)
    same = np.zeros(n, bool)
    dense = np.full(n, n_slots, np.int64)
    vq = v.astype(np.int64)
    if mode == "serial":
        live = code != NOP
        a = np.where(g < 0, g + n_slots, g)
        slot = np.clip(a, 0, n_slots - 1)
        key = np.where(live, slot, n_slots)
        seed = np.where(live, slot, -1)
        wen = live & (a >= 0) & (a < n_slots)
        addp = code == ADDP
        vq = np.where(addp, src, vq)
        same = addp & (src < pos) & live[src] & (slot[src] == slot)
    elif mode == "affine":
        code = np.where(np.isin(code, (NOP, WRITE, ADD)), code, READ)
        nop = code == NOP
        key = np.where(nop, (n_slots & MASK32) ^ SIGN, (g & MASK32) ^ SIGN)
        seed = np.where(nop, n_slots - 1, np.clip(
            np.where(g < 0, g + n_slots, g), 0, n_slots - 1))
    else:                                            # staged
        active = (code != NOP) & (st >= 0) & (st < S)
        code = np.where(active, np.where(np.isin(code, (WRITE, ADD, ADDP)),
                                         code, READ), NOP)
        key = np.where(active, (st.astype(np.int64) << 32)
                       | ((rg.astype(np.int64) & MASK32) ^ SIGN), S << 32)
        seed = np.where(active, st.astype(np.int64) * R_ + np.clip(
            np.where(rg < 0, rg.astype(np.int64) + R_, rg), 0, R_ - 1), -1)
        dense = np.where(active, np.where(
            (rg >= 0) & (rg < R_), st.astype(np.int64) * R_ + rg, NO_DENSE),
            n_slots)
        addp = code == ADDP
        fwd = addp & (st[src] >= 0) & (st[src] < st)
        vq = np.where(addp, src, vq)
    return (key.astype(np.uint64), seed, code, wen, fwd, same, vq,
            dense.astype(np.uint64))


def _sentinel(mode, S, n_slots):
    return {"serial": n_slots, "affine": (n_slots & MASK32) ^ SIGN,
            "staged": S << 32}[mode]


def _writeback_slot(mode, S, key, phase, n_slots):
    """The register the run of ``key`` writes in ``phase``, or -1."""
    key = int(key)
    if mode == "serial":
        return key if phase == 1 and key < n_slots else -1
    file, base = n_slots, 0
    if mode == "staged":
        s = key >> 32
        if s >= S:
            return -1
        file, base = n_slots // S, s * (n_slots // S)
    g = (key & MASK32) - SIGN             # the flipped sign bit, undone
    if g >= 0:
        return base + g if phase == 1 and g < file else -1
    t = g + file + 1
    return base + t if phase == 0 and 0 <= t < file else -1


def _owner_key(mode, S, key, t, n_slots):
    """The key of the chain whose own slot is a negative chain's target."""
    if mode == "affine":
        return (t & MASK32) ^ SIGN
    s = int(key) >> 32
    return (s << 32) | (((t - s * (n_slots // S)) & MASK32) ^ SIGN)


def _seg(code, b, head):
    """Each instruction's map x -> a*x + b (fa bit 0: a) and run start
    (fa bit 1): WRITE (0, v), ADD and ADDP (1, v), the rest (1, 0)."""
    fa = np.where(code == WRITE, 0, 1) | np.where(head, 2, 0)
    b = np.where(np.isin(code, (WRITE, ADD, ADDP)), b, 0) & MASK32
    return fa.astype(np.int64), b.astype(np.int64)


def _seg_op(lfa, lb, rfa, rb):
    """l then r: a run start in r drops l; else a = l.a r.a, b = r.a l.b +
    r.b (uint32), the run flag l's."""
    start = (rfa & 2) != 0
    fa = np.where(start, rfa, (lfa & rfa & 1) | (lfa & 2))
    b = np.where(start, rb, np.where(rfa & 1, (lb + rb) & MASK32, rb))
    return fa, b


def _seg_scan(fa, b):
    """Inclusive scan under ``_seg_op`` (log-step: the operator is
    associative, so any bracketing the block scan takes agrees)."""
    fa, b = fa.copy(), b.copy()
    d = 1
    while d < fa.size:
        fa[d:], b[d:] = _seg_op(fa[:-d], b[:-d], fa[d:], b[d:])
        d *= 2
    return fa, b


def _seg_fold(fa, b):
    """The composition of all of them in order (a tile's aggregate)."""
    acc_fa, acc_b = np.int64(1), np.int64(0)
    for x, y in zip(fa, b):
        acc_fa, acc_b = (int(v) for v in _seg_op(acc_fa, acc_b, x, y))
    return acc_fa, acc_b


def _apply(fa, b, seed):
    return _wrap(np.where(fa & 1, (seed + b) & MASK32, b))


def _walk_chain(j, c, spos, sop, sv, last, vq, same, wen, res, ok):
    """One serial chain from its head at sorted index j, value c (the
    seed), in stream order.  Returns its final value."""
    while True:
        p, code, v = spos[j], sop[j], sv[j]
        add = res[vq[p]] if code == ADDP and same[p] else v
        post = _wrap(c + add)
        nxt = (v if code == WRITE else
               post if code in (ADD, ADDP) or (code == CADD and post >= 0)
               else c)
        res[p] = c if code == READ else nxt
        ok[p] = not (code == CADD and post < 0)
        if wen[p]:
            c = nxt
        if last[j]:
            return c
        j += 1


def _one_thread_walk(mode, n, code, vq, cur, res, ok, wen, fwd, skey,
                     spos):
    """The last resort, one thread for the whole stream: serial in stream
    order over the entries (res zeroed first), staged over the sorted runs;
    leaves each chain's final value at its head's slot of cur."""
    if mode == "serial":
        res[:] = 0
        head_of = {}
        ent = np.empty(len(cur), np.int64)
        for j, p in enumerate(spos):
            ent[p] = head_of.setdefault(int(skey[j]), p)
        for p in range(n):
            c_ = code[p]
            ok[p] = True
            if c_ == NOP:
                continue
            e, v = ent[p], vq[p]
            c = cur[e]
            post = _wrap(c + (res[v] if c_ == ADDP else v))
            nxt = (v if c_ == WRITE else
                   post if c_ in (ADD, ADDP) or (c_ == CADD and post >= 0)
                   else c)
            res[p] = c if c_ == READ else nxt
            ok[p] = not (c_ == CADD and post < 0)
            if wen[p]:
                cur[e] = nxt
        return
    head, chain, c = -1, None, 0
    for j in range(len(spos)):
        p = spos[j]
        if p >= n:
            continue
        if head < 0 or skey[j] != chain:
            if head >= 0:
                cur[head] = c
            head, chain, c = p, skey[j], cur[p]
        c_, v = code[p], vq[p]
        if c_ == WRITE:
            c = v
        elif c_ == ADD:
            c = _wrap(c + v)
        elif c_ == ADDP:
            c = _wrap(c + (res[v] if fwd[p] else 0))
        res[p] = 0 if c_ == NOP else c
        ok[p] = True
    if head >= 0:
        cur[head] = c


def _serial_rounds(n, heads, spos, sop, sv, last, vq, same, wen, cur, res,
                   ok, write):
    """Serial rounds: every chain walked from its head (``write(j, c)``
    writes its final value back), then the cross-chain ADDP addends
    refreshed from the results; repeat while one changed.  Returns the
    rounds walked and whether they converged within ``CAP``."""
    cross = np.flatnonzero((sop == ADDP) & ~same[spos])
    rounds = 0
    while True:
        for j in heads:
            p = spos[j]
            if p < n and sop[j] != NOP:
                write(j, _walk_chain(j, cur[p], spos, sop, sv, last, vq,
                                     same, wen, res, ok))
        rounds += 1
        p = spos[cross]
        q = vq[p]
        new = np.where(q < p, res[np.minimum(q, len(res) - 1)], 0)
        changed = (new != sv[cross]).any()
        sv[cross] = new
        if not changed:
            return rounds, True
        if rounds == CAP:
            return rounds, False


def walk_ref(mode, regs, op, stage, reg, val, idx, trace=None):
    """numpy transcription of one dispatch.  regs: [S, R]; op/stage/reg/
    val: [B, K]; idx: [M].  Returns (regs after, res [B, K] int32, ok
    [B, K] bool, compact [M] int32); ``trace`` (a dict) receives the
    route, the sort's key bits and the rounds (negative: walked)."""
    S = np.shape(regs)[0]
    regs = np.array(regs, np.int64).reshape(-1)
    n_slots = regs.shape[0]
    B, K = op.shape
    n = B * K
    flat = lambda a: np.asarray(a, np.int64).reshape(-1)
    key, seed, code, wen, fwd, same, vq, dense = _prep(
        mode, S, n_slots, K, flat(op), flat(stage), flat(reg), flat(val))
    large = n > kw.WALK_SMEM_MAX
    trace = {} if trace is None else trace
    if large:
        tile, pad = n, 0
    else:
        tile = next(t * i for t, i in TILES if t * i >= n)
        pad = tile - n
    pad_u = lambda a, x: np.concatenate([a, np.full(pad, x, a.dtype)])
    seed, code, vq = pad_u(seed, -1), pad_u(code, NOP), pad_u(vq, 0)
    wen, fwd, same = pad_u(wen, False), pad_u(fwd, False), pad_u(same,
                                                                  False)
    key = pad_u(key, np.uint64(_sentinel(mode, S, n_slots)))
    is_dense = False
    if large:
        bits, lo = 64, np.uint64(0)
        spos = np.argsort(key, kind="stable")          # torch.sort, stable
    else:
        if mode == "staged" and (dense[:n] != NO_DENSE).all():
            is_dense = True
            key = pad_u(dense, np.uint64(n_slots))
        lo, hi = key.min(), key.max()
        bits = max(1, int(hi - lo).bit_length())
        assert mode == "staged" or bits <= 32          # uint32 sort keys
        rkey = key - lo
        assert int(rkey.max()) < 1 << bits
        spos = np.argsort(rkey, kind="stable")         # the radix sort
    trace.update(route="switch_walk" if large else "switch_walk_smem",
                 bits=bits, wide=bits > 32)
    skey = key[spos]
    keyset = set(skey.tolist())
    head = np.r_[True, skey[1:] != skey[:-1]]
    last = np.r_[skey[:-1] != skey[1:], True]
    heads = np.flatnonzero(head)

    def full(k):                       # the chain's key under the mode rule
        k = int(k)
        if is_dense:
            return ((k // (n_slots // S)) << 32) | (
                (k % (n_slots // S)) ^ SIGN)
        return k

    cur = np.where(seed >= 0, regs[np.maximum(seed, 0)], 0)
    res = np.zeros(tile, np.int64)
    ok = np.ones(tile, bool)
    sop = code[spos]
    if mode == "serial":
        sv = np.where(sop == ADDP, 0, vq[spos])

        def write(j, c):
            t = _writeback_slot(mode, S, full(skey[j]), 1, n_slots)
            if t >= 0:
                regs[t] = c

        rounds, converged = _serial_rounds(n, heads, spos, sop, sv, last, vq,
                                           same, wen, cur, res, ok, write)
        if not converged:
            _one_thread_walk(mode, n, code, vq, cur, res, ok, wen, fwd, skey,
                             spos)
            for j in heads:
                if spos[j] < n:
                    write(j, cur[spos[j]])
            rounds = -rounds
    else:
        fwd_s = fwd[spos]
        add = np.zeros(tile, np.int64)
        cap = CAP if large else None
        rounds = 0
        while True:
            fa, b = _seg(sop, np.where(sop == ADDP, add, vq[spos]), head)
            if large:                  # reduce, prefix, rescan over tiles
                pre_fa, pre_b = np.int64(1), np.int64(0)
                for t0 in range(0, tile, SCAN_TILE):
                    sl = slice(t0, t0 + SCAN_TILE)
                    agg = _seg_fold(fa[sl], b[sl])
                    fa[sl], b[sl] = _seg_op(pre_fa, pre_b,
                                            *_seg_scan(fa[sl], b[sl]))
                    pre_fa, pre_b = (int(v) for v in _seg_op(
                        pre_fa, pre_b, *agg))
            else:
                fa, b = _seg_scan(fa, b)
            value = _apply(fa, b, cur[spos])
            live = spos < n
            res[spos[live]] = np.where(sop == NOP, 0, value)[live]
            rounds += 1
            if large:                  # the one-pass write-back
                for j in np.flatnonzero(last):
                    k = full(skey[j])
                    t = _writeback_slot(mode, S, k, 1, n_slots)
                    if t >= 0:
                        regs[t] = value[j]
                        continue
                    t = _writeback_slot(mode, S, k, 0, n_slots)
                    if t >= 0 and _owner_key(mode, S, k, t,
                                             n_slots) not in keyset:
                        regs[t] = value[j]
            new = np.where(fwd_s, res[np.clip(vq[spos], 0, tile - 1)], 0)
            changed = (new != add).any()
            add = new
            if not changed:
                break
            if cap is not None and rounds == cap:
                _one_thread_walk(mode, n, code, vq, cur, res, ok, wen, fwd,
                                 skey, spos)
                for j in heads:
                    k = full(skey[j])
                    t = _writeback_slot(mode, S, k, 1, n_slots)
                    if t < 0:
                        t = _writeback_slot(mode, S, k, 0, n_slots)
                        if t >= 0 and _owner_key(mode, S, k, t,
                                                 n_slots) in keyset:
                            t = -1
                    if t >= 0:
                        regs[t] = cur[spos[j]]
                rounds = -rounds
                break
        if not large:                  # negative chains first, then the rest
            for phase in (0, 1):
                for j in np.flatnonzero(last):
                    t = _writeback_slot(mode, S, full(skey[j]), phase,
                                        n_slots)
                    if t >= 0:
                        regs[t] = res[spos[j]]
    trace["rounds"] = rounds
    res = res[:n]
    compact = res[np.clip(np.asarray(idx, np.int64), 0, n - 1)]
    return (regs.astype(np.int32).reshape(S, -1),
            res.astype(np.int32).reshape(B, K), ok[:n].reshape(B, K),
            compact.astype(np.int32))


def walk_stream(rng, mode, B, K):
    """A stream with every opcode ``mode`` takes, a third of it on four
    hot slots, stray slots: past the file, negative (both within one
    file's length and beyond), a stage past 2^31 / R (wraps int32), and
    for staged stages outside [0, S); operands at the int32 edges; ADDP
    sources anywhere in the row (out of range too)."""
    ops = {"serial": (NOP, READ, WRITE, ADD, CADD, ADDP),
           "affine": (NOP, READ, WRITE, ADD),
           "staged": (NOP, READ, WRITE, ADD, ADDP)}[mode]
    op = rng.choice(ops, (B, K)).astype(np.int32)
    st = rng.integers(0, S, (B, K)).astype(np.int32)
    rg = rng.integers(0, R, (B, K)).astype(np.int32)
    hot = rng.random((B, K)) < 0.35
    hs, hr = np.array([0, 1, S - 1, S - 1]), np.array([-2, 3, R - 1, R - 2])
    pick = rng.integers(0, 4, int(hot.sum()))
    st[hot], rg[hot] = hs[pick], hr[pick]
    stray = rng.random((B, K)) < 0.3
    kinds = rng.integers(0, 6, int(stray.sum()))
    s_st, s_rg = st[stray], rg[stray]
    s_st = np.where(kinds == 0, S + 2, s_st)                   # past file
    s_rg = np.where(kinds == 1, R + 3, s_rg)                   # past row
    s_st = np.where(kinds == 2, 0, s_st)
    s_rg = np.where(kinds == 2, -rng.integers(1, S * R + 3, kinds.size),
                    s_rg)                                       # negative
    s_st = np.where(kinds == 3, 2**31 // R + 1, s_st)           # wraps
    s_st = np.where(kinds == 4, -1, s_st)                       # stage < 0
    s_rg = np.where(kinds == 5, -1, s_rg)                       # reg -1
    st[stray], rg[stray] = s_st, s_rg
    val = rng.integers(-100, 100, (B, K)).astype(np.int32)
    edge = rng.random((B, K)) < 0.1
    val[edge] = rng.choice([2**31 - 1, -2**31, 2**30], int(edge.sum()))
    addp = op == ADDP
    val[addp] = rng.integers(-1, K + 1, int(addp.sum()))
    regs = rng.integers(-50, 50, (S, R)).astype(np.int32)
    regs[0, 0], regs[S - 1, R - 1] = 2**31 - 20, -2**31 + 5
    idx = rng.integers(-3, B * K + 8, 2 * B * K).astype(np.int32)
    return regs, op, st, rg, val, idx


def _jax(mode, regs, op, st, rg, val, idx):
    r, res, ok = _JIT[mode](*(jnp.asarray(a) for a in (regs, op, st, rg,
                                                        val)))
    res = np.asarray(res)
    compact = np.asarray(jnp.take(res.reshape(-1), jnp.asarray(idx),
                                  mode="clip"))
    return np.asarray(r), res, np.asarray(ok, bool), compact


def _assert_same(a, b, what):
    for name, x, y in zip(("registers", "res", "ok", "compact"), a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{what}: {name}")


def _hold(mode, regs, op, st, rg, val, idx, what):
    """The transcription against the plain version (through the launcher
    on the CPU) and the JAX engine; returns the transcription's trace."""
    trace = {}
    ref = walk_ref(mode, regs, op, st, rg, val, idx, trace)
    t = lambda a: torch.from_numpy(np.array(a, np.int32))
    plain = kw.switch_walk_gather_call(mode, t(regs), t(op), t(st), t(rg),
                                       t(val), t(idx))
    _assert_same(ref, [x.numpy() for x in plain], f"{what} plain")
    _assert_same(ref, _jax(mode, regs, op, st, rg, val, idx), f"{what} JAX")
    return trace


def _case(mode, n, seed):
    B, K = SHAPES[n]
    rng = np.random.default_rng(seed)
    return _hold(mode, *walk_stream(rng, mode, B, K), f"{mode} N={n}")


@pytest.mark.parametrize("n", [1, 16, 4096])
@pytest.mark.parametrize("mode", kw.MODES)
def test_walk_transcription_matches_plain_and_jax(mode, n):
    _case(mode, n, 100 + n + kw.MODES.index(mode))


@pytest.mark.parametrize("n", [8192, 8193])
@pytest.mark.parametrize("mode", ["affine"])
def test_walk_transcription_at_the_route_boundary(mode, n):
    """The largest single-CTA tile and the first large-route stream (the
    other modes there are in the heavy matrix)."""
    _case(mode, n, 200 + n + kw.MODES.index(mode))


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n", [8192, 8193])
@pytest.mark.parametrize("mode", kw.MODES)
def test_walk_transcription_heavy_matrix(mode, n, seed):
    """Every mode at the route boundary, several seeds (the serial plain
    version loops over the stream in Python: seconds a case)."""
    _case(mode, n, 300 + 10 * seed + n + kw.MODES.index(mode))


@pytest.mark.parametrize("mode", kw.MODES)
def test_walk_one_hot_chain_the_length_of_the_stream(mode):
    """All 4,096 instructions on one slot: one chain, which the scan
    composes at once (affine, staged) and one thread walks whole (serial).
    Every ADDP source is in that chain or not yet run, so one round."""
    rng = np.random.default_rng(400 + kw.MODES.index(mode))
    regs, op, st, rg, val, idx = walk_stream(rng, mode, 256, 16)
    st[:], rg[:] = 1, 3
    trace = _hold(mode, regs, op, st, rg, val, idx, f"{mode} one chain")
    assert trace["route"] == "switch_walk_smem" and trace["rounds"] == 1


def _ladder(rng, mode, S_, R_, B, K, depth):
    """Registers [S_, R_] and a [B, K] stream whose rows each climb an
    ADDP ladder: instruction k <= depth (k >= 1) adds instruction k - 1's
    result on a slot of its own (staged: on ascending stages, so every
    ADDP is forwarded), the first an ADD, the rest READ / ADD."""
    op = rng.choice([READ, ADD], (B, K)).astype(np.int32)
    op[:, 0] = ADD
    op[:, 1:depth + 1] = ADDP
    val = rng.integers(1, 1000, (B, K)).astype(np.int32)
    val[:, 1:depth + 1] = np.arange(depth, dtype=np.int32)
    st = np.empty((B, K), np.int32)
    rg = rng.integers(0, R_, (B, K)).astype(np.int32)
    for b in range(B):
        if mode == "staged":
            st[b] = np.sort(rng.choice(S_, K, replace=False))
        else:
            flat = rng.choice(S_ * R_, K, replace=False)
            st[b], rg[b] = flat // R_, flat % R_
    regs = rng.integers(-1000, 1000, (S_, R_)).astype(np.int32)
    idx = np.arange(B * K, dtype=np.int32)
    return regs, op, st, rg, val, idx


@pytest.mark.parametrize("depth", [2, 15])
def test_walk_serial_addp_ladders_within_and_past_the_cap(depth):
    """Cross-chain ADDP sources two deep converge in a few rounds; fifteen
    deep (past ``ROUND_CAP``) the rounds give up and the one-thread walk
    takes the stream from scratch: both equal the plain version and JAX."""
    rng = np.random.default_rng(500 + depth)
    trace = _hold("serial", *_ladder(rng, "serial", 24, 64, 64, 16, depth),
                  f"serial ladder {depth}")
    if depth > CAP:
        assert trace["rounds"] == -CAP
    else:
        assert 1 < trace["rounds"] <= CAP


@pytest.mark.parametrize("n_rows", [64, pytest.param(683,
                                                     marks=pytest.mark.slow)])
def test_walk_staged_forwarding_over_many_stages(n_rows):
    """Forwarded ADDP ladders eleven stages deep on 12 stages: the
    single-CTA scan repeats once a level (no cap); the large route (683 x
    12 > ``WALK_SMEM_MAX``) stops at ``ROUND_CAP`` rounds and walks."""
    rng = np.random.default_rng(600 + n_rows)
    trace = _hold("staged", *_ladder(rng, "staged", 12, 64, n_rows, 12, 11),
                  f"staged ladder x {n_rows}")
    if n_rows * 12 > kw.WALK_SMEM_MAX:
        assert trace["route"] == "switch_walk" and trace["rounds"] == -CAP
    else:
        assert trace["route"] == "switch_walk_smem"
        assert trace["rounds"] > CAP


@pytest.mark.parametrize("mode", kw.MODES)
def test_walk_sort_bits_follow_the_key_range(mode):
    """In-range slots sort on bit_length(range) bits (staged on dense
    stage * R + reg keys); slots at both int32 ends need all 32 bits
    (affine), and a staged stream with stray regs keeps its 64-bit keys."""
    S_, R_ = 8, 4096
    rng = np.random.default_rng(700 + kw.MODES.index(mode))
    regs, op, st, rg, val, idx = walk_stream(rng, mode, 16, 16)
    regs = rng.integers(-9, 9, (S_, R_)).astype(np.int32)
    st, rg = rng.integers(0, S_, op.shape), rng.integers(0, R_, op.shape)
    op = np.where(op == NOP, READ, op)
    st, rg = st.astype(np.int32), rg.astype(np.int32)
    if mode == "affine":                    # ops on live slots only
        op[0, 0] = READ
    trace = _hold(mode, regs, op, st, rg, val, idx, f"{mode} in range")
    assert trace["bits"] <= (S_ * R_).bit_length() and not trace["wide"]
    if mode == "serial":
        return
    st[0, :2], rg[0, :2] = 0, (-2**31, 2**31 - 1)   # g at both int32 ends
    trace = _hold(mode, regs, op, st, rg, val, idx, f"{mode} full width")
    if mode == "affine":
        assert trace["bits"] == 32 and not trace["wide"]
    else:
        assert trace["wide"] and trace["bits"] > 32


@pytest.mark.parametrize("mode", kw.MODES)
def test_walk_int32_wraparound_and_negative_slot_collisions(mode):
    """Sums past +-2^31 on one hot slot; a negative slot whose write-back
    lands on a slot that has its own chain (the in-range chain wins) and
    on one that has none; reads past the file."""
    K = 4
    regs = np.arange(S * R, dtype=np.int32).reshape(S, R)
    regs[S - 1, R - 1] = 2**31 - 3
    n_slots = S * R
    rows = [
        # (op, stage, reg, val) x K
        [(ADD, S - 1, R - 1, 2**31 - 1), (ADD, S - 1, R - 1, 7),
         (READ, S - 1, R - 1, 0), (ADD, S - 1, R - 1, -2**31)],
        [(ADD, 0, -2, 5), (READ, 0, -2, 0), (ADD, 0, -3, 9),
         (WRITE, S - 1, R - 1, 11)],
        [(READ, 0, -n_slots - 5, 0), (ADD, S + 1, 0, 4),
         (READ, S + 1, 0, 0), (ADD, 1, -1, 6)],
    ]
    arr = np.array(rows, np.int64)
    op, st, rg, val = (arr[..., i].astype(np.int32) for i in range(4))
    if mode == "affine":
        op = np.where(op == CADD, READ, op).astype(np.int32)
    idx = np.arange(3 * K, dtype=np.int32)
    ref = walk_ref(mode, regs, op, st, rg, val, idx)
    t = lambda a: torch.from_numpy(np.array(a, np.int32))
    plain = kw.switch_walk_gather_call(mode, t(regs), t(op), t(st), t(rg),
                                       t(val), t(idx))
    _assert_same(ref, [x.numpy() for x in plain], f"{mode} plain")
    _assert_same(ref, _jax(mode, regs, op, st, rg, val, idx), f"{mode} JAX")


@pytest.mark.parametrize("mode", ["serial", "staged", "affine", "auto"])
def test_engine_dispatch_with_bucket_rows_matches_jax(mode):
    """Whole ``SwitchEngine.execute`` dispatches (NOP bucket rows, fused
    staging, the compaction gather) on streams with stray slots, against
    the JAX engine's, chained over several batches."""
    from repro.core.packets import empty_packets
    rng = np.random.default_rng(41 + len(mode))
    regs0 = rng.integers(-50, 100, (S, R)).astype(np.int32)
    je = jeng.SwitchEngine(CFG, regs0)
    te = teng.SwitchEngine(TSwitchConfig(S, R, CFG.max_instrs), regs0,
                           device="cpu")
    for B in (1, 3, 12):
        walk_mode = {"auto": ("serial", "staged", "affine")[B % 3]}.get(
            mode, mode)
        if walk_mode == "staged":          # forwards from earlier stages
            p = empty_packets(B, CFG)
            for b in range(B):
                stages = np.sort(rng.choice(S, CFG.max_instrs, replace=False))
                for k in range(CFG.max_instrs):
                    addp = k > 0 and rng.random() < 0.4
                    p["op"][b, k] = ADDP if addp else rng.choice(
                        [NOP, READ, WRITE, ADD])
                    p["operand"][b, k] = (rng.integers(0, k) if addp else
                                          rng.integers(-50, 50))
                    p["stage"][b, k] = stages[k]
                    p["reg"][b, k] = rng.choice([-2, -1, 3, R + 1, R - 1])
        else:
            _, op, st, rg, val, _ = walk_stream(rng, walk_mode, B,
                                                CFG.max_instrs)
            p = empty_packets(B, CFG)
            p["op"], p["stage"], p["reg"], p["operand"] = op, st, rg, val
        r1, ok1, g1 = je.execute(p, mode=mode)
        r2, ok2, g2 = te.execute(p, mode=mode)
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(np.asarray(ok1, bool), ok2)
        np.testing.assert_array_equal(g1, g2)
        np.testing.assert_array_equal(je.read_all(), te.read_all())


def test_walk_launcher_checks_and_rounds_on_the_cpu():
    """What the launcher's fast path does not take gets the precise
    checks (and raises); on the CPU the plain versions take no rounds."""
    t = lambda a: torch.from_numpy(np.array(a, np.int32))
    regs = t(np.zeros((S, R)))
    op, z = t(np.ones((2, 4))), t(np.zeros((2, 4)))
    out = kw.switch_walk_gather_call("serial", regs, op, z, z, z, None,
                                     rounds=True)
    assert len(out) == 5 and out[3] is None and out[4].tolist() == [0]
    with pytest.raises(ValueError, match="unknown engine mode"):
        kw.switch_walk_gather_call("pallas", regs, op, z, z, z)
    with pytest.raises(TypeError, match="int32"):
        kw.switch_walk_gather_call("affine", regs, op.long(), z, z, z)
    with pytest.raises(ValueError, match="shape"):
        kw.switch_walk_gather_call("affine", regs, op, z[:1], z, z)
    with pytest.raises(ValueError, match="contiguous"):
        kw.switch_walk_gather_call("affine", regs, op, z, z,
                                   t(np.zeros((4, 2))).t())
