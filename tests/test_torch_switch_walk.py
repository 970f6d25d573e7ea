"""The switch-engine walk kernel's algorithm, held against the plain
versions and the JAX package's compiled engines.

``walk_ref`` transcribes ``csrc/switch_engine.cu`` (``src/repro_torch/
kernels/switch_engine``) step by step in numpy: the per-mode key, seed,
opcode and flag rule with int32 wraparound, the tile chosen by N and its
sentinel padding (or the large route's untiled arrays past
``WALK_SMEM_MAX``), the stable sort over the mode's key bits, the serial
entries found by binary search, the one-thread walk (serial in stream
order, affine and staged over the sorted runs), the two-phase write-back
from the run heads and the compaction gather.  The CUDA kernels run only
on the card, where ``chip_smoke.py`` phase 21 holds them against the plain
versions; here the transcription must equal the plain versions and the
JAX engines exactly (registers, res, ok, compact) on streams with every
opcode each mode takes, out-of-range and negative slots, slots that wrap
int32 and sums past +-2^31."""
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
SIGN = 1 << 31
MASK32 = (1 << 32) - 1
S, R = CFG.n_stages, CFG.regs_per_stage
# (N, B, K) of each case: N = B * K
SHAPES = {1: (1, 1), 16: (1, 16), 4096: (256, 16), 8192: (512, 16),
          8193: (2731, 3)}
_JIT = {m: jax.jit(jeng._ENGINE_IMPLS[m]) for m in kw.MODES}


def _wrap(x):
    """int64 -> int32 value with two's-complement wraparound, as int64."""
    return ((np.asarray(x, np.int64) + SIGN) & MASK32) - SIGN


def _prep(mode, n_slots, K, op, st, rg, v):
    """Step 1: key (uint64), seed (-1: none), opcode class, write-enable
    and forward flags, operand (an ADDP's source position)."""
    n = op.shape[0]
    code = np.where((op >= NOP) & (op <= ADDP), op, READ)
    g = _wrap(st.astype(np.int64) * (n_slots // S) + rg)
    pos = np.arange(n)
    src = pos - pos % K + np.clip(v, 0, K - 1)
    wen = np.zeros(n, bool)
    fwd = np.zeros(n, bool)
    vq = v.astype(np.int64)
    if mode == "serial":
        live = code != NOP
        a = np.where(g < 0, g + n_slots, g)
        slot = np.clip(a, 0, n_slots - 1)
        key = np.where(live, slot, n_slots)
        seed = np.where(live, slot, -1)
        wen = live & (a >= 0) & (a < n_slots)
        vq = np.where(code == ADDP, src, vq)
    elif mode == "affine":
        code = np.where(np.isin(code, (NOP, WRITE, ADD)), code, READ)
        nop = code == NOP
        key = np.where(nop, (n_slots & MASK32) ^ SIGN, (g & MASK32) ^ SIGN)
        seed = np.where(nop, n_slots - 1, np.clip(
            np.where(g < 0, g + n_slots, g), 0, n_slots - 1))
    else:                                            # staged
        R_ = n_slots // S
        active = (code != NOP) & (st >= 0) & (st < S)
        code = np.where(active, np.where(np.isin(code, (WRITE, ADD, ADDP)),
                                         code, READ), NOP)
        key = np.where(active, (st.astype(np.int64) << 32)
                       | ((rg.astype(np.int64) & MASK32) ^ SIGN), S << 32)
        seed = np.where(active, st.astype(np.int64) * R_ + np.clip(
            np.where(rg < 0, rg.astype(np.int64) + R_, rg), 0, R_ - 1), -1)
        addp = code == ADDP
        fwd = addp & (st[src] >= 0) & (st[src] < st)
        vq = np.where(addp, src, vq)
    return key.astype(np.uint64), seed, code, wen, fwd, vq


def _sentinel(mode, n_slots):
    return {"serial": n_slots, "affine": (n_slots & MASK32) ^ SIGN,
            "staged": S << 32}[mode]


def _writeback_slot(mode, key, phase, n_slots):
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


def walk_ref(mode, regs, op, stage, reg, val, idx):
    """numpy transcription of one dispatch.  regs: [S, R]; op/stage/reg/
    val: [B, K]; idx: [M].  Returns (regs after, res [B, K] int32, ok
    [B, K] bool, compact [M] int32)."""
    regs = np.array(regs, np.int64).reshape(-1)
    n_slots = regs.shape[0]
    B, K = op.shape
    n = B * K
    flat = lambda a: np.asarray(a, np.int64).reshape(-1)
    key, seed, code, wen, fwd, vq = _prep(mode, n_slots, K, flat(op),
                                          flat(stage), flat(reg), flat(val))
    # the tile and its pads (the large route has none)
    tile = next((t * i for t, i in TILES if t * i >= n), n)
    pad = tile - n
    key = np.concatenate([key, np.full(pad, _sentinel(mode, n_slots),
                                       np.uint64)])
    seed = np.concatenate([seed, np.full(pad, -1)])
    code = np.concatenate([code, np.zeros(pad, np.int64)])
    end_bit = {"serial": int(n_slots).bit_length(), "affine": 32,
               "staged": 32 + S.bit_length()}[mode]
    assert int(key.max()) < 1 << end_bit          # the sort's key bits
    cur = np.where(seed >= 0, regs[np.maximum(seed, 0)], 0)
    spos = np.argsort(key, kind="stable")
    skey = key[spos]
    res = np.zeros(tile, np.int64)
    ok = np.ones(tile, bool)
    if mode == "serial":
        ent = np.empty(tile, np.int64)
        ent[spos] = spos[np.searchsorted(skey, skey, side="left")]
        for p in range(n):
            c_ = code[p]
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
    else:
        head, chain, c = -1, None, 0
        for j in range(tile):
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
        if head >= 0:
            cur[head] = c
    for phase in ((1,) if mode == "serial" else (0, 1)):
        for j in range(tile):
            if spos[j] >= n or (j > 0 and skey[j - 1] == skey[j]):
                continue
            t = _writeback_slot(mode, skey[j], phase, n_slots)
            if t >= 0:
                regs[t] = cur[spos[j]]
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


def _case(mode, n, seed):
    B, K = SHAPES[n]
    rng = np.random.default_rng(seed)
    regs, op, st, rg, val, idx = walk_stream(rng, mode, B, K)
    ref = walk_ref(mode, regs, op, st, rg, val, idx)
    t = lambda a: torch.from_numpy(np.array(a, np.int32))
    plain = kw.switch_walk_gather_call(mode, t(regs), t(op), t(st), t(rg),
                                       t(val), t(idx))
    _assert_same(ref, [x.numpy() for x in plain], f"{mode} N={n} plain")
    _assert_same(ref, _jax(mode, regs, op, st, rg, val, idx),
                 f"{mode} N={n} JAX")


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
