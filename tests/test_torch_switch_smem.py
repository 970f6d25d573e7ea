"""The single-CTA switch_txn kernel's algorithm, held against the JAX
package's ``switch_exec`` + ``gather_results`` (Pallas, interpret mode on
the CPU).

``smem_ref`` transcribes ``switch_txn_smem_kernel`` (``src/repro_torch/
kernels/switch_txn/csrc/switch_txn.cu``) phase by phase in numpy: the key
rule with int32 wraparound, the tile chosen by N and its NOP padding, the
stable 4-bit LSD radix sort over bit_length(n_slots) bits, the segment
walk from each segment's head, and the epilogue gather with both clamps.
The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds it against the plain versions; here the transcription and the
port's CPU path (``ops.switch_exec_gather``) must both equal JAX exactly
in registers, res, ok and compact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import engine as jeng  # noqa: E402
from repro.core.hotset import build_hot_index as j_build_hot_index  # noqa: E402,E501
from repro.core.packets import PacketStager, SwitchConfig  # noqa: E402
from repro.core.packets import build_packets as j_build_packets  # noqa: E402
from repro.core.packets import result_plane  # noqa: E402
from repro.kernels.switch_txn import ops as jops  # noqa: E402
from repro.workloads import ycsb as jycsb  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.kernels.switch_txn import ops as tops  # noqa: E402
from repro_torch.kernels.switch_txn import switch_txn as tk  # noqa: E402

NOP, READ, WRITE, ADD, CADD, OTHER = 0, 1, 2, 3, 4, 5
TILES = ((256, 1), (256, 4), (512, 8), (512, 16))   # threads x items


def smem_ref(regs, op, stage, reg, val, R, idx):
    """numpy transcription of the single-CTA kernel.  regs: [n_slots];
    op/stage/reg/val: [N], 1 <= N <= SMEM_MAX_N; idx: [M].  Returns (regs
    after, res [N] int32, ok [N] bool, compact [M] int32)."""
    regs = np.array(regs, np.int32).reshape(-1)
    n_slots, n = regs.shape[0], len(op)
    assert 1 <= n <= tk.SMEM_MAX_N
    tile = next(t * i for t, i in TILES if t * i >= n)
    pad = lambda a: np.concatenate([np.asarray(a, np.int32),
                                    np.zeros(tile - n, np.int32)])
    o, st, rg, v = pad(op), pad(stage), pad(reg), pad(val)   # pad: NOPs
    # 1. load: key = slot clamped into the file, n_slots for a NOP
    g = (st.astype(np.uint32) * np.uint32(R)
         + rg.astype(np.uint32)).astype(np.int32)             # wraps
    slot = np.clip(g, 0, n_slots - 1)
    key = np.where(o == NOP, n_slots, slot).astype(np.uint32)
    code = np.where(o.astype(np.uint32) <= CADD, o, OTHER)
    cur = np.where(o == NOP, 0, regs[slot])
    # 2. stable LSD radix sort, 4-bit digits; positions enter in stream
    # order (the blocked arrangement), so equal keys keep it
    end_bit = int(n_slots).bit_length()
    spos = np.arange(tile)
    for bit in range(0, end_bit, 4):
        mask = (1 << min(4, end_bit - bit)) - 1
        spos = spos[np.argsort((key[spos] >> bit) & mask, kind="stable")]
    skey = key[spos]
    # 3. sorted copies of opcode and operand
    sop, sval = code[spos], v[spos]
    # 4. walk: each segment head applies its segment in stream order
    res = np.zeros(tile, np.int32)
    ok = np.ones(tile, bool)
    for j0 in range(tile):
        s = int(skey[j0])
        if s >= n_slots or (j0 > 0 and skey[j0 - 1] == s):
            continue                           # NOP, padding, or not a head
        c = int(cur[spos[j0]])
        j = j0
        while j < tile and skey[j] == s:
            oj, vj, p = int(sop[j]), int(sval[j]), spos[j]
            post = ((c + vj + 2**31) & 0xFFFFFFFF) - 2**31
            nxt = (vj if oj == WRITE else
                   post if oj == ADD or (oj == CADD and post >= 0) else c)
            res[p] = c if oj == READ else nxt
            ok[p] = not (oj == CADD and post < 0)
            c = nxt
            j += 1
        regs[s] = c
    # 5. epilogue: the compacted gather, clamped from both sides
    compact = res[np.clip(np.asarray(idx, np.int64), 0, n - 1)]
    return regs, res[:n], ok[:n], compact


def _jax(regs, op, stage, reg, val, idx):
    j = lambda a: jnp.asarray(a, jnp.int32)
    r, res, ok = jops.switch_exec(j(regs), j(op), j(stage), j(reg), j(val))
    compact = jops.gather_results(res, j(idx))
    return tuple(np.asarray(x) for x in (r, res, ok, compact))


def _all_three(regs, op, stage, reg, val, idx, transcribe=True):
    """JAX, the port's CPU path and (N <= SMEM_MAX_N) the transcription
    on one [B, K] stream; asserts exact equality and returns JAX's."""
    want = _jax(regs, op, stage, reg, val, idx)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32)
    tregs = t(regs)
    got = tops.switch_exec_gather(tregs, t(op), t(stage), t(reg), t(val),
                                  t(idx))
    assert got[0].data_ptr() == tregs.data_ptr()       # updated in place
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.bool
    outs = [tuple(x.numpy() for x in got)]
    if transcribe:
        S, R = np.shape(regs)
        r, res, ok, compact = smem_ref(regs, np.ravel(op), np.ravel(stage),
                                       np.ravel(reg), np.ravel(val), R, idx)
        outs.append((r.reshape(S, R), res.reshape(np.shape(op)),
                     ok.reshape(np.shape(op)), compact))
    for out in outs:
        for name, a, b in zip(("registers", "res", "ok", "compact"), want,
                              out):
            np.testing.assert_array_equal(a, b, err_msg=name)
    return want


def _stream(rng, S, R, B, K, *, skew=0.0, edges=False, clamp=0):
    """A [B, K] stream with all five opcodes (NOPs included) over an
    [S, R] file; ``skew`` of it on three hot slots, int32 edge registers
    and operands with ``edges``, ``clamp`` slots past the file's end."""
    regs = rng.integers(-200, 200, (S, R))
    op = rng.integers(0, 5, (B, K))
    stage = rng.integers(0, S, (B, K))
    reg = rng.integers(0, R, (B, K))
    val = rng.integers(-60, 60, (B, K))
    hot = rng.random((B, K)) < skew
    pick = rng.integers(0, 3, (B, K))
    stage = np.where(hot, np.array([0, S // 2, S - 1])[pick], stage)
    reg = np.where(hot, np.array([1, R // 3, R - 1])[pick], reg)
    if edges:
        regs.reshape(-1)[rng.integers(0, S * R, 8)] = [2**31 - 1, 2**31 - 9,
                                                       -2**31, -2**31 + 4,
                                                       0, -1, 2**30, 5]
        e = rng.random((B, K)) < 0.2
        val = np.where(e, rng.choice([2**31 - 1, -2**31, 2**30, -7], (B, K)),
                       val)
    flat = stage.reshape(-1)
    flat[rng.integers(0, B * K, clamp)] = S + 3               # past the end
    idx = rng.integers(0, B * K + 5, max(1, B * K // 2))      # some past end
    return regs, op, stage, reg, val, idx


@pytest.mark.parametrize("S,R,B,K,skew,edges,clamp", [
    (4, 16, 16, 4, 0.0, False, 0),       # uniform
    (8, 64, 64, 8, 0.5, False, 0),       # hot skew: long segments
    (4, 8, 32, 4, 0.0, True, 0),         # int32 edges
    (6, 32, 37, 5, 0.3, True, 6),        # ragged, clamped slots
    (24, 256, 256, 16, 0.5, True, 20),   # the main path's B x K
])
def test_smem_algorithm_matches_jax(S, R, B, K, skew, edges, clamp):
    rng = np.random.default_rng(S * 1000 + B + clamp)
    regs, op, stage, reg, val, idx = _stream(rng, S, R, B, K, skew=skew,
                                             edges=edges, clamp=clamp)
    r, res, ok, _ = _all_three(regs, op, stage, reg, val, idx)
    assert (op == NOP).any()
    if skew:
        assert not ok.all()                   # some CADDs were refused
    if edges:                                 # edge values reached res
        assert (np.abs(res.astype(np.int64)) >= 2**30).any()


def test_smem_wrapped_slot_matches_jax():
    """stage * R overflows int32 and wraps back into the file: the key
    rule must wrap exactly as JAX's int32 arithmetic does."""
    rng = np.random.default_rng(3)
    S, R, B, K = 4, 64, 32, 4
    regs, op, stage, reg, val, idx = _stream(rng, S, R, B, K)
    wrap = rng.random((B, K)) < 0.4
    stage = np.where(wrap, stage + 2**26, stage)      # 2**26 * 64 = 2**32
    _all_three(regs, op, stage, reg, val, idx)


def test_smem_negative_slots_clamp_to_zero():
    """A slot that wraps negative clamps to 0 in the kernel (the port
    clamps from below too; the TPU kernel only from above, so this is
    held against the port's serial loop, not JAX)."""
    rng = np.random.default_rng(4)
    S, R, B, K = 4, 64, 16, 4
    regs, op, stage, reg, val, idx = _stream(rng, S, R, B, K)
    stage[rng.random((B, K)) < 0.3] = 2**25 + 2**24   # * 64 wraps negative
    g = (stage.astype(np.int64) * R + reg)
    g = ((g + 2**31) % 2**32) - 2**31
    assert (g < 0).any()
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32)
    want_r, want_res, want_ok = tk.switch_txn_plain(
        t(regs).reshape(-1), t(op).reshape(-1),
        t(np.clip(g, 0, S * R - 1)).reshape(-1), t(val).reshape(-1))
    got = smem_ref(regs, op.ravel(), stage.ravel(), reg.ravel(), val.ravel(),
                   R, idx)
    cpu = tops.switch_exec_gather(t(regs), t(op), t(stage), t(reg), t(val),
                                  t(idx))
    for a, b in ((want_r, got[0]), (want_res, got[1]),
                 (want_ok.bool(), got[2])):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(cpu[0].reshape(-1).numpy(), got[0])
    np.testing.assert_array_equal(cpu[1].reshape(-1).numpy(), got[1])
    np.testing.assert_array_equal(cpu[3].numpy(), got[3])


@pytest.mark.parametrize("B,K", [
    (1, 1),            # N = 1
    (37, 5),           # N = 185, not a power of two
    (16, 16),          # N = 256, the smallest tile exactly
    (257, 1),          # N = 257, the next tile
    (341, 3),          # N = 1,023
    (1025, 1),         # N = 1,025
    (4097, 1),         # N = 4,097
    (512, 16),         # N = SMEM_MAX_N
    (2731, 3),         # N = SMEM_MAX_N + 1: the large-N path
])
def test_smem_sizes_and_route(B, K, monkeypatch):
    """Every tile boundary up to SMEM_MAX_N through the transcription,
    and SMEM_MAX_N + 1 through the large-N wrapper route (switch_txn_call
    then result_gather_call), all equal to JAX."""
    n = B * K
    calls = []
    large = tk.switch_txn_call
    monkeypatch.setattr(tk, "switch_txn_call",
                        lambda *a: calls.append(1) or large(*a))
    rng = np.random.default_rng(n)
    regs, op, stage, reg, val, idx = _stream(rng, 8, 128, B, K, skew=0.3,
                                             edges=True, clamp=3)
    _all_three(regs, op, stage, reg, val, idx,
               transcribe=n <= tk.SMEM_MAX_N)
    assert len(calls) == (n > tk.SMEM_MAX_N)
    if n == tk.SMEM_MAX_N + 1:
        with pytest.raises(AssertionError):
            smem_ref(regs, op.ravel(), stage.ravel(), reg.ravel(),
                     val.ravel(), 128, idx)


def test_run_fused_pallas_matches_jax_on_a_ycsb_group():
    """engine._run_fused in pallas mode on one YCSB-A hot group, staged
    exactly as execute_batch stages it, against the JAX engine's pallas
    dispatch of the same group (registers, res, ok, compact)."""
    cfg = SwitchConfig(n_stages=8, regs_per_stage=64, max_instrs=16)
    p = jycsb.YCSBParams(n_nodes=4, keys_per_node=2000, hot_per_node=16)
    rng = np.random.default_rng(14)
    hi = j_build_hot_index(jycsb.traces(jycsb.generate(rng, 2000, p)),
                           top_k=64, switch=cfg)
    txns = [t for t in jycsb.generate(rng, 600, p)
            if all(hi.is_hot(k) for _, k, _ in t.ops)][:200]
    pkts, meta = j_build_packets(txns, hi, cfg)
    B, K = pkts["op"].shape
    assert B == len(txns) and B > 100
    regs = rng.integers(-1000, 1000, (cfg.n_stages, cfg.regs_per_stage))
    je = jeng.SwitchEngine(cfg, regs)
    pb = je.execute_batch(pkts, meta, mode="pallas")
    _, idx = result_plane(pkts)
    Bp = jeng._bucket(B)
    Mp = min(jeng._bucket(max(len(idx), 1)), Bp * K)
    staged = PacketStager().stage(pkts, idx, Bp, Mp)
    tregs = torch.tensor(regs, dtype=torch.int32)
    got = teng._run_fused("pallas", tregs, torch.from_numpy(staged.copy()),
                          Mp)
    assert got[0].data_ptr() == tregs.data_ptr()
    want = (je.read_all(), pb.res, pb.ok, pb.compact)
    for name, a, b in zip(("registers", "res", "ok", "compact"), want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)
    assert len(idx) > 0 and (np.asarray(pb.compact) != 0).any()


def test_no_launch_and_plain_route_on_cpu():
    """CPU tensors take the plain versions and launch nothing; without
    idx there is no compact; N = 0 returns empty planes."""
    before = dict(tk.LAUNCHES)
    regs = torch.zeros(8, dtype=torch.int32)
    one = torch.ones(4, dtype=torch.int32)
    zero = torch.zeros(4, dtype=torch.int32)
    _, res, ok, compact = tk.switch_txn_gather_call(
        regs, one * 3, zero, torch.arange(4, dtype=torch.int32), one, 4)
    assert compact is None and ok.dtype == torch.bool and bool(ok.all())
    assert regs.tolist() == [1, 1, 1, 1, 0, 0, 0, 0] and res.tolist() == [1] * 4
    e = torch.zeros(0, dtype=torch.int32)
    out = tk.switch_txn_gather_call(regs, e, e, e, e, 4, e)
    assert [t.numel() for t in out[1:]] == [0, 0, 0]
    with pytest.raises(ValueError):
        tk.switch_txn_gather_call(regs, e, e, e, e, 4, one)   # src is empty
    assert tk.LAUNCHES == before
