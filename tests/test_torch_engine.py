"""The port's SwitchEngine against the JAX package's, mode by mode, on the
random batches of tests/test_engine.py: results, ok flags, registers,
GIDs and dispatch counts must agree exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as jeng  # noqa: E402
from repro.core.packets import (ADDP, CADD, NOP,  # noqa: E402
                                empty_packets)
from repro_torch.convert import convert_state  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.packets import ReadPacket  # noqa: E402
from repro_torch.core.packets import SwitchConfig as TSwitchConfig  # noqa: E402,E501
from test_engine import CFG, random_batch, staged_addp_batch  # noqa: E402

TCFG = TSwitchConfig(n_stages=CFG.n_stages, regs_per_stage=CFG.regs_per_stage,
                     max_instrs=CFG.max_instrs)


def _pair(regs0):
    return (jeng.SwitchEngine(CFG, regs0),
            teng.SwitchEngine(TCFG, regs0, device="cpu"))


def _run_both(je, te, p, mode):
    r1, ok1, g1 = je.execute(p, mode=mode)
    r2, ok2, g2 = te.execute(p, mode=mode)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(np.asarray(ok1, bool), ok2)
    np.testing.assert_array_equal(g1, g2)
    np.testing.assert_array_equal(je.read_all(), te.read_all())
    assert je.next_gid == te.next_gid
    assert je.dispatch_count == te.dispatch_count


_BATCHES = {
    "affine": lambda rng, B: random_batch(rng, B, 5),
    "serial": lambda rng, B: random_batch(rng, B, 5, ops=(0, 1, 2, 3, 4, 5)),
    "staged": lambda rng, B: staged_addp_batch(rng, B),
    "pallas": lambda rng, B: random_batch(rng, B, 5, ops=(0, 1, 2, 3, 4)),
    "auto": lambda rng, B: (random_batch(rng, B, 5) if B % 3 == 0 else
                            staged_addp_batch(rng, B) if B % 3 == 1 else
                            random_batch(rng, B, 5, ops=(0, 1, 2, 3, 4))),
}


@pytest.mark.parametrize("mode", ["serial", "affine", "staged", "pallas",
                                  "auto"])
def test_engine_modes_match_jax(mode):
    """Several batches per engine pair (power-of-two buckets, chained
    register state), every mode, against the JAX engine."""
    rng = np.random.default_rng(sum(map(ord, mode)))
    je, te = _pair(rng.integers(-50, 100, (CFG.n_stages,
                                           CFG.regs_per_stage)))
    for B in (1, 3, 17, 33, 64):
        _run_both(je, te, _BATCHES[mode](rng, B), mode)


def test_engine_int32_wraparound_matches_jax():
    """ADD chains past 2**31 wrap identically in the affine cumsum and the
    serial loop."""
    rng = np.random.default_rng(2)
    regs0 = np.full((CFG.n_stages, CFG.regs_per_stage), 2**31 - 3)
    for mode in ("affine", "serial", "pallas"):
        je, te = _pair(regs0)
        p = random_batch(rng, 16, 5)
        p["operand"] = rng.choice([2**30, 2**31 - 1, -2**31, 5],
                                  (16, 5)).astype(np.int32)
        _run_both(je, te, p, mode)


def test_serial_out_of_range_slots_match_jax():
    """The serial engine reads a slot past the file clamped into it and
    drops its write, chained through ADDP and CADD, like the JAX serial
    engine (negative slots are a deliberate difference: the port clamps
    them to 0); slots the stream never names keep their values."""
    rng = np.random.default_rng(6)
    regs0 = rng.integers(-50, 100, (CFG.n_stages, CFG.regs_per_stage))
    je, te = _pair(regs0)
    for B in (4, 9):
        p = random_batch(rng, B, 5, ops=(0, 1, 2, 3, 4, 5))
        far = rng.random((B, 5)) < 0.3
        p["stage"][far] = CFG.n_stages + 2
        p["reg"][far[::-1]] = CFG.regs_per_stage + 3
        _run_both(je, te, p, "serial")
    te2 = teng.SwitchEngine(TCFG, regs0, device="cpu")
    p = empty_packets(1, CFG)
    p["op"][0, :2] = [2, 3]                                # WRITE, ADD
    p["stage"][0, :2] = [1, 1]
    p["reg"][0, :2] = [4, 4]
    p["operand"][0, :2] = [7, 5]
    assert te2.execute(p, mode="serial")[0][0, :2].tolist() == [7, 12]
    want = regs0.copy()
    want[1, 4] = 12
    np.testing.assert_array_equal(te2.read_all(), want)


@pytest.mark.parametrize("mode,ops", [
    ("affine", (NOP, CADD)), ("affine", (NOP, ADDP)),
    ("staged", (NOP, CADD)), ("pallas", (NOP, ADDP)), ("bogus", (NOP,)),
])
def test_invalid_modes_raise_like_jax(mode, ops):
    rng = np.random.default_rng(0)
    p = random_batch(rng, 4, 5, ops=ops)
    p["op"][0, 0] = ops[-1]
    errs = []
    for e in _pair(None):
        with pytest.raises(ValueError) as ei:
            e.execute(p, mode=mode)
        errs.append(str(ei.value))
    assert errs[0] == errs[1]
    flags = [(True, False, False), (False, True, True)]
    for f in flags:
        for m in ("staged", "pallas", "affine", "serial", "auto"):
            try:
                want = jeng.SwitchEngine._resolve_mode(m, *f)
            except ValueError as ex:
                with pytest.raises(ValueError, match=str(ex)):
                    teng.SwitchEngine._resolve_mode(m, *f)
            else:
                assert teng.SwitchEngine._resolve_mode(m, *f) == want


def test_execute_reads_pallas_matches_jax():
    from repro.core.packets import ReadPacket as JReadPacket
    rng = np.random.default_rng(4)
    je, te = _pair(rng.integers(-50, 100, (CFG.n_stages,
                                           CFG.regs_per_stage)))
    _run_both(je, te, random_batch(rng, 20, 5), "pallas")
    for n in (1, 5, 37):
        sw = np.zeros(n, np.int32)
        st = rng.integers(0, CFG.n_stages, n).astype(np.int32)
        rg = rng.integers(0, CFG.regs_per_stage, n).astype(np.int32)
        for mode in ("pallas", "auto"):
            v1 = je.execute_reads(JReadPacket(sw, st, rg), mode=mode)
            v2 = te.execute_reads(ReadPacket(sw, st, rg), mode=mode)
            np.testing.assert_array_equal(v1.values_np(), v2.values_np())
    assert je.read_dispatch_count == te.read_dispatch_count


def test_register_copies_never_alias():
    """Registers are updated in place, so everything handed in or out is a
    copy: inputs, read_all, snapshots."""
    rng = np.random.default_rng(1)
    regs0 = rng.integers(0, 50, (CFG.n_stages, CFG.regs_per_stage))
    src = regs0.astype(np.int32)
    e = teng.SwitchEngine(TCFG, src, device="cpu")
    src[:] = -7
    first = e.read_all()
    snap = e.snapshot()
    e.execute(random_batch(rng, 16, 5), mode="pallas")
    np.testing.assert_array_equal(first, regs0)
    np.testing.assert_array_equal(snap[0], regs0)
    e.restore(snap)
    e.execute(random_batch(rng, 16, 5), mode="affine")
    np.testing.assert_array_equal(snap[0], regs0)
    t = torch.zeros((CFG.n_stages, CFG.regs_per_stage), dtype=torch.int32)
    e.load_registers(t)
    e.execute(random_batch(rng, 8, 5), mode="serial")
    assert int(t.abs().sum()) == 0


def test_empty_batch_scan_and_sharded_engine():
    e = teng.SwitchEngine(TCFG, device="cpu")
    res, ok, gids = e.execute_batch(empty_packets(0, CFG))
    assert isinstance(res, np.ndarray) and res.shape == (0, 5)
    assert len(gids) == 0 and e.dispatch_count == 0
    e.load_registers(np.arange(CFG.n_stages * CFG.regs_per_stage,
                               dtype=np.int32).reshape(CFG.n_stages, -1))
    R = CFG.regs_per_stage
    rp = ReadPacket(np.zeros(3, np.int32), np.array([0, 1, 1], np.int32),
                    np.array([2, 0, 5], np.int32))
    vals, pos, agg = e.execute_scan(rp, 0, R, cap=4)
    assert vals.tolist() == [2, R, 0, 0] and pos.tolist() == [0, 1, -1, -1]
    assert agg.tolist() == [2, 2 + R, 2, R]
    vals, pos, count = e.execute_scan(rp, 0, 10 ** 6, k=2)
    assert vals.tolist() == [R + 5, R] and pos.tolist() == [2, 1]
    assert count == 3 and e.read_dispatch_count == 2
    with pytest.raises(ValueError, match="exactly one"):
        e.execute_scan(rp, 0, 1)
    from dataclasses import replace
    sh = teng.ShardedSwitchEngine(replace(TCFG, n_switches=2), device="cpu")
    assert [p.registers.device.type for p in sh.planes] == ["cpu", "cpu"]
    assert sh.read_all().shape == (2, CFG.n_stages, R)


@pytest.mark.parametrize("make", [
    lambda: teng.SwitchEngine(TCFG).registers,
    lambda: teng.init_registers(TCFG),
    lambda: convert_state(np.zeros((2, 4), np.int32), {}, [{}])[0],
], ids=["SwitchEngine", "init_registers", "convert_state"])
def test_default_device_is_cuda_and_never_falls_back(make):
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
