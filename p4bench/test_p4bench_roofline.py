"""The kernels' yardstick: byte counts on hand-worked packets, the table
of peaks, and the readers of the kernel layer on hand-made evidence."""
import numpy as np
import pytest

from p4bench import harness
from p4bench.traffic.stream import ADD, NOP, READ, WRITE

H100 = "NVIDIA H100 80GB HBM3"


def _rec(**kw):
    rec = dict(routes=["switch_walk_smem.affine"],
               op=np.array([[READ, WRITE, ADD, NOP]], np.int32),
               stage=np.array([[0, 0, 1, 0]], np.int32),
               reg=np.array([[5, 5, 7, 0]], np.int32),
               regs_per_stage=100, answers=2)
    rec.update(kw)
    return rec


def test_walk_bytes_by_hand():
    # 3 live instructions x 16 B; slots 5 and 107 read (2 x 4 B) and both
    # written (2 x 4 B); 2 answers x 4 B
    assert harness.roofline_bytes("switch_walk_smem", _rec()) == 72
    # a read-only packet writes no register
    reads = _rec(op=np.array([[READ, READ, NOP, NOP]], np.int32), answers=2)
    # both read slot 5: 2 x 16 B, one slot read, 2 answers
    assert harness.roofline_bytes("switch_walk_smem", reads) == 32 + 4 + 8
    # two rows on one slot: the slot is read and written once
    two = _rec(op=np.array([[ADD], [ADD]], np.int32),
               stage=np.array([[2], [2]], np.int32),
               reg=np.array([[3], [3]], np.int32), answers=2)
    assert harness.roofline_bytes("switch_walk_smem", two) == 32 + 4 + 4 + 8


def test_peaks_table():
    assert harness.peak(H100, "hbm_bytes_per_s") == 3.35e12
    assert harness.peak("some other card", "hbm_bytes_per_s") is None


def _ev(rows, records, wall=2.0):
    return dict(profile=dict(rows=rows, records=records, wall_s=wall,
                             busy_s=sum(t for t, _, _ in rows) * 1e-6),
                device_kind=H100)


def test_kernel_readers():
    name = "void (anonymous namespace)::switch_walk_smem_kernel<2, 32, 1>"
    rows = [(20.0, name, 2), (6.0, "Memcpy HtoD (Pinned -> Device)", 2)]
    ev = _ev(rows, [_rec(), _rec()])
    assert harness.read_metric("kernel_us", ev) == 10.0
    share = harness.read_metric("switch_walk_smem_roofline", ev)
    assert share == pytest.approx(100 * 144 / 3.35e12 / 20e-6)
    assert harness.read_metric("device_idle_pct", ev) == pytest.approx(
        100 * (1 - 26e-6 / 2.0))
    # a window whose launches the profiler did not all see reads nothing
    assert harness.read_metric("switch_walk_smem_roofline",
                               _ev(rows, [_rec()] * 3)) is None
    none = dict(profile=None, device_kind=H100)
    for m in ("kernel_us", "switch_walk_smem_roofline", "device_idle_pct"):
        assert harness.read_metric(m, none) is None
