"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each one exits non-zero on failure):

1. device   — the card's name and power limit;
2. build    — compile every kernel library from ``src/repro_torch`` (one
              nvcc per source, all started together);
3. kernels  — each kernel against its plain PyTorch version on the card at
              the hot path's shapes, timed with CUDA events: the
              single-CTA switch_txn (with its gather) on the skewed check
              stream at every tile, a ragged N on unaligned views and
              N = SMEM_MAX_N, the large-N path at 2 x SMEM_MAX_N; the
              lean result_gather launcher against torch.take in turns,
              and with each piece of its host path removed; the fused
              scan_prune (gather, filter and compaction into one packed
              buffer) over the whole 24 x 65536 register file at several
              selectivities and caps, and at every tile boundary up to
              and past SCAN_SMEM_MAX with stray slots; moe_route at the
              reference test shapes, edge streams and the serving path's
              shapes, and the one-launch routing plan (moe_plan) on the
              same streams unsorted and its own edges, beside the
              parent's route chain and torch.argsort;
4. main     — P4DB's hot-transaction path at full width: an 8-node YCSB-A
              cluster on a 24 x 65536 switch register file in ``pallas``
              mode, 8 ``run_batch`` calls of 256 txns (every hot group one
              single-CTA launch), held against the same txns through a
              CPU port cluster, then crash recovery;
5. reads    — the read tier on that cluster: ``read_batch`` over 8 x 256
              YCSB-C txns and ``Cluster.scan`` over its hot keys, against
              the CPU port cluster;
6. scan     — a 4096-hot-key scan cluster (values 3i + 7): a selectivity
              sweep and ``limit`` scans against the CPU port cluster and
              a host filter, with the shipped-row bound;
7. sharded  — the scan cluster and 2 x 256 YCSB-A txns at
              ``n_switches=2`` against ``n_switches=1``;
8. async    — ``read_batch`` on an ``async_hot`` cluster with undrained
              groups in flight, against the CPU port;
9. cadd     — SmallBank without ADDP (CADD constraints) on the card in
              ``pallas`` mode and in ``auto`` mode (the serial engine),
              against the CPU port;
10. profile — one more YCSB batch under ``torch.profiler`` for the device's
              busy share; one hot dispatch alone, which must be one
              device kernel, the single-CTA switch_txn; one pruned
              ``Cluster.scan``, which must be one device kernel (the
              single-CTA scan_prune) and one device -> host copy;
11. serve   — the model zoo's MoE serving path at full width:
              ``qwen3_moe_235b_a22b`` cut to 4 layers, bf16, random
              parameters from a seeded generator, 8 requests x 256
              prompt tokens x 16 generated through ``generate`` (one
              moe_plan launch per MoE layer per forward); checks
              moe_route and the routing plan on every layer's real
              stream, the plan's invariants, and teacher-forced decode
              against the full forward with nothing dropped (bf16 on
              every (row, position) pair whose experts match in both
              runs, float32 on all); profiles prefill and one decode
              step;
12. chain   — the ``qwen3-moe-smoke`` config in float32 and in bf16 with
              the same converted parameters on the card and through the
              CPU port;
13. tpcc    — TPC-C at Fig 14's widest point (32 warehouses, 8 nodes, 20%
              remote, hot set 1,312 keys on the full-width switch), 8 x
              256 txns in ``pallas`` mode: every txn is warm, its switch
              sub-txn one B = 1 single-CTA launch; held against a CPU
              port cluster, then crash recovery, and one warm dispatch
              under the profiler (one device kernel);
14. drift   — a YCSB hotspot shift with an ``EpochController`` migrating
              the full-width switch, against a CPU port cluster: results,
              registers, stores, stats, WAL heads and every tuple's
              value, then crash recovery; seconds per ``migrate()``;
15. openloop — ``serve_open_loop`` on fresh full-width YCSB-A clusters at
              0.5x, 1x and 2x of phase 4's txn/s (Poisson, 4,096 txns,
              batch 256, a clock that synchronizes the card): p50, p99,
              p999, achieved rate, utilization and the knee; registers,
              stores and next_gid against a CPU port cluster.

Prints a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Imports nothing
of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import copy
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor rate (data sheet)
S, R, K, B = 24, 65536, 16, 256  # benchmarks/common.py SWITCH; B per group


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, inner: int, reps: int) -> float:
    """Median over ``reps`` of (CUDA-event time of ``inner`` calls)/inner,
    in ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        per_call.append(e0.elapsed_time(e1) / inner)
    return statistics.median(per_call)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phase 3 --

def _check_stream(rng, n, skew=0.5):
    """The skewed check stream over the full-width file: all five
    opcodes, ``skew`` of it on three hot slots, int32 edge registers and
    operands, four slots past the file's end (clamped)."""
    n_slots = S * R
    regs = rng.integers(-1000, 1000, n_slots).astype(np.int32)
    hot = np.array([7, 3 * R + 11, n_slots - 1])
    regs[hot] = [2**31 - 20, -2**31 + 5, 0]                  # int32 edges
    op = rng.integers(0, 5, n).astype(np.int32)             # all 5 opcodes
    g = rng.integers(0, n_slots, n).astype(np.int32)
    on_hot = rng.random(n) < skew                            # hot-key skew
    g[on_hot] = hot[rng.integers(0, 3, int(on_hot.sum()))]
    g[rng.integers(0, n, 4)] = n_slots + 7                   # clamped slots
    val = rng.integers(-100, 100, n).astype(np.int32)
    edge = rng.random(n) < 0.05
    val[edge] = rng.choice([2**31 - 1, -2**31, 2**30], int(edge.sum()))
    idx = rng.integers(0, n + 64, n).astype(np.int32)       # some past end
    idx[rng.integers(0, n, 8)] = -3                         # low clamp
    return regs, op, g // R, g % R, g, val, idx


def _smem_case(tk, dev, rng, n, offset=0):
    """One stream through switch_txn_gather_call against switch_txn_plain
    + result_gather_plain, exactly.  ``offset`` > 0 hands the kernel
    views that start ``offset`` int32 into their buffers (no 16-byte
    loads).  Returns (max abs error, launches by path, CADDs refused)."""
    regs, op, st, rg, g, val, idx = _check_stream(rng, n)
    t = lambda a: torch.tensor(np.concatenate(
        [np.zeros(offset, np.int32), a]), device=dev)[offset:]
    regs_t = torch.tensor(regs, device=dev)
    before = dict(tk.LAUNCHES)
    r_k, res_k, ok_k, c_k = tk.switch_txn_gather_call(
        regs_t.clone(), t(op), t(st), t(rg), t(val), R, t(idx))
    launched = {k: tk.LAUNCHES[k] - before[k] for k in before}
    r_p, res_p, ok_p = tk.switch_txn_plain(regs_t.clone(), t(op), t(g),
                                           t(val))
    c_p = tk.result_gather_plain(res_p, t(idx))
    torch.cuda.synchronize()
    check(ok_k.dtype == torch.bool, "switch_txn: ok is not torch.bool")
    pairs = (("registers", r_k, r_p), ("res", res_k, res_p),
             ("ok", ok_k, ok_p.bool()), ("compact", c_k, c_p))
    for name, a, b in pairs:
        check(torch.equal(a, b), f"switch_txn {name} differ from plain at "
              f"N={n} (offset {offset})")
    err = max(int((a.long() - b.long()).abs().max()) for _, a, b in pairs)
    return err, launched, int((~ok_k).sum())


def _ptxas_lines(log: str):
    """'kernel: N registers, F bytes stack frame, S bytes spill stores, L
    bytes spill loads' per entry function of a ptxas -v log."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            for tag in ("switch_txn_smem_kernel", "switch_txn_kernel",
                        "result_gather_kernel", "scan_prune_kernel",
                        "scan_block_agg_kernel", "scan_block_write_kernel",
                        "moe_route_kernel", "moe_plan_kernel"):
                if tag in name:
                    tail = name.split(tag)[1]
                    tmpl = (re.findall(r"Li(\d+)E", tail)
                            if tail.startswith("I") else [])
                    name = tag + (f"<{','.join(tmpl)}>" if tmpl else "")
                    break
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used ")[1].split(" registers")[0]
            out.append(f"{name}: {regs} registers, {spill}")
            name = None
    return out


def kernel_checks(tk, lib, dev):
    rng = np.random.default_rng(SEED)
    n_slots, n = S * R, B * K
    smax = tk.SMEM_MAX_N
    check(lib.switch_txn_smem_bytes(smax) > 0
          and lib.switch_txn_smem_bytes(smax + 1) == 0,
          f"SMEM_MAX_N={smax} disagrees with the CUDA source")
    smem_bytes = {k: lib.switch_txn_smem_bytes(k)
                  for k in (256, 1024, 4096, smax)}
    # (N, offset, path): every tile of the single-CTA kernel, a ragged N
    # on unaligned views, and the large-N path at 2 x SMEM_MAX_N
    cases = [(16, 0, "switch_txn_smem"), (1000, 1, "switch_txn_smem"),
             (n, 0, "switch_txn_smem"), (2999, 3, "switch_txn_smem"),
             (smax, 0, "switch_txn_smem"), (2 * smax, 0, "switch_txn")]
    err_txn, lines = 0, []
    for n_case, offset, path in cases:
        err, launched, refused = _smem_case(tk, dev, rng, n_case, offset)
        err_txn = max(err_txn, err)
        want = ({"switch_txn_smem": 1} if path == "switch_txn_smem" else
                {"switch_txn": 1, "result_gather": 1})
        check({k: v for k, v in launched.items() if v} == want,
              f"N={n_case} took {launched}, expected {want}")
        check(refused > 0 or n_case < 1000,
              f"no CADD was refused at N={n_case}")
        lines.append(f"N={n_case}{' (offset %d)' % offset if offset else ''}"
                     f" {path}")

    # the check stream at the main path's N = 4096, timed
    regs, op, st, rg, g, val, idx = _check_stream(
        np.random.default_rng(SEED), n)
    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    work, op_t, st_t, rg_t, g_t, val_t, idx_t = (t(a) for a in (
        regs, op, st, rg, g, val, idx))
    m = idx_t.shape[0]
    res_buf = torch.empty_like(op_t)
    ok_buf = torch.empty(n, dtype=torch.bool, device=dev)
    cmp_buf = torch.empty_like(idx_t)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def large_path(o, stg, rgs, v, ix):           # the parent's hot path
        _, res, ok = tk.switch_txn_call(work, o, stg * R + rgs, v)
        return tk.result_gather_call(res, ix), ok.to(torch.bool)

    ms_txn = time_cuda(lambda: tk.switch_txn_gather_call(
        work, op_t, st_t, rg_t, val_t, R, idx_t), inner=50, reps=11)
    kernel_ms_txn = time_cuda(lambda: lib.switch_txn_smem_launch(
        work.data_ptr(), n_slots, R, op_t.data_ptr(), st_t.data_ptr(),
        rg_t.data_ptr(), val_t.data_ptr(), n, res_buf.data_ptr(),
        ok_buf.data_ptr(), idx_t.data_ptr(), cmp_buf.data_ptr(), m, stream),
        inner=200, reps=11)
    # the same kernel on a stream with no hot slot: load, sort and
    # epilogue without a long walk
    uni = [t(a) for a in _check_stream(np.random.default_rng(SEED + 8), n,
                                       skew=0.0)]
    uniform_ms = time_cuda(lambda: lib.switch_txn_smem_launch(
        work.data_ptr(), n_slots, R, uni[1].data_ptr(), uni[2].data_ptr(),
        uni[3].data_ptr(), uni[5].data_ptr(), n, res_buf.data_ptr(),
        ok_buf.data_ptr(), uni[6].data_ptr(), cmp_buf.data_ptr(), m, stream),
        inner=200, reps=11)
    # and at N = 16 (a B=1 group; the 256 tile): launch plus the least
    # work the kernel does
    tiny = [t(a) for a in _check_stream(np.random.default_rng(SEED + 7), 16)]
    tiny_ms = time_cuda(lambda: lib.switch_txn_smem_launch(
        work.data_ptr(), n_slots, R, tiny[1].data_ptr(), tiny[2].data_ptr(),
        tiny[3].data_ptr(), tiny[5].data_ptr(), 16, res_buf.data_ptr(),
        ok_buf.data_ptr(), tiny[6].data_ptr(), cmp_buf.data_ptr(), 16,
        stream), inner=200, reps=11)
    large_ms = time_cuda(lambda: large_path(op_t, st_t, rg_t, val_t, idx_t),
                         inner=50, reps=11)
    plain_ms_txn = time_cuda(lambda: tk.result_gather_plain(
        tk.switch_txn_plain(work, op_t, g_t, val_t)[1], idx_t),
        inner=2, reps=5)
    big = [t(a) for a in _check_stream(np.random.default_rng(SEED + 9),
                                       2 * smax)]
    large_2x_ms = time_cuda(lambda: large_path(big[1], big[2], big[3],
                                               big[5], big[6]),
                            inner=20, reps=11)
    distinct = int(torch.unique(torch.where(
        op_t == 0, n_slots, g_t.clamp(0, n_slots - 1))).numel()) - 1
    # op/stage/reg/val and idx in, res + ok (bytes) + compact out, one read
    # and one write per distinct register touched; one RMW per instruction
    b_txn, by_txn = bound_ms(4 * 4 * n + 5 * n + 8 * m + 8 * distinct, n)

    # result_gather: the lean launcher and torch.take in turns
    src = tk.switch_txn_gather_call(work.clone(), op_t, st_t, rg_t, val_t, R
                                    )[1]
    out_k = tk.result_gather_call(src, idx_t)
    out_p = tk.result_gather_plain(src, idx_t)
    torch.cuda.synchronize()
    check(torch.equal(out_k, out_p), "result_gather differs from plain")
    err_g = int((out_k.long() - out_p.long()).abs().max())
    idx_c = idx_t.clamp(0, n - 1).long()
    gather = lambda: tk.result_gather_call(src, idx_t)
    take = lambda: torch.take(src, idx_c)
    turns = [time_cuda(f, inner=200, reps=11)
             for f in (gather, take, take, gather) * 2]
    ms_g = statistics.median(turns[0::4] + turns[3::4])
    lib_ms_g = statistics.median(turns[1::4] + turns[2::4])
    plain_ms_g = time_cuda(lambda: tk.result_gather_plain(src, idx_t),
                           inner=200, reps=11)
    # the launcher with each piece removed in turn: a replica of its body
    fn, get_stream, d = tk._GATHER, tk._STREAM, src.get_device()
    out_buf, h, i32 = torch.empty_like(idx_t), get_stream(d), torch.int32

    def replica(checks=True, alloc=True, lookup=True):
        def launch():
            if checks and not (
                    src.is_cuda and idx_t.is_cuda and src.dtype is i32
                    and idx_t.dtype is i32 and src.ndim == 1
                    and idx_t.ndim == 1 and src.is_contiguous()
                    and idx_t.is_contiguous() and src.numel() > 0
                    and src.get_device() == idx_t.get_device()
                    and idx_t.numel() > 0):
                fail("result_gather replica: a check failed")
            out = torch.empty_like(idx_t) if alloc else out_buf
            fn(src.data_ptr(), n, idx_t.data_ptr(), out.data_ptr(), m,
               get_stream(d) if lookup else h)
        return launch

    pieces = {"replica": replica(), "no checks": replica(checks=False),
              "no allocation": replica(alloc=False),
              "no stream lookup": replica(lookup=False),
              "bare C call": replica(False, False, False)}
    breakdown = {k: time_cuda(f, inner=200, reps=11)
                 for k, f in pieces.items()}
    kernel_ms_g = breakdown["bare C call"]
    b_g, by_g = bound_ms(4 * 3 * m, m)                       # idx, src, out
    print(f"kernels: switch_txn_smem equal to plain on "
          f"{', '.join(lines)} (registers, res, ok, compact); shared memory "
          f"by tile {smem_bytes} bytes", flush=True)
    print(f"kernels: switch_txn_smem {ms_txn * 1e3:.2f} us/call with the "
          f"gather (bare launch {kernel_ms_txn * 1e3:.2f} us, plain "
          f"{plain_ms_txn * 1e3:.1f} us, {distinct} distinct slots, bound "
          f"{b_txn * 1e3:.4f} us; bare on a stream with no hot slot "
          f"{uniform_ms * 1e3:.2f} us, at N=16 {tiny_ms * 1e3:.2f} us); "
          f"large-N path at N={n} "
          f"{large_ms * 1e3:.2f} us, at N={2 * smax} "
          f"{large_2x_ms * 1e3:.2f} us", flush=True)
    print(f"kernels: result_gather {ms_g * 1e3:.2f} us/call, torch.take "
          f"{lib_ms_g * 1e3:.2f} us (medians of turns gather, take, take, "
          f"gather, twice: " + " / ".join(f"{x * 1e3:.2f}" for x in turns)
          + f"), plain {plain_ms_g * 1e3:.2f} us; launcher "
          "with a piece removed: " + ", ".join(
              f"{k} {v * 1e3:.2f} us" for k, v in breakdown.items()),
          flush=True)
    return [
        dict(name="switch_txn", route="cuda", path="switch_txn_smem",
             source="src/repro_torch/kernels/switch_txn/csrc/switch_txn.cu",
             replaces="src/repro/kernels/switch_txn/switch_txn.py:29",
             launches=0, max_abs_err=err_txn, ms=ms_txn,
             plain_ms=plain_ms_txn, bound_ms=b_txn, bound_by=by_txn,
             library_ms=None, kernel_ms=kernel_ms_txn, shape=[n_slots, n, m],
             smem_bytes=smem_bytes, kernel_ms_no_hot_slot=uniform_ms,
             kernel_ms_n16=tiny_ms,
             large_n=dict(ms_at_4096=large_ms, ms_at_2x_max=large_2x_ms)),
        dict(name="result_gather", route="cuda",
             source="src/repro_torch/kernels/switch_txn/csrc/switch_txn.cu",
             replaces="src/repro/kernels/switch_txn/switch_txn.py:61",
             launches=0, max_abs_err=err_g, ms=ms_g, plain_ms=plain_ms_g,
             bound_ms=b_g, bound_by=by_g, library_ms=lib_ms_g,
             kernel_ms=kernel_ms_g, shape=[n, m], turns_ms=turns,
             breakdown=breakdown),
    ]


def _scan_equal(got, want, what):
    """The three outputs of a scan against its plain version, exactly;
    returns the max abs error (0)."""
    torch.cuda.synchronize()
    err = 0
    for name, a, b in zip(("vals", "pos", "agg"), got, want):
        check(torch.equal(a, b), f"scan_prune {name} differ from plain "
              f"({what})")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def _launched(tk, before):
    return {k: v - before[k] for k, v in tk.LAUNCHES.items() if v - before[k]}


def scan_kernel_checks(tk, lib, dev):
    """The fused scan (gather + filter + compaction, one packed output)
    against its plain version, exactly: over the whole register file
    through a permuted index (the large path) at every selectivity and at
    caps 0, 1, 16, the exact count and M; at M = 1, 400, 4,096, every
    tile boundary, SCAN_SMEM_MAX and SCAN_SMEM_MAX + 1, with negative and
    past-the-end slots, and on an unaligned index view; the
    int32-wrapping sum.  Then timed at the scan cluster's shape (M =
    4,096, the 16-row first pass), at the reads phase's M = 400 and at
    full width."""
    smax = tk.SCAN_SMEM_MAX
    check(lib.scan_prune_scratch_len(smax) == 0
          and lib.scan_prune_scratch_len(smax + 1) > 0,
          f"SCAN_SMEM_MAX={smax} disagrees with the CUDA source")
    rng = np.random.default_rng(SEED + 10)
    n_slots = S * R
    regs = rng.integers(-2**30, 2**30, n_slots).astype(np.int32)
    regs[rng.choice(n_slots, 64, replace=False)] = np.repeat(
        [2**31 - 1, -2**31], 32)                          # int32 edges
    flat = torch.tensor(regs, device=dev)
    perm_t = torch.tensor(rng.permutation(n_slots).astype(np.int32),
                          device=dev)
    src = tk.result_gather_plain(flat, perm_t)            # [1,572,864]
    q = np.sort(regs)
    frac = lambda f: (int(q[0]), int(q[max(0, int(f * n_slots) - 1)]))
    ranges = {"lo>hi": (5, -5), "between values": (2**30, 2**31 - 2),
              "1%": frac(0.01), "5%": frac(0.05), "25%": frac(0.25),
              "all": (-2**31, 2**31 - 1)}
    large = {"scan_prune": 1, "scan_prune_large": 1}
    err, lines = 0, []
    for name, (lo, hi) in ranges.items():
        count = int(((src >= lo) & (src <= hi)).sum())
        for cap in sorted({0, 1, 16, count, n_slots}):
            before = dict(tk.LAUNCHES)
            got = tk.scan_prune_gather_call(flat, perm_t, lo, hi, cap)
            check(_launched(tk, before) == large, f"full width {name} cap "
                  f"{cap} took {_launched(tk, before)}")
            err = max(err, _scan_equal(got, tk.scan_prune_gather_plain(
                flat, perm_t, lo, hi, cap), f"full width {name}, cap {cap}"))
            check(int(got[2][0]) == count, f"scan_prune count ({name})")
        err = max(err, _scan_equal(tk.scan_prune_call(src, lo, hi, 16),
                                   tk.scan_prune_plain(src, lo, hi, 16),
                                   f"full width {name} without idx"))
        lines.append(f"{name} {count}")
    wrapped = int(tk.scan_prune_gather_call(flat, perm_t, -2**31,
                                            2**31 - 1, 1)[2][1])
    exact = int(src.long().sum())
    check(wrapped == ((exact + 2**31) % 2**32) - 2**31,
          "scan_prune sum does not wrap like int32")

    # every tile boundary with stray slots: negative ones clamp to 0,
    # past-the-end ones to n_slots - 1
    sizes = (1, 400, 512, 513, 2048, 2049, 4096, 4097, smax, smax + 1)
    for m in sizes:
        idx = rng.integers(0, n_slots, m + 1).astype(np.int32)
        stray = rng.choice(m, min(m, 9), replace=False)
        idx[stray] = np.resize([-1, -7, -2**31, n_slots, n_slots + 3,
                                2**31 - 1], len(stray))
        views = [(torch.tensor(idx[:m], device=dev), 0)]
        if m == 4096:                   # 4 bytes off 16: no vector loads
            views.append((torch.tensor(idx, device=dev)[1:], 1))
        for ix, off in views:
            g = tk.result_gather_plain(flat, ix)
            sq = np.sort(g.cpu().numpy())
            lo, hi = int(sq[0]), int(sq[max(0, int(0.05 * m) - 1)])
            count = int(((g >= lo) & (g <= hi)).sum())
            for cap in sorted({0, 16, count, m}):
                before = dict(tk.LAUNCHES)
                got = tk.scan_prune_gather_call(flat, ix, lo, hi, cap)
                want = ({"scan_prune": 1} if m <= smax else large)
                check(_launched(tk, before) == want, f"M={m} took "
                      f"{_launched(tk, before)}, expected {want}")
                err = max(err, _scan_equal(got, tk.scan_prune_gather_plain(
                    flat, ix, lo, hi, cap), f"M={m} offset {off} cap {cap}"))

    stream_h = torch.cuda.current_stream(dev).cuda_stream

    def timings(ix, lo, hi, cap, inner):
        """Per call (the launcher), bare C launch, plain version and bound
        of the fused scan through ix (None: over flat itself)."""
        m = n_slots if ix is None else ix.shape[0]
        out = torch.empty(2 * cap + 4, dtype=torch.int32, device=dev)
        ip = None if ix is None else ix.data_ptr()
        if ix is None:
            call = lambda: tk.scan_prune_call(flat, lo, hi, cap)
            plain = lambda: tk.scan_prune_plain(flat, lo, hi, cap)
        else:
            call = lambda: tk.scan_prune_gather_packed(flat, ix, lo, hi, cap)
            plain = lambda: tk.scan_prune_gather_plain(flat, ix, lo, hi, cap)
        if m <= smax:
            bare = lambda: lib.scan_prune_launch(
                flat.data_ptr(), n_slots, ip, m, lo, hi, cap, out.data_ptr(),
                stream_h)
        else:
            n_scr = lib.scan_prune_scratch_len(m)
            scratch = torch.empty(n_scr, dtype=torch.int32, device=dev)
            check(lib.scan_prune_large_launch(
                flat.data_ptr(), n_slots, ip, m, lo, hi, cap, out.data_ptr(),
                scratch.data_ptr(), n_scr - 1, stream_h) != 0,
                "scan_prune_large_launch accepted a scratch one short")
            bare = lambda: lib.scan_prune_large_launch(
                flat.data_ptr(), n_slots, ip, m, lo, hi, cap, out.data_ptr(),
                scratch.data_ptr(), n_scr, stream_h)
        ms = time_cuda(call, inner=inner, reps=11)
        bare_ms = time_cuda(bare, inner=inner, reps=11)
        device_us = _profile_steps(call)[0]     # the kernels, profiler
        plain_ms = time_cuda(plain, inner=max(inner // 10, 2), reps=5)
        # indices read once (when given), the gathered values read once,
        # the packed output written once; two compares per position
        b, by = bound_ms(4 * m * (1 if ix is None else 2)
                         + 4 * (2 * cap + 4), 2 * m)
        return dict(m=m, cap=cap, ms=ms, kernel_ms=bare_ms, plain_ms=plain_ms,
                    bound_ms=b, bound_by=by, device_us=device_us)

    def sel_range(ix, f):
        g = np.sort(tk.result_gather_plain(flat, ix).cpu().numpy())
        return int(g[0]), int(g[max(0, int(f * g.shape[0]) - 1)])

    # the scan cluster's shape: 4,096 hot slots, 5% selected, the 16-row
    # first pass of Cluster.scan; and the reads phase's 400 hot keys
    ix4096 = perm_t[:4096].contiguous()
    ix400 = perm_t[:400].contiguous()
    main = timings(ix4096, *sel_range(ix4096, 0.05), 16, inner=200)
    reads = timings(ix400, *sel_range(ix400, 0.05), 16, inner=200)
    # the same 4,096 values as the parent timed them: pre-gathered, no
    # idx; and gathered by result_gather_call then scanned (two launches)
    src4096 = src[:4096].contiguous()
    lo_m, hi_m = sel_range(ix4096, 0.05)
    unfused = time_cuda(lambda: tk.scan_prune_call(src4096, lo_m, hi_m, 16),
                        inner=200, reps=11)
    two = time_cuda(lambda: tk.scan_prune_call(
        tk.result_gather_call(flat, ix4096), lo_m, hi_m, 16), inner=200,
        reps=11)
    fw = timings(perm_t, *ranges["5%"], 16, inner=50)
    fw_all = timings(perm_t, *ranges["all"], n_slots, inner=20)
    fw_noidx = timings(None, *ranges["5%"], 16, inner=50)
    us = lambda d: (f"{d['ms'] * 1e3:.2f} us/call (bare "
                    f"{d['kernel_ms'] * 1e3:.2f} us, device "
                    f"{d['device_us']:.2f} us, plain "
                    f"{d['plain_ms'] * 1e3:.2f} us, bound "
                    f"{d['bound_ms'] * 1e3:.4f} us)")
    print(f"kernels: scan_prune (fused gather, one packed output) equal to "
          f"plain over {n_slots} slots through a permutation (matches: "
          f"{', '.join(lines)}; caps 0 / 1 / 16 / exact / M), and at M = "
          f"{', '.join(map(str, sizes))} with stray slots (caps 0 / 16 / "
          f"exact / M; M=4096 also 4 bytes off alignment); int32 sum wraps",
          flush=True)
    print(f"kernels: scan_prune at M=4096 cap 16 {us(main)}; M=400 cap 16 "
          f"{us(reads)}; M=4096 pre-gathered, no idx, "
          f"{unfused * 1e3:.2f} us/call; result_gather_call then "
          f"scan_prune_call {two * 1e3:.2f} us/call; full width 5% cap 16 "
          f"{us(fw)}; full width all, cap M {us(fw_all)}; full width 5% cap "
          f"16 without idx {us(fw_noidx)}", flush=True)
    return dict(name="scan_prune", route="cuda",
                source="src/repro_torch/kernels/switch_txn/csrc/switch_txn.cu",
                replaces="src/repro/kernels/switch_txn/switch_txn.py:105",
                launches=0, max_abs_err=err, ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None,
                kernel_ms=main["kernel_ms"], shape=[4096, 16],
                reads_m400=reads, pregathered_ms=unfused,
                gather_then_scan_ms=two,
                full_width=[dict(fw, selectivity="5%"),
                            dict(fw_all, selectivity="all"),
                            dict(fw_noidx, selectivity="5%, no idx")])


# ---------------------------------------------------------- phase 3, moe --

MOE_ARCH = "qwen3_moe_235b_a22b"
MOE_LAYERS, MOE_B, MOE_PROMPT, MOE_GEN = 4, 8, 256, 16


def _sorted_ids(rng, n, n_experts):
    return np.sort(rng.integers(0, n_experts, n)).astype(np.int32)


def _plan_kernels(fn):
    """Device kernel launches and their device us (by the profiler) of
    one call of fn."""
    dev_us, rows, _ = _profile_steps(fn)
    return sum(c for _, k, c in rows
               if not k.startswith(("Memcpy", "Memset"))), dev_us


def moe_route_checks(mr, lib, dev):
    """moe_route against its plain version (exactly) on the reference
    test shapes, edge streams and the serving path's shapes (prefill:
    2,048 tokens x top-8 = 16,384 ids over 128 experts; decode: 8 x 8 =
    64); the routing plan (moe_plan) against its plain version on the
    same streams unsorted, one expert, a 90% hot expert, everything
    dropped, N = 1, PLAN_MAX_N and PLAN_MAX_N + 1; then both timed at
    the serving shapes, beside the parent's route chain (argsort +
    moe_route) and torch.argsort, with the profiler's device kernels per
    plan."""
    rng = np.random.default_rng(SEED + 20)
    cases = {f"{n}x{e}": _sorted_ids(np.random.default_rng(n), n, e)
             for n, e in ((64, 4), (1000, 7), (4096, 128), (513, 1))}
    cases["N=1"] = np.array([3], np.int32)
    cases["hot 90%"] = np.sort(np.where(rng.random(16384) < 0.9, 17,
                                        rng.integers(0, 128, 16384))
                               ).astype(np.int32)
    # runs of 1,000: a run straddles every multiple of 1,024
    cases["runs cross 1024"] = np.repeat(np.arange(17, dtype=np.int32),
                                         1000)[:16384]
    cases["prefill"] = _sorted_ids(rng, MOE_B * MOE_PROMPT * 8, 128)
    cases["decode"] = _sorted_ids(rng, MOE_B * 8, 128)
    err = 0
    for name, ids in cases.items():
        t = torch.tensor(ids, device=dev)
        got, want = mr.moe_route_call(t), mr.moe_route_plain(t)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"moe_route differs from plain ({name})")
        err = max(err, int((got.long() - want.long()).abs().max()))
    before = dict(mr.LAUNCHES)
    check(mr.moe_route_call(torch.zeros(0, dtype=torch.int32, device=dev)
                            ).shape == (0,) and mr.LAUNCHES == before,
          "moe_route launched on an empty stream")

    # the routing plan: every stream above, unsorted, and the plan's own
    # edges; (E, C, top_k) as route would call it
    pmax = mr.PLAN_MAX_N
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    check(lib.moe_plan_launch(one.data_ptr(), pmax + 1, 128, 8, 8,
                              one.data_ptr(), one.data_ptr(), one.data_ptr(),
                              one.data_ptr(), 0) != 0
          and lib.moe_plan_launch(one.data_ptr(), 1, mr.PLAN_MAX_E + 1, 8,
                                  8, one.data_ptr(), one.data_ptr(),
                                  one.data_ptr(), one.data_ptr(), 0) != 0,
          "moe_plan_launch accepted a plan past PLAN_MAX_N or PLAN_MAX_E")
    plans = {}
    for name, ids in cases.items():
        e = max(int(ids.max()) + 1, 1) if name not in ("prefill", "decode",
                                                       "hot 90%") else 128
        plans[name] = (rng.permutation(ids), e, 8, 8)
    plans["one expert"] = (np.zeros(4096, np.int32), 1, 160, 8)
    plans["all dropped, C=0"] = (rng.integers(0, 128, 4096), 128, 0, 8)
    plans["C=8, E=4"] = (rng.integers(0, 4, 4096), 4, 8, 2)
    plans["N=1"] = (np.array([77], np.int32), 128, 8, 8)
    plans["N=PLAN_MAX_N"] = (rng.integers(0, 128, pmax), 128, 160, 8)
    plans["N=PLAN_MAX_N+1"] = (rng.integers(0, 128, pmax + 1), 128, 160, 8)
    plans["E=PLAN_MAX_E"] = (rng.integers(0, mr.PLAN_MAX_E, 3000),
                             mr.PLAN_MAX_E, 2, 1)
    for name, (ids, e, cap, k) in plans.items():
        t = torch.tensor(np.asarray(ids, np.int32), device=dev)
        before = dict(mr.LAUNCHES)
        got = mr.route_plan_call(t, e, cap, k)
        launched = {x: mr.LAUNCHES[x] - before[x] for x in before
                    if mr.LAUNCHES[x] != before[x]}
        want = mr.route_plan_plain(t, e, cap, k)
        torch.cuda.synchronize()
        for what, a, b in zip(("order", "slot", "admit", "tok"), got, want):
            check(a.dtype == b.dtype and torch.equal(a, b),
                  f"moe_plan {what} differs from plain ({name})")
            if what != "admit":
                err = max(err, int((a.long() - b.long()).abs().max()))
        expect = ({"moe_route": 1} if t.numel() > pmax else {"moe_plan": 1})
        check(launched == expect, f"route plan {name} launched {launched}, "
              f"expected {expect}")
    print("kernels: moe_plan equal to plain (order, slot, admit, tok) on "
          + ", ".join(f"{k} (N={len(v[0])}, E={v[1]}, C={v[2]})"
                      for k, v in plans.items()), flush=True)

    stream_h = torch.cuda.current_stream(dev).cuda_stream
    timed = {}
    for name, cap in (("prefill", 160), ("decode", 8)):
        t = torch.tensor(plans[name][0], device=dev)       # unsorted
        s_ = torch.sort(t).values
        n = t.shape[0]
        out = torch.empty_like(t)
        buf = torch.empty((3, n), dtype=torch.int32, device=dev)
        adm = torch.empty(n, dtype=torch.bool, device=dev)
        r_ms = time_cuda(lambda: mr.moe_route_call(s_), inner=200, reps=11)
        r_bare = time_cuda(lambda: lib.moe_route_launch(
            s_.data_ptr(), n, out.data_ptr(), stream_h), inner=200, reps=11)
        r_plain = time_cuda(lambda: mr.moe_route_plain(s_), inner=200,
                            reps=11)
        # the nearest single PyTorch call computes each run's first index;
        # the positions are one subtraction more
        r_lib = time_cuda(lambda: torch.searchsorted(s_, s_), inner=200,
                          reps=11)
        plan = lambda: mr.route_plan_call(t, 128, cap, 8)
        chain = lambda: mr._plan_from_sort(t, 128, cap, 8, mr.moe_route_call)
        o_p, s_p, k_p = (buf[i].data_ptr() for i in range(3))
        bare = lambda: lib.moe_plan_launch(t.data_ptr(), n, 128, cap, 8, o_p,
                                           s_p, adm.data_ptr(), k_p, stream_h)
        turns = [time_cuda(f, inner=200, reps=11)
                 for f in (plan, chain, chain, plan)]
        p_bare = time_cuda(bare, inner=200, reps=11)
        p_plain = time_cuda(lambda: mr.route_plan_plain(t, 128, cap, 8),
                            inner=50, reps=5)
        p_lib = time_cuda(lambda: torch.argsort(t, stable=True), inner=200,
                          reps=11)
        # the launcher's host time in its output allocations
        host = {"outputs": time_cuda(lambda: mr._plan_outputs(t, n),
                                     inner=200, reps=11)}
        b, by = bound_ms(8 * n, n)          # ids read once, pos written once
        # ids read once; order, slot, tok (int32) and admit (bytes) written
        pb, pby = bound_ms(4 * n + 13 * n, n)
        timed[name] = dict(
            n=n, ms=r_ms, kernel_ms=r_bare, plain_ms=r_plain,
            searchsorted_ms=r_lib, bound_ms=b, bound_by=by,
            plan=dict(ms=statistics.median([turns[0], turns[3]]),
                      chain_ms=statistics.median([turns[1], turns[2]]),
                      turns_ms=turns, kernel_ms=p_bare, plain_ms=p_plain,
                      argsort_ms=p_lib, bound_ms=pb, bound_by=pby,
                      host_ms=host,
                      device_kernels=_plan_kernels(plan),
                      chain_device_kernels=_plan_kernels(chain)))
    print("kernels: moe_route " + "; ".join(
        f"{k} N={d['n']}: {d['ms'] * 1e3:.2f} us/call (bare "
        f"{d['kernel_ms'] * 1e3:.2f} us, plain {d['plain_ms'] * 1e3:.2f}"
        f" us, searchsorted {d['searchsorted_ms'] * 1e3:.2f} us, bound "
        f"{d['bound_ms'] * 1e3:.4f} us)" for k, d in timed.items()),
        flush=True)
    print("kernels: moe_plan " + "; ".join(
        f"{k} N={d['n']}: {p['ms'] * 1e3:.2f} us/call, parent's chain "
        f"(argsort + moe_route) {p['chain_ms'] * 1e3:.2f} us (turns plan, "
        f"chain, chain, plan: " + " / ".join(f"{x * 1e3:.2f}"
                                              for x in p["turns_ms"])
        + f"); bare {p['kernel_ms'] * 1e3:.2f} us, plain "
        f"{p['plain_ms'] * 1e3:.2f} us, torch.argsort(stable) "
        f"{p['argsort_ms'] * 1e3:.2f} us, bound {p['bound_ms'] * 1e3:.4f} "
        f"us; device kernels per plan {p['device_kernels'][0]} "
        f"({p['device_kernels'][1]:.2f} us), chain "
        f"{p['chain_device_kernels'][0]} "
        f"({p['chain_device_kernels'][1]:.2f} us); host: " + ", ".join(
            f"{a} {b_ * 1e3:.2f} us" for a, b_ in p["host_ms"].items())
        for k, d in timed.items() for p in (d["plan"],)), flush=True)
    # device kernels per whole route call (router product, softmax,
    # top-k, the plan, the gate gather) at the serving shapes, with the
    # plan kernel and with the PR 14 chain (argsort + moe_route) in its
    # place
    from repro_torch.configs.registry import get
    from repro_torch.models import moe as moe_mod
    cfg = get(MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    w = torch.randn(cfg.d_model, 128, generator=gen, device=dev)
    chain_plan = lambda f, e, c, k: mr._plan_from_sort(f, e, c, k,
                                                       mr.moe_route_call)
    kernel_plan = moe_mod.route_plan
    per_route = {}
    for name, tokens in (("prefill", MOE_B * MOE_PROMPT), ("decode", MOE_B)):
        x = torch.randn(tokens, cfg.d_model, generator=gen, device=dev
                        ).to(torch.bfloat16)
        cap = moe_mod.capacity_for(tokens, cfg.moe)
        call = lambda: moe_mod.route(x, w, cfg.moe, cap)
        plan_route = _plan_kernels(call)
        moe_mod.route_plan = chain_plan
        try:
            per_route[name] = dict(plan=plan_route,
                                   chain=_plan_kernels(call))
        finally:
            moe_mod.route_plan = kernel_plan
        timed[name]["plan"]["route_device_kernels"] = per_route[name]
    print("kernels: device kernels (device us) per route call, with the "
          "plan kernel / with the PR 14 chain: " + "; ".join(
              f"{k} {v['plan'][0]} ({v['plan'][1]:.2f} us) / "
              f"{v['chain'][0]} ({v['chain'][1]:.2f} us)"
              for k, v in per_route.items()), flush=True)
    pre = timed["prefill"]["plan"]
    print(f"kernels: PLAN_MAX_N={pmax}: the plan at N={pmax} is "
          f"{'no slower' if pre['ms'] <= pre['chain_ms'] else 'SLOWER'} "
          f"than the parent's chain ({pre['ms'] * 1e3:.2f} against "
          f"{pre['chain_ms'] * 1e3:.2f} us)", flush=True)
    p = timed["prefill"]
    return dict(name="moe_route", route="cuda", kernel="moe_plan_kernel",
                source="src/repro_torch/kernels/moe_route/csrc/moe_route.cu",
                replaces="src/repro/kernels/moe_route/moe_route.py:24",
                launches=0, max_abs_err=err, ms=pre["ms"],
                plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"],
                bound_by=pre["bound_by"], library_ms=pre["argsort_ms"],
                library="torch.argsort(flat_ids, stable=True): the plan's "
                "order alone", kernel_ms=pre["kernel_ms"], shape=[p["n"]],
                chain_ms=pre["chain_ms"], decode_plan=timed["decode"]["plan"],
                moe_route_kernel=dict(prefill={k: v for k, v in p.items()
                                               if k != "plan"},
                                      decode={k: v for k, v in
                                              timed["decode"].items()
                                              if k != "plan"}))


# ---------------------------------------------------------------- phase 4 --

def _wal_heads(c):
    return [n.wal[-1].hash if len(n.wal) else None for n in c.nodes]


def _batch_traces(c):
    return [tr for tr in c.tracer.traces if tr.label.startswith("batch:")]


def _span_totals(traces):
    """Summed seconds by span name over ``traces``."""
    out = {}
    for tr in traces:
        for s_ in tr.spans:
            out[s_.name] = out.get(s_.name, 0.0) + s_.duration
    return out


def _same_clusters(a, b, what):
    check(np.array_equal(a.switch.read_all(), b.switch.read_all()),
          f"{what}: registers differ from the CPU port")
    check(a.switch.next_gid == b.switch.next_gid, f"{what}: next_gid differs")
    check(dict(a.stats) == dict(b.stats), f"{what}: stats differ")
    check(_wal_heads(a) == _wal_heads(b), f"{what}: WAL hash heads differ")


def main_path(tk, label):
    from repro_torch.core.hotset import build_hot_index
    from repro_torch.core.packets import SwitchConfig
    from repro_torch.db.dbms import Cluster
    from repro_torch.workloads import ycsb

    cfg = SwitchConfig(n_stages=S, regs_per_stage=R, max_instrs=K)
    p = ycsb.YCSBParams(variant="A")          # 8 nodes, 100k keys/node
    t0 = time.perf_counter()
    sample = ycsb.generate(np.random.default_rng(SEED), 4000, p)
    hi = build_hot_index(ycsb.traces(sample), top_k=400, switch=cfg)
    txns = ycsb.generate(np.random.default_rng(SEED + 1), 8 * B, p)
    gpu = Cluster(8, cfg, hi, switch_mode="pallas", device="cuda")
    cpu = Cluster(8, cfg, hi, switch_mode="pallas", device="cpu")
    for c in (gpu, cpu):
        c.snapshot_offload()
    print(f"main: setup {time.perf_counter() - t0:.1f} s "
          f"({len(hi.placement.slot)} hot keys)", flush=True)

    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    out_gpu, times = [], []
    for b in range(8):
        batch = txns[b * B:(b + 1) * B]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_gpu += gpu.run_batch(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(tk.LAUNCHES)
    check(launches["switch_txn_smem"] > 0, f"the single-CTA switch_txn was "
          f"not launched on the main path: {launches}")
    check(launches["switch_txn"] == 0 and launches["result_gather"] == 0,
          f"a hot group left the single-CTA path: {launches}")
    check(gpu.switch.dispatch_count == launches["switch_txn_smem"],
          "dispatches and switch_txn_smem launches disagree")

    out_cpu = []
    for b in range(8):
        out_cpu += cpu.run_batch(copy.deepcopy(txns[b * B:(b + 1) * B]))
    check(out_gpu == out_cpu, "main: per-txn results differ from CPU port")
    _same_clusters(gpu, cpu, "main")
    check(gpu.stats["hot"] > 0, "main: no hot txns")

    before = gpu.switch.read_all()
    _reset(tk)
    t0 = time.perf_counter()
    known, unknown = gpu.crash_switch_and_recover()
    t_rec = time.perf_counter() - t0
    rec_launches = dict(tk.LAUNCHES)
    check(before.tobytes() == gpu.switch.read_all().tobytes(),
          "main: registers after crash recovery differ")

    spans = _span_totals(_batch_traces(gpu))
    total = sum(times)
    groups = launches["switch_txn_smem"]
    print(f"main [{label}]: {len(txns)} txns ({gpu.stats['hot']} hot) in "
          f"{total:.4f} s = {len(txns) / total:.1f} txn/s, "
          f"{gpu.stats['hot'] / total:.1f} hot txn/s; median run_batch "
          f"{statistics.median(times) * 1e3:.3f} ms; {groups} hot groups "
          f"({groups / 8:.2f} per run_batch); launches {launches}", flush=True)
    print("main: host spans over 8 run_batch (s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in spans.items())
          + f", rest {total - sum(spans.values()):.4f}", flush=True)
    # the replay runs each send in auto mode (Cluster._replay_into, as
    # the reference does): the affine engine in torch ops, no kernel
    print(f"main: crash_switch_and_recover replayed {known}+{unknown} sends "
          f"in {t_rec:.2f} s, registers identical; kernel launches "
          f"{rec_launches}", flush=True)
    return launches, gpu, cpu, hi, p, len(txns) / total


# ---------------------------------------------------------------- phase 5 --

def _reset(tk):
    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0


def _scans_equal(a, b, cases, what):
    for lo, hi, kw in cases:
        check(a.scan(lo, hi, **kw) == b.scan(lo, hi, **kw),
              f"{what}: scan({lo}, {hi}, {kw}) differs")


def read_path(tk, gpu, cpu, hi):
    """The read tier on the main-path cluster (after its recovery):
    switch-served YCSB-C reads and pruned scans equal the CPU port."""
    from repro_torch.workloads import ycsb
    pc = ycsb.YCSBParams(variant="C")
    txns = ycsb.generate(np.random.default_rng(SEED + 5), 8 * B, pc)
    hot = sorted(hi.placement.slot)
    cold = [k for t in txns for _, k, _ in t.ops if not hi.is_hot(k)][:40]
    _reset(tk)
    times = []
    for b in range(8):
        keys = [k for t in txns[b * B:(b + 1) * B] for _, k, _ in t.ops]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = gpu.read_batch(keys)
        times.append(time.perf_counter() - t0)
        check(got == cpu.read_batch(keys), "reads: read_batch differs")
    cases = [(0, 999, {}), (0, 99, {}), (500, 520, {}), (-5, -1, {}),
             (0, 999, dict(limit=10)), (100, 900, dict(limit=50)),
             (0, 999, dict(keys=hot[:50] + cold)),
             (200, 800, dict(keys=hot[:50] + cold, limit=7))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo, hi_, kw in cases:
        gpu.scan(lo, hi_, **kw)
    t_scan = time.perf_counter() - t0
    _scans_equal(gpu, cpu, cases, "reads")
    launches = dict(tk.LAUNCHES)
    check(launches["result_gather"] > 0 and launches["scan_prune"] > 0,
          f"reads: a read-tier kernel was not launched: {launches}")
    check(gpu.stats["switch_reads"] > 0, "reads: no switch-served reads")
    print(f"reads: 8 read_batch of {len(keys)} YCSB-C keys "
          f"({gpu.stats['switch_reads']} switch-served, "
          f"{gpu.stats['store_reads']} from stores) equal to the CPU port, "
          f"median {statistics.median(times) * 1e3:.3f} ms; {len(cases)} "
          f"scans over {len(hot)} hot keys equal, {t_scan * 1e3:.3f} ms; "
          f"launches {launches}",
          flush=True)
    return launches


# ---------------------------------------------------------------- phase 6 --

N_SCAN = 4096             # scan cluster hot keys (512 per node)


def scan_cluster(n_switches, device, hi=None):
    """bench_reads.py's scan cluster at full width: 4096 one-key hot
    traces, values 3i + 7 loaded by all-WRITE hot run_batch calls."""
    from repro_torch.core.hotset import build_hot_index
    from repro_torch.core.packets import WRITE, SwitchConfig
    from repro_torch.db.dbms import Cluster
    from repro_torch.db.txn import Txn, key_of, node_of
    cfg = SwitchConfig(n_stages=S, regs_per_stage=R, max_instrs=K,
                       n_switches=n_switches)
    keys = [key_of(i % 8, i) for i in range(N_SCAN)]
    if hi is None:
        hi = build_hot_index([[(k, "W")] for k in keys], N_SCAN, cfg)
    c = Cluster(8, cfg, hi, switch_mode="pallas", device=device)
    vals = {k: 3 * i + 7 for i, k in enumerate(keys)}
    load = [Txn("load", [(WRITE, k, v)], node_of(k)) for k, v in vals.items()]
    for i in range(0, N_SCAN, 1024):
        c.run_batch(load[i:i + 1024])
    c.snapshot_offload()
    return c, hi, keys, vals


def _sweep_cases():
    out = []
    for sel in (0.01, 0.05, 0.25, 1.0):
        n_match = max(1, int(sel * N_SCAN))
        out.append((sel, 7, 7 + 3 * (n_match - 1)))
    return out


def _truth(vals, lo, hi, limit=None):
    m = [(k, v) for k, v in vals.items() if lo <= v <= hi]
    if limit is not None and len(m) > limit:
        m = sorted(m, key=lambda kv: (-kv[1], kv[0]))[:limit]
    return sorted(m)


def scan_path(tk):
    t0 = time.perf_counter()
    gpu, hi, keys, vals = scan_cluster(1, "cuda")
    cpu, _, _, _ = scan_cluster(1, "cpu", hi)
    print(f"scan: setup {time.perf_counter() - t0:.1f} s", flush=True)
    check(gpu.read_batch(keys) == [vals[k] for k in keys],
          "scan: loaded values differ")
    rows = []
    _reset(tk)
    for sel, lo, hi_ in _sweep_cases():
        before = gpu.stats["scan_rows_shipped"]
        n0 = tk.LAUNCHES["scan_prune"]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = gpu.scan(lo, hi_)
        dt = time.perf_counter() - t1
        shipped = gpu.stats["scan_rows_shipped"] - before
        check(out == _truth(vals, lo, hi_), f"scan: {sel:.0%} differs "
              "from the host filter")
        check(shipped / N_SCAN <= sel + 16 / N_SCAN + 1e-9,
              f"scan: {sel:.0%} shipped {shipped} rows")
        rows.append(f"{sel:.0%}: {len(out)} rows, shipped {shipped}, "
                    f"{tk.LAUNCHES['scan_prune'] - n0} launches, "
                    f"{dt * 1e3:.3f} ms")
    limits = ((7, 7 + 3 * 1023, 10), (7, 3 * N_SCAN + 7, 100))
    for lo, hi_, lim in limits:
        check(gpu.scan(lo, hi_, limit=lim) == _truth(vals, lo, hi_, lim),
              "scan: limit scan differs from the host filter")
    launches = dict(tk.LAUNCHES)
    check(launches["scan_prune"] > 0, "scan: scan_prune not launched")
    _scans_equal(gpu, cpu, [(lo, hi_, {}) for _, lo, hi_ in _sweep_cases()]
                 + [(lo, hi_, dict(limit=lim)) for lo, hi_, lim in limits],
                 "scan")
    print(f"scan: {N_SCAN} hot keys, equal to the CPU port and the host "
          f"filter; " + "; ".join(rows) + f"; launches {launches}",
          flush=True)
    return launches, gpu


# ---------------------------------------------------------------- phase 7 --

def sharded_path(tk, scan1, p):
    """n_switches=2 (two 24 x 65536 planes on the card) against
    n_switches=1: the scan cluster's reads and scans, then 2 x 256 YCSB-A
    txns (results, GIDs, per-key reads, WAL streams)."""
    from repro_torch.core.engine import ShardedSwitchEngine
    from repro_torch.core.hotset import build_hot_index
    from repro_torch.core.packets import SwitchConfig
    from repro_torch.db.dbms import Cluster
    from repro_torch.workloads import ycsb

    t0 = time.perf_counter()
    scan2, _, keys, vals = scan_cluster(2, "cuda")
    check(isinstance(scan2.switch, ShardedSwitchEngine),
          "sharded: n_switches=2 did not build the sharded plane")
    check(scan2.read_batch(keys) == scan1.read_batch(keys),
          "sharded: scan cluster reads differ")
    cases = [(lo, hi_, {}) for _, lo, hi_ in _sweep_cases()] + \
        [(7, 7 + 3 * 1023, dict(limit=10)), (7, 3 * N_SCAN + 7,
                                             dict(limit=100))]
    _scans_equal(scan2, scan1, cases, "sharded scan")
    t_scan = time.perf_counter() - t0

    sample = ycsb.generate(np.random.default_rng(SEED), 4000, p)
    txns = ycsb.generate(np.random.default_rng(SEED + 3), 2 * B, p)
    worlds = []
    for n in (1, 2):
        cfg = SwitchConfig(n_stages=S, regs_per_stage=R, max_instrs=K,
                           n_switches=n)
        hi = build_hot_index(ycsb.traces(sample), top_k=400, switch=cfg)
        c = Cluster(8, cfg, hi, switch_mode="pallas", device="cuda")
        c.snapshot_offload()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = []
        for b in range(2):
            out += c.run_batch(copy.deepcopy(txns[b * B:(b + 1) * B]))
        torch.cuda.synchronize()
        worlds.append((c, hi, out, time.perf_counter() - t1))
    (c1, hi1, r1, t1), (c2, hi2, r2, t2) = worlds
    check(r1 == r2, "sharded: per-txn results differ")
    check(c1.switch.next_gid == c2.switch.next_gid, "sharded: GIDs differ")
    hot = sorted(hi1.placement.slot)
    check(set(hot) == set(hi2.placement.slot), "sharded: hot sets differ")
    check(c1.read_batch(hot) == c2.read_batch(hot),
          "sharded: per-key reads differ")
    check([c1.read(k) for k in hot[:20]] == [c2.read(k) for k in hot[:20]],
          "sharded: point reads differ")
    stream = lambda c: [[(e.kind, e.tid) for e in n.wal] for n in c.nodes]
    check(stream(c1) == stream(c2), "sharded: WAL streams differ")
    cross = sum(1 for t in txns if all(hi2.is_hot(k) for _, k, _ in t.ops)
                and len({hi2.placement.slot[k][0] for _, k, _ in t.ops}) > 1)
    print(f"sharded: scan cluster at n_switches=2 equal to n=1 "
          f"({len(cases)} scans, {t_scan:.1f} s incl. setup); 2 x {B} "
          f"YCSB-A txns equal (results, GIDs, reads, WAL streams); "
          f"{cross} cross-shard hot rows; run_batch total n=1 {t1:.3f} s, "
          f"n=2 {t2:.3f} s; dispatches per plane "
          f"{[p_.dispatch_count for p_ in c2.switch.planes]}", flush=True)


# ---------------------------------------------------------------- phase 8 --

def async_read_path(tk, hi, p):
    """read_batch on an async_hot cluster while hot groups are undrained:
    equal to an async CPU port cluster at the same point (both drain at
    the same points, so their WALs are comparable), and the in-flight
    window untouched."""
    from repro_torch.core.packets import SwitchConfig
    from repro_torch.db.dbms import Cluster
    from repro_torch.workloads import ycsb
    cfg = SwitchConfig(n_stages=S, regs_per_stage=R, max_instrs=K)
    ga = Cluster(8, cfg, hi, switch_mode="pallas", async_hot=True,
                 max_inflight=4, device="cuda")
    cs = Cluster(8, cfg, hi, switch_mode="pallas", async_hot=True,
                 max_inflight=4, device="cpu")
    for c in (ga, cs):
        c.snapshot_offload()
    txns = [t for t in ycsb.generate(np.random.default_rng(SEED + 4),
                                     2 * B, p)
            if all(hi.is_hot(k) for _, k, _ in t.ops)]
    out_a, out_s = [], []
    step = len(txns) // 3 + 1
    for i in range(0, len(txns), step):
        out_a.append(ga.run_batch(txns[i:i + step]))
        out_s.append(cs.run_batch(copy.deepcopy(txns[i:i + step])))
    n_parked = len(ga._inflight)
    check(n_parked > 0 and len(cs._inflight) == n_parked,
          "async: no undrained groups in flight")
    hot = sorted(hi.placement.slot)
    check(ga.read_batch(hot) == cs.read_batch(hot),
          "async: read_batch with groups in flight differs from CPU port")
    check(len(ga._inflight) == n_parked, "async: read_batch drained groups")
    check(ga.scan(0, 999) == cs.scan(0, 999), "async: scan differs")
    for c in (ga, cs):
        c.drain()
    check(out_a == out_s,
          "async: per-txn results differ from CPU port")
    _same_clusters(ga, cs, "async")
    print(f"async: read_batch of {len(hot)} hot keys with {n_parked} "
          f"undrained groups ({len(txns)} hot txns) equal to the CPU port; "
          f"in-flight window untouched", flush=True)


# ---------------------------------------------------------------- phase 9 --

def cadd_path(tk):
    from repro_torch.core.hotset import build_hot_index
    from repro_torch.core.packets import ADDP, SwitchConfig
    from repro_torch.db.dbms import Cluster
    from repro_torch.workloads import smallbank

    cfg = SwitchConfig(n_stages=S, regs_per_stage=R, max_instrs=K)
    p = smallbank.SmallBankParams()           # 8 nodes, 10 hot accts/node
    sample = smallbank.generate(np.random.default_rng(SEED), 6000, p)
    hi = build_hot_index(smallbank.traces(sample),
                         top_k=p.hot_per_node * p.n_nodes * 2, switch=cfg)
    txns = [t for t in smallbank.generate(np.random.default_rng(SEED + 1),
                                          4 * B, p)
            if all(o != ADDP for o, _, _ in t.ops)]
    gpu = Cluster(8, cfg, hi, switch_mode="pallas", device="cuda")
    # auto mode sends every CADD group through the serial engine
    auto = Cluster(8, cfg, hi, switch_mode="auto", device="cuda")
    cpu = Cluster(8, cfg, hi, switch_mode="pallas", device="cpu")
    for c in (gpu, auto, cpu):
        for k in smallbank.hot_keys(p):
            c.load(k, 100)
        c.snapshot_offload()

    def run(c):
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, len(txns), B):
            out += c.run_batch(copy.deepcopy(txns[i:i + B]))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _reset(tk)
    out_gpu, t_gpu = run(gpu)
    launches = dict(tk.LAUNCHES)
    out_auto, t_auto = run(auto)
    out_cpu, _ = run(cpu)
    check(launches["switch_txn_smem"] > 0, "cadd: switch_txn not launched")
    check(out_gpu == out_cpu, "cadd: per-txn results differ from CPU port")
    check(out_auto == out_cpu, "cadd: auto-mode results differ from CPU port")
    _same_clusters(gpu, cpu, "cadd")
    _same_clusters(auto, cpu, "cadd auto")
    print(f"cadd: {len(txns)} SmallBank txns ({gpu.stats['hot']} hot) equal "
          f"to the CPU port; launches {launches}; run_batch total pallas "
          f"{t_gpu:.4f} s, auto (serial engine) {t_auto:.4f} s", flush=True)


# --------------------------------------------------------------- phase 10 --

def _device_by_name(prof):
    """(device us, [(us, name, count)] by kernel name) of a profile."""
    total, rows = 0.0, []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")) != "DeviceType.CUDA":
            continue                 # host ops repeat their kernels' time
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            total += t
            rows.append((t, e.key, e.count))
    return total, sorted(rows, reverse=True)


def _profile_steps(fn, tries=3):
    """(device us, rows by name, attempts) of ``fn``'s second call under
    the profiler, without the profiler's own step rows.  The first call
    runs while the profiler warms up (``torch.profiler.schedule``'s
    warmup step): profiled cold, a window lost its first device event in
    PR 15's first chip run (a pruned scan's copy was seen, its kernel not).
    A window in which the profiler saw no device activity at all (which a
    call that runs a kernel or a copy cannot cause) is taken again, up to
    ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        _, rows = _device_by_name(prof)
        rows = [r for r in rows if not r[1].startswith("ProfilerStep")]
        if rows:
            break
    return sum(t for t, _, _ in rows), rows, attempt


def _profile(label, fn, top=None):
    """Wall time and device busy time of ``fn()`` under torch.profiler,
    with the ``top`` kernels by device time (all when None)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us, rows = _device_by_name(prof)
    if dev_us == 0:
        print(f"profile [{label}]: device time not measured (profiler saw "
              "no device activity)", flush=True)
        return
    short = lambda k: k.replace("(anonymous namespace)::", "").split(
        "(")[0].split("<")[0].split("::")[-1][:48]
    print(f"profile [{label}]: wall {wall * 1e3:.3f} ms (profiler on), "
          f"device busy {dev_us / 1e3:.3f} ms = {dev_us / 1e6 / wall:.4%}; "
          "by name: " + "; ".join(f"{short(k)} x{c} {t:.1f} us"
                                  for t, k, c in rows[:top]), flush=True)


def profile_batch(tk, gpu, hi, p):
    """One run_batch under the profiler, then one hot dispatch alone (B =
    256 all-hot YCSB-A txns, N = 4,096 <= SMEM_MAX_N): its device kernels
    by name must be exactly one launch of the single-CTA kernel, with no
    sort, no separate gather and no elementwise kernel around it."""
    from repro_torch.core.packets import build_packets
    from repro_torch.workloads import ycsb
    batch = ycsb.generate(np.random.default_rng(SEED + 2), B, p)
    gpu.run_batch(batch[:16])                 # warm the recovered engine
    _profile(f"one run_batch of {B} YCSB-A txns",
             lambda: gpu.run_batch(batch))

    txns = [t for t in ycsb.generate(np.random.default_rng(SEED + 6), 4 * B,
                                     p)
            if all(hi.is_hot(k) for _, k, _ in t.ops)][:B]
    pkts, meta = build_packets(txns, hi, gpu.switch_cfg)
    n = pkts["op"].size
    check(len(txns) == B and n <= tk.SMEM_MAX_N, "profile: bad hot group")
    eng = gpu.switch
    host = []
    for _ in range(51):                       # the first call warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pb = eng.execute_batch(pkts, meta, mode="pallas")
        host.append(time.perf_counter() - t0)
        pb.results_np()
    host_us = statistics.median(host[1:]) * 1e6
    dev_us, rows, attempts = _profile_steps(
        lambda: eng.execute_batch(pkts, meta, mode="pallas"))
    kernels = [(t, k, c) for t, k, c in rows
               if not k.startswith(("Memcpy", "Memset"))]
    names = "; ".join(f"{k} x{c} {t:.2f} us" for t, k, c in kernels)
    print(f"profile [one hot dispatch, B={len(txns)}, N={n}]: "
          f"{sum(c for _, _, c in kernels)} device kernel launch(es): "
          f"{names}; device total incl. copies {dev_us:.2f} us (profiler "
          f"windows taken {attempts}); host time of execute_batch alone, "
          f"median of 50: {host_us:.1f} us", flush=True)
    check(len(kernels) == 1 and kernels[0][2] == 1
          and "switch_txn_smem_kernel" in kernels[0][1],
          f"profile: a hot dispatch at N={n} ran {names or 'no kernel'}")
    return kernels[0][0], host_us


def profile_scan(tk, gpu, hi):
    """One pruned ``Cluster.scan`` over the reads cluster's hot keys
    (M = 400 slots, under SCAN_SMEM_MAX, a range of at most 16 matches so
    there is no rescan) under the profiler: it must be exactly one device
    kernel, the single-CTA scan, and one device -> host copy, with no
    host -> device copy (the engine keeps the hot set's slot list on the
    card from the scan before)."""
    hot = sorted(hi.placement.slot)
    uniq, counts = np.unique(gpu.read_batch(hot), return_counts=True)
    best = (0, 0, 0)                  # the widest run of values <= 16 rows
    for i in range(len(uniq)):
        j = i
        while j < len(uniq) and counts[i:j + 1].sum() <= 16:
            j += 1
        best = max(best, (int(counts[i:j].sum()), i, j - 1))
    count, i, j = best
    lo, hi_ = int(uniq[i]), int(uniq[j])
    check(1 <= count <= 16, f"profile: scan range holds {count} values")
    host = []
    for _ in range(21):                       # the first call warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gpu.scan(lo, hi_)
        host.append(time.perf_counter() - t0)
    check(len(out) == count, "profile: scan returned the wrong rows")
    host_us = statistics.median(host[1:]) * 1e6
    _reset(tk)
    puts = []                                 # host -> device copies
    eng = gpu.switch
    put = eng._put
    eng._put = lambda x: puts.append(x.shape) or put(x)
    try:
        dev_us, rows, attempts = _profile_steps(lambda: gpu.scan(lo, hi_))
    finally:
        del eng._put
    kernels = [(t, k, c) for t, k, c in rows
               if not k.startswith(("Memcpy", "Memset"))]
    d2h = sum(c for _, k, c in rows if "DtoH" in k)
    h2d = sum(c for _, k, c in rows if "HtoD" in k)
    other = [k for _, k, _ in rows if k.startswith(("Memcpy", "Memset"))
             and "DtoH" not in k]
    names = "; ".join(f"{k} x{c} {t:.2f} us" for t, k, c in rows)
    print(f"profile [one pruned Cluster.scan, M={len(hot)}, {count} "
          f"matches]: {names}; device total {dev_us:.2f} us; launches "
          f"{dict(tk.LAUNCHES)} over two scans; engine host -> device "
          f"copies {len(puts)}; profiler windows taken {attempts}; host "
          f"time of Cluster.scan, median of 20: {host_us:.1f} us",
          flush=True)
    check(len(kernels) == 1 and kernels[0][2] == 1
          and "scan_prune_kernel" in kernels[0][1] and d2h == 1
          and h2d == 0 and not other and not puts,
          f"profile: a pruned scan ran {names or 'nothing on the device'}, "
          f"{len(puts)} host -> device copies")
    return kernels[0][0], host_us


# --------------------------------------------------------------- phase 11 --

def _plan_checks(plan, E, C, where):
    """(b): admitted slots unique, each expert's admitted count <= C and
    equal to min(its entries, C), slot == E*C exactly where not admitted.
    Returns the number of dropped entries."""
    admit, slot = plan["admit"], plan["slot"].long()
    ids = plan["ids"].reshape(-1)[plan["order"].long()].long()
    check(bool((slot[~admit] == E * C).all()), f"{where}: a dropped entry "
          "does not carry slot E*C")
    adm = slot[admit]
    check(bool((adm < E * C).all()) and torch.unique(adm).numel()
          == adm.numel(), f"{where}: admitted slots not unique")
    check(bool((adm // C == ids[admit]).all()), f"{where}: an admitted "
          "slot lies outside its expert's rows")
    per = torch.bincount(adm // C, minlength=E)
    want = torch.bincount(ids, minlength=E).clamp_max(C)
    check(bool((per <= C).all()) and torch.equal(per, want),
          f"{where}: admitted count per expert is not min(entries, C)")
    return int((~admit).sum())


def serve_path(mr):
    """The full-width MoE serving path through ``generate``; returns the
    moe_plan launches of its counted run."""
    import dataclasses

    from repro_torch.configs.registry import get
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import lm
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.moe import capacity_for, route

    # float32 products in full float32 (the default, stated here): the
    # router, attention scores and the head run on float32 operands
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get(MOE_ARCH), n_layers=MOE_LAYERS)
    E = cfg.moe.n_experts
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(SEED))
    model = lm.LM(cfg, params)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in params.values())
    print(f"serve: {cfg.name} at full width, {cfg.n_layers} of 94 layers, "
          f"{n_bytes / 1e9:.2f} GB of bf16/fp32 parameters drawn in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (MOE_B, MOE_PROMPT))

    generate(cfg, model, {"tokens": prompts}, 2, "cuda")      # warm-up
    for k in mr.LAUNCHES:
        mr.LAUNCHES[k] = 0
    out = generate(cfg, model, {"tokens": prompts}, MOE_GEN, "cuda")
    launches = mr.LAUNCHES["moe_plan"]
    peak = torch.cuda.max_memory_allocated()
    check(launches == cfg.n_layers * MOE_GEN and mr.LAUNCHES["moe_route"]
          == 0, f"serve: launches {mr.LAUNCHES}, expected one moe_plan per "
          f"MoE layer per forward ({cfg.n_layers} per forward) and no "
          "moe_route")
    toks = out.tokens
    check(toks.shape == (MOE_B, MOE_GEN) and bool(((toks >= 0) & (
        toks < cfg.vocab_size)).all()), "serve: bad tokens")
    check(bool(torch.isfinite(out.logits).all()), "serve: non-finite logits")
    check(torch.equal(out.logits.argmax(-1).to(torch.int32), toks),
          "serve: tokens are not the logits' argmax")
    decode_ms = out.decode_seconds * 1e3 / (MOE_GEN - 1)
    print(f"serve: {MOE_B} requests x {MOE_PROMPT} prompt tokens x "
          f"{MOE_GEN} generated; prefill {out.prefill_seconds * 1e3:.3f} "
          f"ms, decode {decode_ms:.3f} ms/step = "
          f"{decode_ms / MOE_B:.4f} ms/token/seq; moe_plan launches "
          f"{launches} ({cfg.n_layers} per forward); peak memory "
          f"{peak / 1e9:.2f} GB", flush=True)

    # (a), (b): the sorted-id streams route builds from each layer's MoE
    # input, captured by forward pre-hooks over prefill + one decode step
    captured = []
    hooks = [layer.moe.register_forward_pre_hook(
        lambda mod, args, i=i: captured.append((i, args[0].clone(), args[1])))
        for i, layer in enumerate(model.layers)]
    try:
        generate(cfg, model, {"tokens": prompts}, 2, "cuda")
    finally:
        for h in hooks:
            h.remove()
    check(len(captured) == 2 * cfg.n_layers, "serve: hooks missed a layer")
    drops = {"prefill": [], "decode": []}
    with torch.inference_mode():
        for j, (i, x, cap) in enumerate(captured):
            phase = "prefill" if j < cfg.n_layers else "decode"
            want_cap = capacity_for(x.numel() // cfg.d_model, cfg.moe)
            check(cap == want_cap, f"serve: {phase} capacity {cap}")
            lp = model.layers[i].moe.weights()
            h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
            plan = route(h.reshape(-1, cfg.d_model), lp["router"], cfg.moe,
                         cap)
            ids = plan["ids"].reshape(-1)[plan["order"].long()].contiguous()
            got, want = mr.moe_route_call(ids), mr.moe_route_plain(ids)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"serve: moe_route differs from "
                  f"plain on layer {i}'s {phase} stream (N={ids.numel()})")
            want = mr.route_plan_plain(plan["ids"].reshape(-1), E, cap,
                                       cfg.moe.top_k)
            got = [plan[k] for k in ("order", "slot", "admit", "tok")]
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"serve: the routing plan differs from plain on layer "
                  f"{i}'s {phase} stream (N={ids.numel()})")
            drops[phase].append(_plan_checks(plan, E, cap,
                                             f"{phase} layer {i}"))
    caps = (capacity_for(MOE_B * MOE_PROMPT, cfg.moe),
            capacity_for(MOE_B, cfg.moe))
    print(f"serve: (a) moe_route and the moe_plan routing plan equal to "
          f"plain on the {len(captured)} real "
          f"streams (N={MOE_B * MOE_PROMPT * 8} prefill, {MOE_B * 8} decode)"
          f"; (b) plan invariants hold at capacity {caps[0]} / {caps[1]}; "
          f"entries dropped per layer: prefill {drops['prefill']}, decode "
          f"{drops['decode']}", flush=True)

    tok_t = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    tf = _teacher_forced(cfg, model, tok_t, 5e-2)
    print(f"serve: bf16 at capacity factor {cfg.moe.capacity_factor}, "
          f"teacher-forced decode over the last 8 prompt positions against "
          f"the full forward: max abs diff {tf['max']:.3e}, {tf['bad']} of "
          f"{tf['n']} logits beyond 5e-2 (reported, not checked: the two "
          "paths drop different entries)", flush=True)

    with torch.inference_mode():
        prefill = make_prefill_step(cfg)
        _profile(f"serve: prefill {MOE_B} x {MOE_PROMPT}",
                 lambda: prefill(model, {"tokens": tok_t}), top=10)
        _, cache = prefill(model, {"tokens": tok_t})
        cache = {n: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 1))
                 for n, a in cache.items()}
        pos = torch.full((MOE_B,), MOE_PROMPT, dtype=torch.int32,
                         device="cuda")
        _profile(f"serve: decode step, batch {MOE_B}", lambda: make_serve_step(
            cfg)(model, cache, {"tokens": tok_t[:, 0], "pos": pos}), top=10)
    # (c): the KV cache and decode path against the full forward, with
    # the capacity raised to E / top_k so that nothing can be dropped: at
    # the config's capacity the 256-token forward and the 248-token
    # prefill drop different entries (a batch's tokens compete for
    # capacity in flat order), which moves logits far past any tolerance
    # without a fault in the cache.  First bf16, the precision timed above,
    # on the same parameters, with cuBLAS's bf16 reduced-precision split-K
    # reductions allowed (the default) and then not; then float32
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=E / cfg.moe.top_k))
    cap_nd = capacity_for(MOE_B * MOE_PROMPT, nodrop.moe)
    mm = torch.backends.cuda.matmul
    reduced = mm.allow_bf16_reduced_precision_reduction
    readings = {}
    try:
        for flag in (reduced, not reduced):
            mm.allow_bf16_reduced_precision_reduction = flag
            readings[flag] = _teacher_forced(nodrop, lm.LM(nodrop, params),
                                             tok_t, 5e-2)
    finally:
        mm.allow_bf16_reduced_precision_reduction = reduced
    for flag, tf in readings.items():
        print(f"serve: (c) bf16, capacity {cap_nd} (nothing dropped), "
              f"allow_bf16_reduced_precision_reduction={flag}: "
              f"teacher-forced decode against the full forward, max abs "
              f"diff {tf['max']:.3e}, {tf['bad']} of {tf['n']} logits beyond "
              f"rtol/atol 5e-2; {tf['pairs'] - tf['alike']} of {tf['pairs']} "
              f"(row, position) pairs follow a token whose expert set "
              f"differs between the runs in some layer; over the other "
              f"{tf['alike']}: max abs diff {tf['max_alike']:.3e}, "
              f"{tf['bad_alike']} beyond 5e-2", flush=True)
    # bf16 rounding may flip a near-tied expert, which moves that row's
    # later logits by an expert's whole contribution; the check holds
    # every pair routed alike, and asks that those be most of them
    tf = readings[reduced]
    check(tf["bad_alike"] == 0 and 2 * tf["alike"] >= tf["pairs"],
          f"serve: (c) bf16: {tf['bad_alike']} teacher-forced decode "
          f"logits routed alike differ from the full forward beyond 5e-2 "
          f"(max {tf['max_alike']:.3e}), {tf['alike']} of {tf['pairs']} "
          "pairs routed alike")
    del model, params, cache
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(nodrop, dtype="float32")
    model = lm.LM(cfg32, lm.init_params(cfg32, torch.Generator(
        device="cuda").manual_seed(SEED)))
    tf = _teacher_forced(cfg32, model, tok_t, 1e-4)
    check(tf["bad"] == 0, f"serve: (c) float32: {tf['bad']} of {tf['n']} "
          f"teacher-forced decode logits differ from the full forward "
          f"beyond 1e-4 (max {tf['max']:.3e})")
    print(f"serve: (c) float32, capacity {cap_nd} (nothing dropped): "
          f"teacher-forced decode over the last 8 prompt positions equals "
          f"the full forward within rtol/atol 1e-4 (max abs diff "
          f"{tf['max']:.3e} over {tf['n']} logits; "
          f"{tf['pairs'] - tf['alike']} of {tf['pairs']} pairs routed "
          "differently)", flush=True)
    del model
    torch.cuda.empty_cache()
    return launches


def _teacher_forced(cfg, model, tok_t, tol):
    """Prefill all but the last 8 prompt tokens, teacher-force those 8
    through decode (tests/test_models.py:62-95) and hold each step's
    logits, and the prefill's last, against the full forward's.  Records
    each layer's expert set per token in both runs: a (row, position)
    pair is routed alike when every layer chose the same top-k experts
    for every token of that row up to that position.  Returns a dict:
    ``max``/``bad``/``n`` (max abs diff, logits beyond rtol/atol ``tol``,
    logits compared), ``pairs`` and ``alike`` ((row, position) pairs, and
    of those routed alike), and ``max_alike``/``bad_alike`` over them."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import lm
    B, L = tok_t.shape
    lp_, nl, k = L - 8, cfg.n_layers, cfg.moe.top_k
    seen = []                    # each MoE call's [T, k] expert sets
    hooks = [layer.moe.register_forward_hook(
        lambda mod, args, out: seen.append(out[1]["ids"].sort(-1).values))
        for layer in model.layers]
    try:
        with torch.inference_mode():
            full, _, _ = lm.forward(cfg, model, {"tokens": tok_t})
            last, cache = make_prefill_step(cfg)(
                model, {"tokens": tok_t[:, :lp_]})
            pairs = [(last, full[:, lp_ - 1])]
            cache = {n: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 8))
                     for n, a in cache.items()}
            step = make_serve_step(cfg)
            for i in range(lp_, L):
                pos = torch.full((B,), i, dtype=torch.int32,
                                 device=tok_t.device)
                logits, cache = step(model, cache, {"tokens": tok_t[:, i],
                                                    "pos": pos})
                pairs.append((logits, full[:, i]))
    finally:
        for h in hooks:
            h.remove()
    check(len(seen) == nl * (L - lp_ + 2), "serve: a MoE call was missed")
    per_run = [torch.stack(seen[j:j + nl]) for j in range(0, len(seen), nl)]
    want = per_run[0].reshape(nl, B, L, k)
    got = torch.cat([r.reshape(nl, B, -1, k) for r in per_run[1:]], dim=2)
    moved = (want != got).any(-1).any(0).cummax(1).values[:, lp_ - 1:]
    diff = torch.stack([(a.float() - b.float()).abs() for a, b in pairs], 1)
    ref = torch.stack([b.float().abs() for _, b in pairs], 1)
    bad = (diff > tol + tol * ref).sum(-1)                  # [B, 9]
    alike = ~moved
    return {"max": float(diff.max()), "bad": int(bad.sum()),
            "n": diff.numel(), "pairs": alike.numel(),
            "alike": int(alike.sum()),
            "max_alike": float(diff[alike].max()) if alike.any() else 0.0,
            "bad_alike": int(bad[alike].sum())}


# --------------------------------------------------------------- phase 12 --

def smoke_chain():
    """(d): the smoke config with one set of converted parameters, on the
    card and through the CPU port: float32 within 1e-3, and bf16, the
    serving precision, within 5e-2 (its capacity factor 8 drops
    nothing)."""
    import dataclasses

    from repro_torch.configs.registry import get_smoke
    from repro_torch.convert import convert_params
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm

    base = get_smoke(MOE_ARCH)
    flat = {n: t.numpy() for n, t in lm.init_params(
        dataclasses.replace(base, dtype="float32"),
        torch.Generator().manual_seed(SEED)).items()}
    prompts = np.random.default_rng(SEED + 1).integers(0, base.vocab_size,
                                                       (4, 32))
    for dtype, tol in (("float32", 1e-3), ("bfloat16", 5e-2)):
        cfg = dataclasses.replace(base, dtype=dtype)
        outs = {}
        for dev in ("cuda", "cpu"):
            params = convert_params(flat, cfg, dev)
            with torch.inference_mode():
                logits, _, _ = lm.forward(cfg, params, {
                    "tokens": torch.tensor(prompts, device=dev)})
            outs[dev] = (logits.float().cpu(), generate(
                cfg, params, {"tokens": prompts}, 4, dev))
        (lg, g), (lc, c) = outs["cuda"], outs["cpu"]
        # greedy decode feeds back its argmax: the steps are compared up
        # to the first one whose token differs on some row (its logits
        # still come from equal inputs)
        same = (g.tokens.cpu() == c.tokens).all(0).tolist() + [False]
        n = same.index(False) + 1
        gl, cl = g.logits.float().cpu()[:, :n], c.logits.float()[:, :n]
        torch.testing.assert_close(lg, lc, rtol=tol, atol=tol)
        torch.testing.assert_close(gl, cl, rtol=tol, atol=tol)
        print(f"chain: {cfg.name} {dtype} on the card equals the CPU port "
              f"within {tol:g} (forward max abs diff "
              f"{float((lg - lc).abs().max()):.3e}, generate "
              f"{float((gl - cl).abs().max()):.3e} over {min(n, 4)} of 4 "
              f"steps; tokens equal: {torch.equal(g.tokens.cpu(), c.tokens)}"
              ")", flush=True)


# --------------------------------------------------------------- phase 13 --

def _stores(c):
    return [dict(n.store) for n in c.nodes]


def tpcc_path(tk, label):
    """TPC-C at Fig 14's widest point (32 warehouses, 8 nodes, 20% remote;
    the setup of benchmarks/common.py:52-61): every txn is warm, a cold
    part under 2PL on the nodes plus a switch sub-transaction sent as its
    own B = 1 dispatch (``Cluster._run_warm``), some of them multipass.
    8 x 256 txns in ``pallas`` mode on the card against a CPU port
    cluster; then crash recovery and one warm dispatch under the
    profiler, which must be one device kernel, the single-CTA
    switch_txn."""
    from repro_torch.core.hotset import build_hot_index
    from repro_torch.core.packets import SwitchConfig, build_packets
    from repro_torch.db.dbms import Cluster
    from repro_torch.db.txn import Txn
    from repro_torch.obs.trace import Trace
    from repro_torch.workloads import tpcc

    cfg = SwitchConfig(n_stages=S, regs_per_stage=R, max_instrs=K)
    p = tpcc.TPCCParams(n_nodes=8, n_warehouses=32, dist_frac=0.2)
    t0 = time.perf_counter()
    sample = tpcc.generate(np.random.default_rng(SEED), 5000, p)
    top_k = p.n_warehouses * (1 + 2 * tpcc.N_DISTRICTS + tpcc.HOT_ITEMS)
    hi = build_hot_index(tpcc.traces(sample), top_k=top_k, switch=cfg)
    txns = tpcc.generate(np.random.default_rng(SEED + 1), 8 * B, p)
    gpu = Cluster(8, cfg, hi, switch_mode="pallas", device="cuda")
    cpu = Cluster(8, cfg, hi, switch_mode="pallas", device="cpu")
    for c in (gpu, cpu):
        c.snapshot_offload()
    print(f"tpcc: setup {time.perf_counter() - t0:.1f} s "
          f"({len(hi.placement.slot)} hot keys, single-pass rate "
          f"{hi.placement.stats['single_pass_rate']:.4f})", flush=True)

    # the warm path sends its switch sub-txn untraced: trace it here
    # (spans only; results, registers and WAL are untouched)
    warm = Trace("warm")
    run_hot = gpu._run_hot
    gpu._run_hot = lambda txn, tr=None: run_hot(txn, tr=warm)
    d0 = gpu.switch.dispatch_count
    _reset(tk)
    out_gpu, times = [], []
    for b in range(8):
        batch = txns[b * B:(b + 1) * B]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_gpu += gpu.run_batch(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(tk.LAUNCHES)
    del gpu._run_hot
    dispatches = gpu.switch.dispatch_count - d0
    batches = _batch_traces(gpu)
    spans = _span_totals(batches)
    groups = sum(s_.name == "dispatch" for tr in batches for s_ in tr.spans)

    out_cpu = []
    for b in range(8):
        out_cpu += cpu.run_batch(copy.deepcopy(txns[b * B:(b + 1) * B]))
    check(out_gpu == out_cpu, "tpcc: per-txn results differ from CPU port")
    _same_clusters(gpu, cpu, "tpcc")
    check(_stores(gpu) == _stores(cpu), "tpcc: node stores differ")
    n_warm = gpu.stats["warm"]
    check(n_warm > 0 and gpu.stats["multipass"] > 0,
          f"tpcc: no warm or no multipass txn: {dict(gpu.stats)}")
    check(launches["switch_txn_smem"] == dispatches == n_warm + groups,
          f"tpcc: {launches} for {dispatches} dispatches ({n_warm} warm, "
          f"{groups} hot groups)")
    check(launches["switch_txn"] == 0 and launches["result_gather"] == 0,
          f"tpcc: a dispatch left the single-CTA path: {launches}")

    before = gpu.switch.read_all()
    t0 = time.perf_counter()
    gpu.crash_switch_and_recover()
    t_rec = time.perf_counter() - t0
    check(before.tobytes() == gpu.switch.read_all().tobytes(),
          "tpcc: registers after crash recovery differ")

    total = sum(times)
    wspans = _span_totals([warm])
    print(f"tpcc [{label}]: {len(txns)} txns ({n_warm} warm, "
          f"{gpu.stats['multipass']} multipass, {gpu.stats['hot']} hot) in "
          f"{total:.4f} s = {len(txns) / total:.1f} txn/s; median run_batch "
          f"{statistics.median(times) * 1e3:.3f} ms; {dispatches} "
          f"dispatches ({dispatches / 8:.2f} per run_batch, {groups} hot "
          f"groups); launches {launches}; per-txn results, registers, "
          f"next_gid, stats, stores and WAL heads equal to the CPU port",
          flush=True)
    print(f"tpcc [{label}]: host spans over 8 run_batch (s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in spans.items())
          + "; warm switch sub-txns: "
          + ", ".join(f"{k} {v:.4f}" for k, v in wspans.items())
          + f"; rest (cold parts, 2PL, WAL) "
          f"{total - sum(spans.values()) - sum(wspans.values()):.4f}",
          flush=True)
    print(f"tpcc [{label}]: crash_switch_and_recover {t_rec:.2f} s, "
          "registers identical", flush=True)

    # one warm txn's switch sub-txn as _run_warm sends it (a multipass
    # one where there is one), B = 1, N = K
    subs = [Txn(t.kind, [op for op in t.ops if hi.is_hot(op[1])], t.home)
            for t in txns[:64]]
    built = [build_packets([s_], hi, cfg) for s_ in subs]
    pkts, meta = next((b for b in built if b[0]["is_multipass"][0]),
                      built[0])
    n, m = pkts["op"].size, len(meta["gather_idx"])
    check(n == K, f"tpcc: a warm dispatch has N={n}")
    eng = gpu.switch
    host, host_drain = [], []
    for _ in range(51):                       # the first call warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pb = eng.execute_batch(pkts, meta, mode="pallas")
        t1 = time.perf_counter()
        pb.results_np()
        host.append(t1 - t0)
        host_drain.append(time.perf_counter() - t0)
    host_us = statistics.median(host[1:]) * 1e6
    drain_us = statistics.median(host_drain[1:]) * 1e6
    dev_us, rows, attempts = _profile_steps(
        lambda: eng.execute_batch(pkts, meta, mode="pallas"))
    kernels = [(t, k, c) for t, k, c in rows
               if not k.startswith(("Memcpy", "Memset"))]
    names = "; ".join(f"{k} x{c} {t:.2f} us" for t, k, c in kernels)
    live = pkts["op"][0] != 0
    distinct = len(set(zip(pkts["stage"][0][live].tolist(),
                           pkts["reg"][0][live].tolist())))
    b_warm, _ = bound_ms(4 * 4 * n + 5 * n + 8 * m + 8 * distinct, n)
    print(f"profile [one warm dispatch, B=1, N={n}, M={m}, multipass "
          f"{bool(pkts['is_multipass'][0])}] [{label}]: "
          f"{sum(c for _, _, c in kernels)} device kernel launch(es): "
          f"{names}; device total incl. copies {dev_us:.2f} us (profiler "
          f"windows taken {attempts}); host time of execute_batch alone, "
          f"median of 50: {host_us:.1f} us, with results_np (the warm "
          f"path's synchronous drain): {drain_us:.1f} us; bound "
          f"{b_warm * 1e3:.5f} us ({distinct} distinct slots)", flush=True)
    check(len(kernels) == 1 and kernels[0][2] == 1
          and "switch_txn_smem_kernel" in kernels[0][1],
          f"profile: a warm dispatch ran {names or 'no kernel'}")
    return dict(tpcc_warm_launches=launches["switch_txn_smem"],
                tpcc_warm_device_us=kernels[0][0],
                tpcc_warm_host_us=host_us, tpcc_warm_drain_us=drain_us,
                tpcc_warm_bound_ms=b_warm)


# --------------------------------------------------------------- phase 14 --

def _values(c, keys):
    """Every key's committed value: its register where it is hot, else
    its home node's store."""
    from repro_torch.db.txn import node_of
    regs = c.switch.read_all()
    return [int(regs[c.hot_index.slot(k)[1:]]) if c.hot_index.is_hot(k)
            else c.nodes[node_of(k)].store[k] for k in keys]


def drift_path(tk, label):
    """The adaptive controller on the card: a YCSB hotspot shift at its
    defaults (8 nodes x 100,000 keys, 50 hot per node) on the full-width
    switch, an EpochController as in tests/test_adaptive.py:134-145
    (interval 512, top_k 400), phases (0, 0, 1, 1) x 512 txns through
    run_batch(256), against a CPU port cluster."""
    import itertools

    from repro_torch.core.heat import HeatTracker
    from repro_torch.core.hotset import build_hot_index
    from repro_torch.core.packets import SwitchConfig
    from repro_torch.db import migrate as mig
    from repro_torch.db.dbms import Cluster
    from repro_torch.workloads import drift

    cfg = SwitchConfig(n_stages=S, regs_per_stage=R, max_instrs=K)
    g = drift.YCSBHotspotShift()
    hi = build_hot_index(drift.traces(g.sample_phase(
        np.random.default_rng(SEED), 0, 800)), 400, cfg)
    phases = [g.sample_phase(np.random.default_rng(SEED + 10 + i), ph, 512)
              for i, ph in enumerate((0, 0, 1, 1))]
    real_migrate, mig_s = mig.migrate, []

    def timed_migrate(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_migrate(*a, **kw)
        torch.cuda.synchronize()
        mig_s.append(time.perf_counter() - t0)
        return out

    runs = {}
    for dev in ("cuda", "cpu"):
        c = Cluster(8, cfg, hi, switch_mode="pallas", device=dev)
        for k in g.hot_keys_at(0.0):
            c.load(k, 5)
        c.snapshot_offload()
        mig.EpochController(c, HeatTracker(window=1024, decay=0.2),
                            interval=512, top_k=400)
        # migration tids come from one module-wide counter: each cluster
        # starts it afresh, as it would in a process of its own
        mig._MIG_TID = itertools.count(1 << 40)
        if dev == "cuda":
            mig.migrate = timed_migrate
            _reset(tk)
            d0 = c.switch.dispatch_count
        out = []
        try:
            t0 = time.perf_counter()
            for txns in phases:
                for j in range(0, len(txns), B):
                    part = txns[j:j + B]
                    out += c.run_batch(part if dev == "cuda"
                                       else copy.deepcopy(part))
            if dev == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            mig.migrate = real_migrate
        if dev == "cuda":
            launches = dict(tk.LAUNCHES)
            dispatches = c.switch.dispatch_count - d0
        runs[dev] = (c, out, wall)
    (gpu, out_gpu, wall), (cpu, out_cpu, _) = runs["cuda"], runs["cpu"]
    check(out_gpu == out_cpu, "drift: per-txn results differ from CPU port")
    check(gpu.stats["migrations"] >= 1, f"drift: no migration: "
          f"{dict(gpu.stats)}")
    _same_clusters(gpu, cpu, "drift")
    check(_stores(gpu) == _stores(cpu), "drift: node stores differ")
    keys = sorted({k for txns in phases for t in txns for k in t.keys()})
    check(dict(gpu.hot_index.placement.slot)
          == dict(cpu.hot_index.placement.slot), "drift: placements differ")
    check(_values(gpu, keys) == _values(cpu, keys),
          "drift: a tuple's value differs after the last migration")
    check(launches["switch_txn_smem"] == dispatches > 0
          and launches["switch_txn"] == 0,
          f"drift: {launches} for {dispatches} dispatches")
    before = gpu.switch.read_all()
    gpu.crash_switch_and_recover()
    check(before.tobytes() == gpu.switch.read_all().tobytes(),
          "drift: registers after crash recovery differ")
    n = sum(len(t) for t in phases)
    print(f"drift [{label}]: {n} txns ({gpu.stats['hot']} hot, "
          f"{gpu.stats['warm']} warm) in {wall:.4f} s = {n / wall:.1f} "
          f"txn/s; {gpu.stats['migrations']} migrations "
          f"({gpu.stats['migrated_tuples']} tuples moved), migrate() "
          + ", ".join(f"{s_:.4f}" for s_ in mig_s) + " s; launches "
          f"{launches} for {dispatches} dispatches; results, registers, "
          f"stores, stats, WAL heads and {len(keys)} tuple values equal to "
          "the CPU port; registers identical after crash recovery",
          flush=True)


# --------------------------------------------------------------- phase 15 --

def openloop_path(tk, label, rate):
    """The open-loop serving front end: ``serve_open_loop`` on a fresh
    full-width YCSB-A cluster (as phase 4 sets it up) per rate, 4,096
    Poisson arrivals at 0.5x, 1x and 2x of phase 4's txn/s, batch 256.
    Its clock synchronizes the card first, so a group's service time
    holds its device work.  Registers, stores and next_gid must equal a
    CPU port cluster that ran the same txns in arrival order."""
    from repro_torch.core.hotset import build_hot_index
    from repro_torch.core.packets import SwitchConfig
    from repro_torch.db.dbms import Cluster
    from repro_torch.obs import find_knee, poisson_arrivals, serve_open_loop
    from repro_torch.workloads import ycsb

    n = 4096
    cfg = SwitchConfig(n_stages=S, regs_per_stage=R, max_instrs=K)
    p = ycsb.YCSBParams(variant="A")
    sample = ycsb.generate(np.random.default_rng(SEED), 4000, p)
    hi = build_hot_index(ycsb.traces(sample), top_k=400, switch=cfg)
    txns = ycsb.generate(np.random.default_rng(SEED + 1), n, p)
    cpu = Cluster(8, cfg, hi, switch_mode="pallas", device="cpu")
    cpu.snapshot_offload()
    for j in range(0, n, B):
        cpu.run_batch(copy.deepcopy(txns[j:j + B]))

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    import gc
    gc_pauses, gc_t0 = [], {}

    def on_gc(phase, info):                   # Python's collector pauses
        if phase == "start":
            gc_t0["t"] = time.perf_counter()
        elif "t" in gc_t0:
            gc_pauses.append((info["generation"],
                              time.perf_counter() - gc_t0.pop("t")))

    rows, dispatches = [], 0
    _reset(tk)
    for mult in (0.5, 1.0, 2.0):
        gpu = Cluster(8, cfg, hi, switch_mode="pallas", device="cuda")
        gpu.snapshot_offload()
        d0 = gpu.switch.dispatch_count
        arr = poisson_arrivals(mult * rate, n, seed=SEED)
        groups, run_batch = [], gpu.run_batch

        def timed_run_batch(part):            # each group's size and time
            t0 = clock()
            out = run_batch(part)
            groups.append((len(part), clock() - t0))
            return out

        gpu.run_batch = timed_run_batch
        served = copy.deepcopy(txns)
        gc_pauses.clear()
        gc.callbacks.append(on_gc)
        try:
            res = serve_open_loop(gpu, served, arr, batch=B, clock=clock)
        finally:
            gc.callbacks.remove(on_gc)
        del gpu.run_batch
        gc2 = [t for gen, t in gc_pauses if gen == 2]
        sizes = [g_ for g_, _ in groups]
        full = [t for g_, t in groups if g_ == B] or [0.0]
        dispatches += gpu.switch.dispatch_count - d0
        check(res["served"] == n and res["dropped"] == 0,
              f"openloop: served {res['served']}, dropped {res['dropped']}")
        check(np.array_equal(gpu.switch.read_all(), cpu.switch.read_all()),
              f"openloop: registers differ from the CPU port at {mult}x")
        check(gpu.switch.next_gid == cpu.switch.next_gid,
              f"openloop: next_gid differs at {mult}x")
        check(_stores(gpu) == _stores(cpu),
              f"openloop: node stores differ at {mult}x")
        rows.append(res)
        print(f"openloop [{label}]: {mult}x = offered "
              f"{res['offered_rate']:.1f} txn/s: achieved "
              f"{res['achieved_rate']:.1f} txn/s, p50 {res['p50'] * 1e3:.3f}"
              f" ms, p99 {res['p99'] * 1e3:.3f} ms, p999 "
              f"{res['p999'] * 1e3:.3f} ms, mean {res['mean'] * 1e3:.3f} "
              f"ms, utilization {res['utilization']:.4f}, backlog peak "
              f"{res['backlog_peak']}; {len(groups)} groups of mean size "
              f"{statistics.mean(sizes):.1f} ({sizes.count(B)} full), "
              f"run_batch per group median "
              f"{statistics.median(t for _, t in groups) * 1e3:.3f} ms, "
              f"max {max(t for _, t in groups) * 1e3:.3f} ms, per full "
              f"group median {statistics.median(full) * 1e3:.3f} ms; "
              f"Python gc: {len(gc_pauses)} collections, "
              f"{sum(t for _, t in gc_pauses) * 1e3:.3f} ms, of which "
              f"{len(gc2)} of generation 2, {sum(gc2) * 1e3:.3f} ms; "
              "registers, stores and next_gid equal to the CPU port",
              flush=True)
    launches = dict(tk.LAUNCHES)
    check(launches["switch_txn_smem"] == dispatches > 0
          and launches["switch_txn"] == 0,
          f"openloop: {launches} for {dispatches} dispatches")
    print(f"openloop [{label}]: knee (achieved >= 0.9 x offered) "
          f"{find_knee(rows):.1f} txn/s of rows at "
          + ", ".join(f"{r['offered_rate']:.1f}" for r in rows)
          + f"; launches {launches} for {dispatches} dispatches",
          flush=True)



def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.moe_route import moe_route as mr
    from repro_torch.kernels.switch_txn import switch_txn as tk

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {name} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.LIBRARIES)) as pool:  # one nvcc each
        libs = dict(zip(build.LIBRARIES,
                        pool.map(build.library, build.LIBRARIES)))
    lib = libs["switch_txn"]
    nvcc = ", ".join(f"{n} {build.build_seconds[n]:.2f} s"
                     if n in build.build_seconds else f"{n} cached"
                     for n in libs)
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, concurrent: "
          f"{nvcc})", flush=True)
    for n_, log in build.ptxas_log.items():
        print(f"build: ptxas {n_}: " + "; ".join(_ptxas_lines(log)),
              flush=True)

    kernels = kernel_checks(tk, lib, dev)
    kernels.append(scan_kernel_checks(tk, lib, dev))
    kernels.append(moe_route_checks(mr, libs["moe_route"], dev))
    main_launches, gpu, cpu, hi, p, main_rate = main_path(tk, smi)
    launches = {"switch_txn": main_launches["switch_txn_smem"]}
    launches["result_gather"] = read_path(tk, gpu, cpu, hi)["result_gather"]
    scan_launches, scan_gpu = scan_path(tk)
    launches["scan_prune"] = scan_launches["scan_prune"]
    sharded_path(tk, scan_gpu, p)
    async_read_path(tk, hi, p)
    cadd_path(tk)
    kernels[0]["dispatch_device_us"], kernels[0]["dispatch_host_us"] = \
        profile_batch(tk, gpu, hi, p)
    kernels[2]["scan_device_us"], kernels[2]["scan_host_us"] = \
        profile_scan(tk, gpu, hi)
    launches["moe_route"] = serve_path(mr)
    for kd in kernels:
        kd["launches"] = launches[kd["name"]]
    check(all(kd["launches"] > 0 for kd in kernels),
          f"a kernel was not launched on its path: {launches}")
    smoke_chain()
    kernels[0].update(tpcc_path(tk, smi))
    drift_path(tk, smi)
    openloop_path(tk, smi, main_rate)

    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
