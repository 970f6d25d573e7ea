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
              stores and next_gid against a CPU port cluster;
16. train   — the model zoo's training path: (a) ``qwen3_moe_235b_a22b``
              at full width cut to 2 layers, bf16, int8 AdamW moments,
              4 steps of 8 x 512 synthetic tokens through
              ``make_train_step`` (32,768 ids a plan: one moe_route
              launch per layer per step, none in the backward), the
              step-0 loss against ``loss_fn``, moe_route and the plan on
              the real streams, the sliced AdamW update against an
              unsliced one, step time, tokens/s, MFU, peak memory, the
              optimizer's share and a profiled step; (b) the launcher
              at the smoke size, 4 steps + resume to 6 against a
              continuous 6, bit for bit under deterministic algorithms;
              (c) a float32 smoke train step on the card against the
              CPU port (loss, gradients, routing plans);
17. families — every other family of the registry at full width, bf16,
              one after another: rwkv6_7b, zamba2_2p7b, gemma_2b,
              qwen1p5_0p5b, starcoder2_15b, yi_34b, internvl2_1b (128
              patches + 128 tokens), musicgen_large (256 frames, a frame
              a decode step) and kimi_k2_1t_a32b cut to 1 of 61 layers
              (its shared expert; one moe_plan launch per forward, the
              plan against plain on every real stream); (a) 8 requests x
              256 prompt positions x 16 generated through ``generate``:
              prefill ms, decode ms a step, peak memory; (b) teacher-
              forced decode against the full forward in bf16 (5e-2 of
              each position's logit scale, on the pairs routed alike for
              Kimi-K2) and in float32 at 1e-4 at the deepest cut whose
              float32 parameters fit 60 GB; (c) the smoke config of every
              architecture in float32 on the card against the CPU port
              (forward, caches, decode, a train step's loss and
              gradients).

18. sharding — the sharding and dry-run group: (a) the batched moe_plan
              (one block per shard) at 2 x 16,384, 4 x 8,192 and 8 x
              4,096 ids over 128 experts and 2 x 16,384 over 384, bit for
              bit against its plain version and S single launches, timed
              beside torch.argsort; (b) phase 16's configuration with
              ``moe_arbitration_shards = 2``, 3 steps, one batched plan
              launch per layer per forward, the plans against plain, step
              time, peak memory and drops beside S = 1; (c) remat none /
              full / dots at full width, gradients equal bit for bit
              under deterministic algorithms; (d) the smoke config at
              capacity factor 1.0 with shards, token motion and dots, card
              against the CPU port; (e) a one-rank NCCL mesh: the forward
              on DTensor parameters and ``compressed_mean``; (f) the
              dry-run of three cells in subprocesses started after (c)
              (the port's fake-mesh estimates);
19. train_families — the registry's non-MoE configurations trained at
              full width on the launcher's plan (float32 moments, one
              microbatch): (a) qwen1p5_0p5b, internvl2_1b, gemma_2b,
              musicgen_large, zamba2_2p7b, rwkv6_7b, starcoder2_15b and
              yi_34b, whole or cut to the most layers (whole groups for
              Zamba2) whose step fits the card (probed at one and two),
              steps 0-3 of 8 x 512 through ``make_train_step``: the
              step-0 loss against ``loss_fn``, finite losses, changed
              parameters, no moe_route/moe_plan launch, step time,
              tokens/s, MFU, peak memory, the AdamW update's share, and
              a profiled step of each; (b) the train launcher, 4
              steps + resume to 6 against a continuous 6, bit for bit
              under deterministic algorithms: qwen1.5-0.5b at full width
              (24 layers, 8 x 512), RWKV6, Zamba2 and Kimi-K2 at the
              smoke size; (c) one layer (one group) of each family at its
              published widths in float32, a train step's loss and
              gradients on the card against the CPU port; then
              ``examples/lm_train_torch.py`` on the card, 30 steps and a
              resume to 60.

Prints a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Imports nothing
of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
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


CHILDREN = []          # subprocesses this script starts (phase 18 (f))


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    for p in CHILDREN:
        if p.poll() is None:
            p.kill()
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
    with the ``top`` kernels by device time (all when None); returns the
    busy share (None where the profiler saw no device activity)."""
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
        return None
    short = lambda k: k.replace("(anonymous namespace)::", "").split(
        "(")[0].split("<")[0].split("::")[-1][:48]
    print(f"profile [{label}]: wall {wall * 1e3:.3f} ms (profiler on), "
          f"device busy {dev_us / 1e3:.3f} ms = {dev_us / 1e6 / wall:.4%}; "
          "by name: " + "; ".join(f"{short(k)} x{c} {t:.1f} us"
                                  for t, k, c in rows[:top]), flush=True)
    return dev_us / 1e6 / wall


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


def _route_streams(mr, cfg, model, prompt, where, frames=None):
    """The routing plan on each MoE layer's real streams: forward
    pre-hooks capture each layer's input over a prefill of ``prompt`` and
    one decode step through ``generate``; route() rebuilds its plan, and
    moe_route and the plan must equal their plain versions, the plan
    meet ``_plan_checks``.  Returns (the captured (layer, x, capacity)
    triples, entries dropped per layer {"prefill": [...], "decode":
    [...]})."""
    from repro_torch.launch.serve import generate
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.moe import capacity_for, route

    E = cfg.moe.n_experts
    captured = []
    hooks = [layer.moe.register_forward_pre_hook(
        lambda mod, args, i=i: captured.append((i, args[0].clone(), args[1])))
        for i, layer in enumerate(model.layers)]
    try:
        generate(cfg, model, prompt, 2, "cuda", frames)
    finally:
        for h in hooks:
            h.remove()
    check(len(captured) == 2 * cfg.n_layers, f"{where}: hooks missed a "
          "layer")
    drops = {"prefill": [], "decode": []}
    with torch.inference_mode():
        for j, (i, x, cap) in enumerate(captured):
            phase = "prefill" if j < cfg.n_layers else "decode"
            want_cap = capacity_for(x.numel() // cfg.d_model, cfg.moe)
            check(cap == want_cap, f"{where}: {phase} capacity {cap}")
            lp = model.layers[i].moe.weights()
            h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
            plan = route(h.reshape(-1, cfg.d_model), lp["router"], cfg.moe,
                         cap)
            ids = plan["ids"].reshape(-1)[plan["order"].long()].contiguous()
            got, want = mr.moe_route_call(ids), mr.moe_route_plain(ids)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"{where}: moe_route differs from "
                  f"plain on layer {i}'s {phase} stream (N={ids.numel()})")
            want = mr.route_plan_plain(plan["ids"].reshape(-1), E, cap,
                                       cfg.moe.top_k)
            got = [plan[k] for k in ("order", "slot", "admit", "tok")]
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"{where}: the routing plan differs from plain on layer "
                  f"{i}'s {phase} stream (N={ids.numel()})")
            drops[phase].append(_plan_checks(plan, E, cap,
                                             f"{phase} layer {i}"))
    return captured, drops


def serve_path(mr):
    """The full-width MoE serving path through ``generate``; returns the
    moe_plan launches of its counted run."""
    import dataclasses

    from repro_torch.configs.registry import get
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import lm
    from repro_torch.models.moe import capacity_for

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
    # input, captured over prefill + one decode step
    captured, drops = _route_streams(mr, cfg, model, {"tokens": prompts},
                                     "serve")
    caps = (capacity_for(MOE_B * MOE_PROMPT, cfg.moe),
            capacity_for(MOE_B, cfg.moe))
    print(f"serve: (a) moe_route and the moe_plan routing plan equal to "
          f"plain on the {len(captured)} real "
          f"streams (N={MOE_B * MOE_PROMPT * 8} prefill, {MOE_B * 8} decode)"
          f"; (b) plan invariants hold at capacity {caps[0]} / {caps[1]}; "
          f"entries dropped per layer: prefill {drops['prefill']}, decode "
          f"{drops['decode']}", flush=True)

    tok_t = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    tf = _teacher_forced(cfg, model, {"tokens": tok_t}, MOE_PROMPT - 8,
                         5e-2)
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
                                             {"tokens": tok_t},
                                             MOE_PROMPT - 8, 5e-2)
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
    tf = _teacher_forced(cfg32, model, {"tokens": tok_t}, MOE_PROMPT - 8,
                         1e-4)
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


def _split_prompt(cfg, batch, lp):
    """(the prefill batch of a prompt's first ``lp`` positions, [each later
    position's decode input]): the audio stub's frames, else tokens after
    the vision stub's patches (which all go to the prefill)."""
    if cfg.frontend == "audio_stub":
        f = batch["frames"]
        return {"frames": f[:, :lp]}, [{"frames": f[:, i]}
                                       for i in range(lp, f.shape[1])]
    npt = batch["patches"].shape[1] if "patches" in batch else 0
    tok = batch["tokens"]
    pre = dict(batch, tokens=tok[:, :lp - npt])
    return pre, [{"tokens": tok[:, i]} for i in range(lp - npt, tok.shape[1])]


def _tf_decode(cfg, model, batch, lp):
    """Prefill the first ``lp`` positions of ``batch``, pad the K/V to the
    prompt's length, then teacher-force the other positions through
    decode.  Returns (the prefill's last logits, [each step's logits],
    the final cache)."""
    from repro_torch.launch.serve import pad_cache
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    pre, steps = _split_prompt(cfg, batch, lp)
    B = next(iter(batch.values())).shape[0]
    dev = next(iter(batch.values())).device
    step = make_serve_step(cfg)
    with torch.inference_mode():
        last, cache = make_prefill_step(cfg)(model, pre)
        cache = pad_cache(cache, len(steps))
        out = []
        for j, x in enumerate(steps):
            pos = torch.full((B,), lp + j, dtype=torch.int32, device=dev)
            logits, cache = step(model, cache, dict(x, pos=pos))
            out.append(logits)
    return last, out, cache


def _teacher_forced(cfg, model, batch, lp, tol):
    """Prefill the first ``lp`` positions of the prompt ``batch``,
    teacher-force the rest through decode (tests/test_models.py:62-95)
    and hold each step's logits, and the prefill's last, against the full
    forward's.  For the ``moe`` family, records each layer's expert set
    per token in both runs: a (row, position) pair is routed alike when
    every layer chose the same top-k experts for every token of that row
    up to that position (every pair is alike in the other families).
    Returns a dict: ``max``/``bad``/``n`` (max abs diff, logits beyond
    rtol/atol ``tol``, logits compared), ``scaled`` (logits beyond
    ``tol`` times the position's scale, 1 + its largest |logit|),
    ``rel`` (the largest relative L2 difference of a position's logit
    vector), ``pairs`` and ``alike`` ((row, position) pairs, and of
    those routed alike), and ``max_alike``/``bad_alike``/
    ``scaled_alike``/``rel_alike`` over them."""
    from repro_torch.models import lm
    seen, hooks = [], []       # each MoE call's [T, k] expert sets
    if cfg.family == "moe":
        hooks = [layer.moe.register_forward_hook(
            lambda mod, args, out: seen.append(out[1]["ids"].sort(-1).values))
            for layer in model.layers]
    try:
        with torch.inference_mode():
            full, _, _ = lm.forward(cfg, model, batch)
        last, steps, _ = _tf_decode(cfg, model, batch, lp)
    finally:
        for h in hooks:
            h.remove()
    B, L = full.shape[:2]
    pairs = [(a, full[:, lp - 1 + j]) for j, a in enumerate([last] + steps)]
    diff = torch.stack([(a.float() - b.float()).abs() for a, b in pairs], 1)
    ref = torch.stack([b.float().abs() for _, b in pairs], 1)
    bad = (diff > tol + tol * ref).sum(-1)                  # [B, L - lp + 1]
    scaled = (diff > tol * (1 + ref.amax(-1, keepdim=True))).sum(-1)
    rel = diff.norm(dim=-1) / ref.norm(dim=-1)
    alike = torch.ones_like(bad, dtype=torch.bool)
    if cfg.family == "moe":
        nl, k = cfg.n_layers, cfg.moe.top_k
        check(len(seen) == nl * (L - lp + 2), "teacher-forced: a MoE call "
              "was missed")
        per_run = [torch.stack(seen[j:j + nl])
                   for j in range(0, len(seen), nl)]
        want = per_run[0].reshape(nl, B, L, k)
        got = torch.cat([r.reshape(nl, B, -1, k) for r in per_run[1:]],
                        dim=2)
        alike = ~(want != got).any(-1).any(0).cummax(1).values[:, lp - 1:]
    return {"max": float(diff.max()), "bad": int(bad.sum()),
            "n": diff.numel(), "pairs": alike.numel(),
            "alike": int(alike.sum()),
            "max_alike": float(diff[alike].max()) if alike.any() else 0.0,
            "bad_alike": int(bad[alike].sum()), "scaled": int(scaled.sum()),
            "scaled_alike": int(scaled[alike].sum()),
            "rel": float(rel.max()),
            "rel_alike": float(rel[alike].max()) if alike.any() else 0.0,
            "rel_steps": [round(float(r), 5) for r in torch.where(
                alike, rel, 0).amax(0)],
            "scale": float(ref.amax(-1).median())}


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



# --------------------------------------------------------------- phase 16 --

TRAIN_LAYERS, TRAIN_B, TRAIN_SEQ, TRAIN_STEPS = 2, 8, 512, 4


def _train_flops(cfg, tokens: int, seq: int):
    """(FLOPs of one training step, active parameters per token): 6 x
    active parameters x tokens (forward 2, backward 4), plus causal
    attention, QK^T and PV over the lower triangle, 2 x seq^2 x heads x
    head_dim a sequence a layer forward, times 3 with the backward.  The
    embedding lookup is no FLOP; the head is active."""
    m, dm, dh, H, G = (cfg.moe, cfg.d_model, cfg.resolved_head_dim(),
                       cfg.n_heads, cfg.n_kv_heads)
    per_layer = (2 * dm * H * dh + 2 * dm * G * dh + dm * m.n_experts
                 + m.top_k * 3 * dm * m.d_ff_expert)
    active = cfg.n_layers * per_layer + cfg.vocab_size * dm
    attn = 3 * cfg.n_layers * (tokens // seq) * 2 * seq * seq * H * dh
    return 6 * active * tokens + attn, active


def _capture_plans(lm):
    """Wrap ``lm.moe_ffn`` so that each call's routing plan is kept;
    returns (plans, restore)."""
    plans, orig = [], lm.moe_ffn

    def moe_ffn(*args, **kwargs):
        y, plan = orig(*args, **kwargs)
        plans.append({k: v.detach() for k, v in plan.items()})
        return y, plan

    lm.moe_ffn = moe_ffn
    return plans, lambda: setattr(lm, "moe_ffn", orig)


def train_path(mr, smi):
    """(a) The training path at full width: ``qwen3_moe_235b_a22b`` cut to
    2 layers, the launcher's plan (int8 moments, one microbatch) and
    TrainConfig, ``SyntheticLM`` batches of 8 x 512 tokens, steps 0-3
    through ``make_train_step``.  Each step's plan routes 32,768 ids per
    layer, past ``PLAN_MAX_N``: ``torch.argsort`` + one ``moe_route``
    launch per layer, in the forward only.  Returns the moe_route entry's
    training numbers."""
    import dataclasses

    from repro_torch.common import hw
    from repro_torch.common.types import (ParallelConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.configs.registry import get
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import grads_of, make_train_step
    from repro_torch.models import lm
    from repro_torch.models.moe import capacity_for
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import make_plan

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 1e9, f"train: {held / 1e9:.2f} GB still allocated before "
          "the phase")
    cfg = dataclasses.replace(get(MOE_ARCH), n_layers=TRAIN_LAYERS)
    plan = make_plan(cfg, ShapeConfig("train", "train", TRAIN_SEQ, TRAIN_B),
                     None, ParallelConfig(remat="none", microbatch=1))
    check(plan.microbatch == 1 and plan.parallel.moment_dtype == "int8",
          f"train: plan {plan.describe()}")
    tc = TrainConfig(warmup_steps=10)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(SEED))
    opt = adamw.init_state(params, plan.parallel.moment_dtype)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.values())
    state_gb = torch.cuda.memory_allocated() / 1e9
    print(f"train: {cfg.name} at full width, {cfg.n_layers} of 94 layers, "
          f"{n_params:,} parameters; parameters and int8 moments "
          f"{state_gb:.2f} GB, drawn in {time.perf_counter() - t0:.2f} s; "
          f"{plan.describe()}", flush=True)
    data = SyntheticLM(cfg, TRAIN_SEQ, TRAIN_B)
    step_fn = make_train_step(cfg, plan.parallel, tc)
    b0 = {k: torch.as_tensor(v, device="cuda")
          for k, v in data.batch(0).items()}
    _reset(mr)
    with torch.no_grad():
        ref0, _ = lm.loss_fn(cfg, params, b0, plan.parallel)
        ref0 = float(ref0)
    fwd = dict(mr.LAUNCHES)
    check(fwd == {"moe_route": cfg.n_layers, "moe_plan": 0},
          f"train: a forward launched {fwd}, expected one moe_route per "
          "layer and no moe_plan")
    probe = {n: params[n][..., :8].clone() for n in ("final_norm",
                                                     "layers/wq", "embed")}
    losses, secs, per_step = [], [], []
    for s in range(TRAIN_STEPS):
        batch = data.batch(s)
        torch.cuda.synchronize()
        _reset(mr)
        t1 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        per_step.append(dict(mr.LAUNCHES))
    peak = torch.cuda.max_memory_allocated()
    train_launches = sum(p["moe_route"] for p in per_step)
    check(all(np.isfinite(losses)), f"train: losses {losses}")
    check(abs(losses[0] - ref0) <= 1e-3 * abs(ref0),
          f"train: step 0 loss {losses[0]} against loss_fn {ref0}")
    check(all(p == fwd for p in per_step),
          f"train: launches per step {per_step}, expected {fwd} (the "
          "forward's): the backward and the update launch none")
    changed = [n for n, t in probe.items()
               if not torch.equal(t, params[n][..., :8])]
    check(changed, "train: no parameter changed")
    step_s = statistics.median(secs[1:])
    tokens = TRAIN_B * TRAIN_SEQ
    flops, active = _train_flops(cfg, tokens, TRAIN_SEQ)
    mfu = flops / step_s / hw.PEAK_FLOPS_BF16
    print(f"train: {TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_SEQ} tokens; "
          f"losses {', '.join(f'{x:.6f}' for x in losses)} (step 0 "
          f"against loss_fn {ref0:.6f}: rel diff "
          f"{abs(losses[0] - ref0) / abs(ref0):.2e}); step times "
          f"{', '.join(f'{x * 1e3:.3f}' for x in secs)} ms; median of "
          f"steps 1-3 {step_s * 1e3:.3f} ms = {tokens / step_s:,.1f} "
          f"tokens/s; peak memory {peak / 1e9:.2f} GB; MFU {mfu:.4%} "
          f"({flops / 1e12:.3f} TFLOP a step = 6 x {active:,} active "
          f"parameters x {tokens} tokens + causal attention, over "
          f"{hw.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s bf16) | {smi}; "
          f"launches per step {per_step[0]} (forward alone {fwd}); "
          f"changed {changed}", flush=True)

    # moe_route and the plan on each layer's real training stream, after
    # the counted run; moe_route timed at N = 32,768 beside its plain
    # version and torch.argsort
    plans, restore = _capture_plans(lm)
    try:
        with torch.no_grad():
            lm.loss_fn(cfg, params, b0, plan.parallel)
    finally:
        restore()
    check(len(plans) == cfg.n_layers, "train: a MoE call was missed")
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    capacity = capacity_for(TRAIN_B * TRAIN_SEQ, cfg.moe)
    err = 0
    for i, p in enumerate(plans):
        ids = p["ids"].reshape(-1)
        srt = ids[p["order"].long()].contiguous()
        got, want = mr.moe_route_call(srt), mr.moe_route_plain(srt)
        torch.cuda.synchronize()
        err = max(err, int((got - want).abs().max()))
        want_plan = mr.route_plan_plain(ids, E, capacity, k)
        check(torch.equal(got, want) and all(
            torch.equal(p[n], w) for n, w in zip(
                ("order", "slot", "admit", "tok"), want_plan)),
            f"train: moe_route or the plan differs from plain on layer "
            f"{i}'s stream (N={ids.numel()})")
    srt = plans[0]["ids"].reshape(-1)[plans[0]["order"].long()].contiguous()
    n = srt.numel()
    ms = time_cuda(lambda: mr.moe_route_call(srt), 50, 11)
    plain_ms = time_cuda(lambda: mr.moe_route_plain(srt), 50, 11)
    ids0 = plans[0]["ids"].reshape(-1).contiguous()
    lib_ms = time_cuda(lambda: torch.argsort(ids0, stable=True), 50, 11)
    bnd, by = bound_ms(2 * 4 * n, 0)
    print(f"train: moe_route equal to plain on the {len(plans)} layers' "
          f"streams (N={n}); {ms * 1e3:.2f} us per call, plain "
          f"{plain_ms * 1e3:.2f} us, torch.argsort(stable) {lib_ms * 1e3:.2f}"
          f" us, bound {bnd * 1e3:.4f} us ({by})", flush=True)
    del plans

    # the optimizer alone, on real gradients: the sliced update against
    # an unsliced one on layers/wq (bit for bit), then its time
    _, grads = grads_of(cfg, plan.parallel, params, b0)
    wq = "layers/wq"
    check(len(adamw._row_slices(params[wq], adamw.SLICE_ELEMS)) > 1,
          "train: SLICE_ELEMS does not split layers/wq")
    outs = []
    for elems in (adamw.SLICE_ELEMS, params[wq].numel()):
        one = adamw.AdamWState(opt.step.clone(), *({wq: d[wq].clone()} for d
                                                   in (opt.m, opt.m_scale,
                                                       opt.v, opt.v_scale)))
        saved, adamw.SLICE_ELEMS = adamw.SLICE_ELEMS, elems
        try:
            outs.append(adamw.apply_updates({wq: params[wq].clone()},
                                            {wq: grads[wq]}, one, tc,
                                            "int8")[:2])
        finally:
            adamw.SLICE_ELEMS = saved
    (pa, sa), (pb, sb) = outs
    check(torch.equal(pa[wq], pb[wq]) and all(
        torch.equal(getattr(sa, f)[wq], getattr(sb, f)[wq])
        for f in ("m", "m_scale", "v", "v_scale")),
        "train: the sliced AdamW update differs from the unsliced one on "
        "layers/wq")
    del outs, pa, pb, sa, sb
    opt_bytes = sum(p.numel() * (2 * p.element_size() + grads[n]
                                 .element_size() + 4)
                    + 4 * 4 * opt.m_scale[n].numel()
                    for n, p in params.items())
    opt_bound, opt_by = bound_ms(opt_bytes, 0)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    params, opt, _ = adamw.apply_updates(params, grads, opt, tc, "int8")
    e1.record()
    e1.synchronize()
    opt_ms = e0.elapsed_time(e1)
    del grads
    torch.cuda.empty_cache()
    print(f"train: the sliced AdamW update equals an unsliced one on "
          f"{wq} ({params[wq].numel():,} elements, "
          f"{len(adamw._row_slices(params[wq], adamw.SLICE_ELEMS))} slices)"
          f" bit for bit; the whole update {opt_ms:.3f} ms (CUDA events) = "
          f"{opt_ms / (step_s * 1e3):.2%} of the median step; bound "
          f"{opt_bound:.3f} ms ({opt_bytes / 1e9:.2f} GB, {opt_by}) | {smi}",
          flush=True)
    _profile(f"train: one step | {smi}",
             lambda: step_fn(params, opt, data.batch(TRAIN_STEPS)), top=12)
    del params, opt, step_fn
    torch.cuda.empty_cache()
    return dict(launches=train_launches, n=n, ms=ms, plain_ms=plain_ms,
                bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                max_abs_err=err, step_ms=step_s * 1e3,
                tokens_per_s=tokens / step_s, mfu=mfu,
                peak_gb=peak / 1e9, optimizer_ms=opt_ms,
                optimizer_share=opt_ms / (step_s * 1e3), losses=losses)


# a step line of the train launcher: (step, loss, ms)
STEP_LINE = re.compile(r"step +(\d+) loss (\S+) +(\S+)ms")


def launcher_restart(mr, arch=MOE_ARCH, batch=2, seq=32, smoke=True,
                     what="train: (b)"):
    """The launcher on the card: 4 steps with a checkpoint every 2, then 6
    with resume, against a continuous 6-step run: every parameter and the
    last loss bit for bit, under ``torch.use_deterministic_algorithms``
    (this check only); a MoE config launches one moe_plan per layer per
    step.  Phase 16 (b) runs it on Qwen3-MoE at the smoke size."""
    import contextlib
    import io
    import tempfile

    from repro_torch.configs.registry import get, get_smoke
    from repro_torch.launch.train import train

    cfg = (get_smoke if smoke else get)(arch)
    kw = dict(batch=batch, seq=seq, smoke=smoke, ckpt_every=2, device="cuda")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    t0 = time.perf_counter()
    log = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as d, \
                contextlib.redirect_stdout(log):
            _reset(mr)
            train(arch, steps=4, ckpt_dir=f"{d}/a", **kw)
            resumed, loss_r = train(arch, steps=6, ckpt_dir=f"{d}/a", **kw)
            cont, loss_c = train(arch, steps=6, ckpt_dir=f"{d}/b", **kw)
            launches = dict(mr.LAUNCHES)
    finally:
        torch.use_deterministic_algorithms(prev)
    secs = time.perf_counter() - t0
    same = [n for n in cont if torch.equal(cont[n], resumed[n])]
    check(len(same) == len(cont) and loss_r == loss_c,
          f"{what} {arch}: resumed and continuous runs differ ({len(same)} "
          f"of {len(cont)} tensors equal; losses {loss_r} / {loss_c})")
    check("resumed from step 4" in log.getvalue(),
          f"{what} {arch}: the second run did not resume")
    want = {"moe_plan": cfg.n_layers * 12 if cfg.family == "moe" else 0,
            "moe_route": 0}
    check(launches == want, f"{what} {arch}: launches {launches}, expected "
          f"{want} (one moe_plan per MoE layer per step)")
    steps = STEP_LINE.findall(log.getvalue())
    print(f"{what} {cfg.name} ({'smoke size' if smoke else 'full width'}, "
          f"{cfg.n_layers} layers, {batch} x {seq}): the launcher's 4 steps "
          f"+ resume to 6 equal a continuous 6-step run bit for bit "
          f"({len(cont)} tensors; last loss {loss_c:.6f}), deterministic "
          f"algorithms on; launches {launches}; {secs:.1f} s; steps (step, "
          "loss, ms): " + " ".join(f"{a}:{b}:{c}" for a, b, c in steps),
          flush=True)
    del resumed, cont
    torch.cuda.empty_cache()


def train_chain(mr):
    """(c) One ``make_train_step`` of the smoke config in float32 on the
    card and through the CPU port, from the same converted parameters
    and batch (2 x 32 tokens, top-2: N = 128 ids, one moe_plan launch per
    layer): the loss within 1e-5, every gradient within rtol 1e-4 / atol
    1e-6, the routing plans exactly."""
    import dataclasses

    from repro_torch.common.types import ParallelConfig, TrainConfig
    from repro_torch.configs.registry import get_smoke
    from repro_torch.convert import convert_params
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import grads_of, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_smoke(MOE_ARCH), dtype="float32")
    flat = {n: t.numpy() for n, t in lm.init_params(
        cfg, torch.Generator().manual_seed(SEED)).items()}
    batch = SyntheticLM(cfg, 32, 2).batch(0)
    par = ParallelConfig(remat="none", microbatch=1, moment_dtype="float32")
    out = {}
    for dev in ("cuda", "cpu"):
        params = convert_params(flat, cfg, dev)
        _, grads = grads_of(cfg, par, params, batch)
        plans, restore = _capture_plans(lm)
        _reset(mr)
        try:
            _, _, m = make_train_step(cfg, par, TrainConfig(warmup_steps=10))(
                params, adamw.init_state(params, "float32"), batch)
        finally:
            restore()
        out[dev] = (float(m["loss"]), {n: g.cpu() for n, g in grads.items()},
                    [{k: v.cpu() for k, v in p.items()} for p in plans],
                    dict(mr.LAUNCHES))
    (lg, gg, pg, launches), (lc, gc, pc, _) = out["cuda"], out["cpu"]
    check(abs(lg - lc) <= 1e-5 * abs(lc), f"train: (c) loss {lg} against "
          f"the CPU port's {lc}")
    check(launches == {"moe_plan": cfg.n_layers, "moe_route": 0},
          f"train: (c) launches {launches}")
    worst = 0.0
    for n, g in gc.items():
        torch.testing.assert_close(gg[n], g, rtol=1e-4, atol=1e-6)
        worst = max(worst, float((gg[n] - g).abs().max()))
    check(len(pg) == len(pc) == cfg.n_layers and all(
        torch.equal(a[k], b[k]) for a, b in zip(pg, pc)
        for k in ("order", "slot", "admit", "tok", "ids")),
        "train: (c) the routing plans differ between the card and the CPU")
    print(f"train: (c) {cfg.name} float32 train step on the card equals the "
          f"CPU port: loss {lg:.7f} / {lc:.7f}, gradients max abs diff "
          f"{worst:.3e} (rtol 1e-4 / atol 1e-6), routing plans equal; "
          f"launches {launches}", flush=True)


# --------------------------------------------------------------- phase 17 --

# (arch, the prefix of the prompt that the teacher-forced check prefills:
# a multiple of the family's chunk, RWKV's 16 and Zamba2's 128)
FAMILIES = (("rwkv6_7b", 240), ("zamba2_2p7b", 128), ("gemma_2b", 248),
            ("qwen1p5_0p5b", 248), ("starcoder2_15b", 248), ("yi_34b", 248),
            ("internvl2_1b", 248), ("musicgen_large", 248),
            ("kimi_k2_1t_a32b", 248))
FAM_B, FAM_PROMPT, FAM_GEN = 8, 256, 16
BF16_BYTES, F32_BYTES = 72e9, 60e9   # parameter bytes a cut may hold
BF16_DRIFT = 0.15     # bf16 decode vs forward, relative L2 of a position


def _cut(cfg, budget: float, width: int):
    """(the most layers, whole groups for hybrid, whose parameters of
    ``width`` bytes fit in ``budget`` bytes; their parameter count)."""
    from repro_torch.models import lm
    defs = lm.build_defs(cfg)
    per_layer = sum(int(np.prod(d.shape[1:])) for n, d in defs.items()
                    if n.startswith("layers/"))
    rest = sum(int(np.prod(d.shape)) for n, d in defs.items()
               if not n.startswith("layers/"))
    n = max(0, min(cfg.n_layers, int((budget / width - rest) // per_layer)))
    if cfg.family == "hybrid":
        n -= n % cfg.hybrid.attn_every
    return n, rest + n * per_layer


def _free(base: int, what: str = "families"):
    """Collect and empty the cache between models; nothing of the last
    model may stay allocated beyond the ``base`` bytes held before."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() - base
    check(held < 0.5e9, f"{what}: {held / 1e9:.2f} GB more allocated "
          "than when the phase started, between models")


def _family_model(arch, budget, width, dtype):
    """The registry's config of ``arch`` in ``dtype``, cut to the most
    layers that ``budget`` holds, with random parameters from the seeded
    generator: (cfg, parameters, parameter count, the cut as text)."""
    import dataclasses

    from repro_torch.configs.registry import get
    from repro_torch.models import lm
    full = get(arch)
    n, count = _cut(full, budget, width)
    cfg = dataclasses.replace(full, n_layers=n, dtype=dtype)
    params = lm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(SEED))
    check(sum(t.numel() for t in params.values()) == count,
          f"families: {arch} parameter count")
    return cfg, params, count, f"{n} of {full.n_layers} layers"


def _family_prompt(cfg):
    """The serving prompt as ``serve`` draws it from the seed, on the card,
    and the audio stub's decode frames (None for the others)."""
    from repro_torch.launch.serve import prompt_batch
    rng = np.random.default_rng(SEED)
    prompt = {k: torch.as_tensor(v, device="cuda") for k, v in
              prompt_batch(cfg, rng, FAM_B, FAM_PROMPT).items()}
    frames = None
    if cfg.frontend == "audio_stub":
        frames = torch.as_tensor(rng.standard_normal(
            (FAM_B, FAM_GEN - 1, cfg.d_model)), device="cuda")
    return prompt, frames


def _prefill_ids(cfg, model, prompt, frames):
    """(layer 0's flat expert ids on a prefill of ``prompt``, its
    capacity), as route() draws them from that layer's MoE input."""
    from repro_torch.launch.serve import generate
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.moe import route
    captured = []
    hook = model.layers[0].moe.register_forward_pre_hook(
        lambda mod, args: captured.append((args[0].clone(), args[1])))
    try:
        generate(cfg, model, prompt, 1, "cuda", frames)
    finally:
        hook.remove()
    x, cap = captured[0]
    lp = model.layers[0].moe.weights()
    with torch.inference_mode():
        plan = route(rms_norm(x, lp["mlp_norm"], cfg.norm_eps).reshape(
            -1, cfg.d_model), lp["router"], cfg.moe, cap)
    return plan["ids"].reshape(-1).contiguous(), cap


def family_serve(mr, arch, lp, smi, base):
    """(a) ``generate`` at full width in bf16 and (b) teacher-forced
    decode against the full forward, in bf16 at 5e-2 and in float32 at
    1e-4 at the deepest cut that ~60 GB of float32 parameters hold.  For
    the ``moe`` family (Kimi-K2), the routing plan on every layer's real
    streams, one moe_plan launch per MoE layer per forward, and the
    plan's time on the prefill stream.  Returns this configuration's
    numbers."""
    import dataclasses

    from repro_torch.configs.registry import get
    from repro_torch.launch.serve import generate, pad_cache
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import lm
    from repro_torch.models.decode import cache_spec

    t0 = time.perf_counter()
    _free(base)
    cfg, params, count, cut = _family_model(arch, BF16_BYTES, 2, "bfloat16")
    model = lm.LM(cfg, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()      # serving's peak, not the draw
    prompt, frames = _family_prompt(cfg)
    generate(cfg, model, prompt, 2, "cuda", frames)           # warm-up
    _reset(mr)
    out = generate(cfg, model, prompt, FAM_GEN, "cuda", frames)
    launches = dict(mr.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    moe = cfg.family == "moe"
    want = {"moe_plan": cfg.n_layers * FAM_GEN if moe else 0, "moe_route": 0}
    check(launches == want, f"families: {arch} launches {launches}, "
          f"expected {want}")
    toks = out.tokens
    check(toks.shape == (FAM_B, FAM_GEN) and bool(((toks >= 0) & (
        toks < cfg.vocab_size)).all()), f"families: {arch} bad tokens")
    check(bool(torch.isfinite(out.logits).all()),
          f"families: {arch} non-finite logits")
    check(torch.equal(out.logits.argmax(-1).to(torch.int32), toks),
          f"families: {arch} tokens are not the logits' argmax")
    prefill, step = make_prefill_step(cfg), make_serve_step(cfg)
    with torch.inference_mode():
        cache = prefill(model, prompt)[1]
        spec = cache_spec(cfg, FAM_B, FAM_PROMPT)
        check({n: (tuple(t.shape), t.dtype) for n, t in cache.items()} == {
            n: (s_, d) for n, (s_, d, _) in spec.items()},
            f"families: {arch} prefill cache differs from cache_spec")
        # where the time goes: a prefill and one decode step, profiled
        _profile(f"families: {cfg.name} prefill {FAM_B} x {FAM_PROMPT}",
                 lambda: prefill(model, prompt), top=4)
        cache = pad_cache(cache, 1)
        x = dict(pos=torch.full((FAM_B,), FAM_PROMPT, dtype=torch.int32,
                                device="cuda"))
        x.update({"frames": frames[:, 0]} if frames is not None else
                 {"tokens": out.tokens[:, 0]})
        _profile(f"families: {cfg.name} decode step, batch {FAM_B}",
                 lambda: step(model, cache, x), top=4)
    del cache, x
    decode_ms = out.decode_seconds * 1e3 / (FAM_GEN - 1)
    row = dict(arch=arch, family=cfg.family, cut=cut, params=count,
               prefill_ms=out.prefill_seconds * 1e3, decode_ms=decode_ms,
               peak_gb=peak / 1e9, launches=launches)
    what = ("frames" if cfg.frontend == "audio_stub" else
            "patches + tokens" if cfg.frontend == "vision_stub" else "tokens")
    print(f"families: {cfg.name} bf16, {cut}, {count:,} parameters; "
          f"{FAM_B} requests x {FAM_PROMPT} prompt positions ({what}) x "
          f"{FAM_GEN} generated: prefill {row['prefill_ms']:.3f} ms, decode "
          f"{decode_ms:.3f} ms a step; peak memory {row['peak_gb']:.2f} GB; "
          f"launches {launches} | {smi}", flush=True)

    bf_model, bf_cfg = model, cfg
    if moe:
        drops = _route_streams(mr, cfg, model, prompt, f"families: {arch}",
                               frames)[1]
        # the plan timed on layer 0's prefill stream
        ids, cap = _prefill_ids(cfg, model, prompt, frames)
        E, k = cfg.moe.n_experts, cfg.moe.top_k
        n = ids.numel()
        ms = time_cuda(lambda: mr.route_plan_call(ids, E, cap, k), 200, 11)
        plain_ms = time_cuda(lambda: mr.route_plan_plain(ids, E, cap, k), 50,
                             5)
        lib_ms = time_cuda(lambda: torch.argsort(ids, stable=True), 200, 11)
        bnd, by = bound_ms(4 * n + 13 * n, n)
        row["plan"] = dict(n=n, capacity=cap, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=bnd, bound_by=by,
                           drops=drops)
        print(f"families: {cfg.name} moe_plan and moe_route equal to plain "
              f"on the {2 * cfg.n_layers} real streams (N={n} prefill, "
              f"{FAM_B * k} decode), plan invariants hold; dropped per "
              f"layer: prefill {drops['prefill']}, decode {drops['decode']};"
              f" the plan at N={n}, capacity {cap}: {ms * 1e3:.2f} us a "
              f"call, plain {plain_ms * 1e3:.2f} us, torch.argsort(stable) "
              f"{lib_ms * 1e3:.2f} us, bound {bnd * 1e3:.4f} us ({by})",
              flush=True)
        # (b) with nothing dropped, as phase 11 (c) does
        bf_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=E / k))
        bf_model = lm.LM(bf_cfg, params)
    # bf16, every family: each position's logit vector within relative L2
    # BF16_DRIFT of the full forward's; K/V-state families also within
    # 5e-2 of each position's logit scale (1 + its largest |logit|).
    # Elementwise rtol/atol 5e-2 is reported, not gated: over 16-128
    # decode steps the reference itself exceeds it (JAX on the CPU, smoke
    # configs at these lengths: Zamba2 5 of 264,192 logits, RWKV6 4 of
    # 34,816).  RWKV's and Mamba2's states carry bf16 rounding forward
    # through their decays: the drift grows over the first steps and
    # levels off, in the reference as in the port
    # (tests/test_torch_families.py::test_bf16_decode_drift_matches_jax).
    # Correctness of the caches is the float32 gate's
    tf = _teacher_forced(bf_cfg, bf_model, prompt, lp, 5e-2)
    ok = (tf["rel_alike"] <= BF16_DRIFT and 2 * tf["alike"] >= tf["pairs"]
          and (cfg.family in ("rwkv", "hybrid") or tf["scaled_alike"] == 0))
    row["bf16"] = tf
    print(f"families: {cfg.name} (b) bf16 teacher-forced decode of "
          f"positions {lp}-{FAM_PROMPT - 1} against the full forward: max "
          f"abs diff {tf['max']:.3e}, {tf['scaled']} of {tf['n']} logits "
          f"beyond 5e-2 of their position's scale ({tf['bad']} beyond "
          f"rtol/atol 5e-2); largest relative L2 difference of a "
          f"position {tf['rel']:.3e} (gate {BF16_DRIFT}), by step "
          f"{tf['rel_steps']}; median position scale {tf['scale']:.3f}" + (
              f"; {tf['alike']} of {tf['pairs']} (row, position) pairs "
              f"routed alike, max there {tf['max_alike']:.3e}, "
              f"{tf['scaled_alike']} beyond the scaled 5e-2 "
              f"({tf['bad_alike']} beyond rtol/atol)" if moe else ""),
          flush=True)
    row["failures"] = [] if ok else [
        f"{arch} (b) bf16 teacher-forced decode differs from the full "
        f"forward: {tf}"]
    del params, model, bf_model, out, prompt, frames
    _free(base)

    if _cut(get(arch), F32_BYTES, 4)[0] == 0:
        print(f"families: {cfg.name} (b) float32: one layer's float32 "
              "parameters exceed 60 GB; its float32 check is (c)",
              flush=True)
        row["f32"] = None
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg32, params, count32, cut32 = _family_model(arch, F32_BYTES, 4,
                                                      "float32")
        prompt, _ = _family_prompt(cfg32)
        tf = _teacher_forced(cfg32, lm.LM(cfg32, params), prompt, lp, 1e-4)
        row["f32"] = dict(tf, cut=cut32)
        print(f"families: {cfg.name} (b) float32, {cut32} ({count32:,} "
              f"parameters): teacher-forced decode against the full "
              f"forward, max abs diff {tf['max']:.3e}, {tf['bad']} of "
              f"{tf['n']} logits beyond rtol/atol 1e-4; largest relative "
              f"L2 difference of a position {tf['rel']:.3e}", flush=True)
        if tf["bad"]:
            row["failures"].append(f"{arch} (b) float32 teacher-forced "
                                   f"decode differs from the full forward: "
                                   f"{tf}")
        del params, prompt
        _free(base)
    row["seconds"] = time.perf_counter() - t0
    return row


def family_chain(mr):
    """(c) The smoke config of every architecture in float32, one set of
    converted parameters on the card and through the CPU port: the
    forward's logits and every cache entry, the prefill and teacher-
    forced decode logits and the final cache, at 1e-4; one
    ``make_train_step``: the loss within 1e-5, every gradient within
    rtol 1e-4 / atol 1e-6, or 1e-5 of the leaf's largest gradient where
    that is more (as tests/test_torch_families.py holds them)."""
    import dataclasses

    from repro_torch.common.types import ParallelConfig, TrainConfig
    from repro_torch.configs.registry import ARCHS, get_smoke
    from repro_torch.convert import convert_params
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import grads_of, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    par = ParallelConfig(remat="none", microbatch=1, moment_dtype="float32")
    report = []
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
        flat = {n: t.numpy() for n, t in lm.init_params(
            cfg, torch.Generator().manual_seed(SEED)).items()}
        batch = SyntheticLM(cfg, 32, 2).batch(0)
        out = {}
        for dev in ("cuda", "cpu"):
            params = convert_params(flat, cfg, dev)
            model = lm.LM(cfg, params)
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
                 if k != "labels"}
            with torch.inference_mode():
                logits, cache, _ = lm.forward(cfg, model, b,
                                              collect_cache=True)
            last, steps, dcache = _tf_decode(cfg, model, b, 16)
            _, grads = grads_of(cfg, par, params, batch)
            _reset(mr)
            _, _, m = make_train_step(cfg, par, TrainConfig(warmup_steps=10))(
                params, adamw.init_state(params, "float32"), batch)
            cpu = lambda d: {n: t.cpu() for n, t in d.items()}
            out[dev] = dict(logits=logits.cpu(), cache=cpu(cache),
                            decode=torch.stack([last] + steps, 1).cpu(),
                            dcache=cpu(dcache), loss=float(m["loss"]),
                            grads=cpu(grads), launches=dict(mr.LAUNCHES))
        g, c = out["cuda"], out["cpu"]
        worst = 0.0
        for what in ("logits", "decode"):
            torch.testing.assert_close(g[what], c[what], rtol=1e-4,
                                       atol=1e-4, msg=f"(c) {arch} {what}")
            worst = max(worst, float((g[what] - c[what]).abs().max()))
        for what in ("cache", "dcache"):
            for n, t in c[what].items():
                torch.testing.assert_close(g[what][n], t, rtol=1e-4,
                                           atol=1e-4,
                                           msg=f"(c) {arch} {what} {n}")
        check(abs(g["loss"] - c["loss"]) <= 1e-5 * abs(c["loss"]),
              f"families: (c) {arch} loss {g['loss']} against the CPU "
              f"port's {c['loss']}")
        gworst = 0.0
        for n, t in c["grads"].items():
            atol = max(1e-6, 1e-5 * float(t.abs().max()))
            torch.testing.assert_close(g["grads"][n], t, rtol=1e-4,
                                       atol=atol, msg=f"(c) {arch} grad {n}")
            gworst = max(gworst, float((g["grads"][n] - t).abs().max()))
        want = {"moe_plan": cfg.n_layers if cfg.family == "moe" else 0,
                "moe_route": 0}
        check(g["launches"] == want, f"families: (c) {arch} train step "
              f"launches {g['launches']}, expected {want}")
        report.append(f"{arch} logits {worst:.2e}, loss {g['loss']:.7f} / "
                      f"{c['loss']:.7f}, gradients {gworst:.2e}")
    print("families: (c) smoke configs in float32, card against the CPU "
          "port (forward, caches, prefill + 16 teacher-forced decode "
          "steps at 1e-4; a train step's loss at 1e-5, gradients at rtol "
          "1e-4): " + "; ".join(report), flush=True)


def families(mr, smi):
    """Phase 17: every other family of the registry served at full width
    (one configuration after another, each freed before the next), then
    the smoke configs on the card against the CPU port.  Returns the
    serving rows."""
    import gc
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the earlier phases' host objects (CPU port clusters, stores, WAL
    # records) stay out of the collector's passes over the decode loops
    gc.collect()
    gc.freeze()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    print(f"families: {base / 1e9:.2f} GB allocated before the "
          f"phase; {gc.get_freeze_count():,} host objects frozen",
          flush=True)
    rows = [family_serve(mr, arch, lp, smi, base) for arch, lp in FAMILIES]
    failures = [f for r in rows for f in r["failures"]]
    check(not failures, "families: " + " | ".join(failures))
    family_chain(mr)
    print("families: " + "; ".join(
        f"{r['arch']} ({r['cut']}) prefill {r['prefill_ms']:.3f} ms, "
        f"decode {r['decode_ms']:.3f} ms/step, peak {r['peak_gb']:.2f} GB, "
        f"{r['seconds']:.1f} s" for r in rows), flush=True)
    print(f"families: phase 17 took {time.perf_counter() - t0:.1f} s",
          flush=True)
    gc.unfreeze()
    return rows


# --------------------------------------------------------------- phase 18 --

# (shards, ids per shard, experts): Qwen3-MoE training's streams under
# moe_arbitration_shards = 2, 4, 8 (8 x 512 tokens x top-8), and one at
# Kimi-K2's 384 experts
PLAN_SHARDS = ((2, 16384, 128), (4, 8192, 128), (8, 4096, 128),
               (2, 16384, 384))
DRY_CELLS = (("qwen3-moe-235b-a22b", "train_4k", "single"),
             ("yi-34b", "decode_32k", "single"),
             ("zamba2-2.7b", "long_500k", "multi"))


def _cap_l(capacity: int, shards: int) -> int:
    """moe_ffn_sharded's per-shard capacity."""
    return max(8, (-(-capacity // shards) // 8) * 8 + 8)


def _capture_moe(lm):
    """Wrap ``lm.moe_ffn`` and ``lm.moe_ffn_sharded`` so that each call's
    routing plan is kept; returns (plans, restore)."""
    plans, saved = [], {}
    for name in ("moe_ffn", "moe_ffn_sharded"):
        saved[name] = orig = getattr(lm, name)

        def wrapped(*args, _orig=orig, **kwargs):
            y, plan = _orig(*args, **kwargs)
            plans.append({k: v.detach() for k, v in plan.items()})
            return y, plan

        setattr(lm, name, wrapped)
    return plans, lambda: [setattr(lm, n, o) for n, o in saved.items()]


def _shard_plans_equal(mr, plan, shards, E, cap, k, where):
    """A captured per-shard plan ([S * n] fields, each shard's positions
    relative to it) against the plain plan of each shard; returns the
    dropped entries."""
    ids = plan["ids"].reshape(shards, -1).to(torch.int32).contiguous()
    want = mr.route_plan_plain(ids, E, cap, k)
    for f, w in zip(("order", "slot", "admit", "tok"), want):
        check(torch.equal(plan[f].reshape(shards, -1), w),
              f"{where}: the per-shard plan's {f} differs from plain")
    for s in range(shards):
        _plan_checks({"ids": ids[s], **{f: plan[f].reshape(shards, -1)[s]
                                        for f in ("order", "slot",
                                                  "admit")}},
                     E, cap, f"{where} shard {s}")
    return int((~plan["admit"]).sum())


def batched_plan_checks(mr):
    """(a) The batched moe_plan (one block per shard) at PLAN_SHARDS on
    skewed ids (half the entries on 4 hot experts): bit for bit against
    its plain version and against S launches of the single-stream plan,
    the plan's invariants per shard, one launch a call; then timed with
    CUDA events beside S single launches, the plain version and
    torch.argsort on the same [S, n] ids."""
    from repro_torch.configs.registry import get
    from repro_torch.models.moe import capacity_for
    rng = np.random.default_rng(SEED + 180)
    rows = []
    for S, n, E in PLAN_SHARDS:
        hot = rng.integers(0, E, 4)
        ids = np.where(rng.random((S, n)) < 0.5,
                       hot[rng.integers(0, 4, (S, n))],
                       rng.integers(0, E, (S, n))).astype(np.int32)
        t = torch.tensor(ids, device="cuda")
        moe = dataclasses.replace(get(MOE_ARCH).moe, n_experts=E)
        k = moe.top_k
        cap = _cap_l(capacity_for(S * n // k, moe), S)
        before = dict(mr.LAUNCHES)
        got = mr.route_plan_call(t, E, cap, k)
        launched = {x: mr.LAUNCHES[x] - before[x] for x in before
                    if mr.LAUNCHES[x] != before[x]}
        check(launched == {"moe_plan": 1}, f"sharding: (a) S={S} n={n} "
              f"launched {launched}, expected one moe_plan")
        want = mr.route_plan_plain(t, E, cap, k)
        single = [t[s].contiguous() for s in range(S)]
        ones = [mr.route_plan_call(r, E, cap, k) for r in single]
        torch.cuda.synchronize()
        drops = 0
        for f, (a, b) in enumerate(zip(got, want)):
            check(a.shape == (S, n) and a.dtype == b.dtype
                  and torch.equal(a, b), f"sharding: (a) S={S} n={n} E={E}"
                  f": batched plan field {f} differs from plain")
            for s in range(S):
                check(torch.equal(a[s], ones[s][f]), f"sharding: (a) S={S} "
                      f"shard {s}: batched plan differs from a single launch")
        for s in range(S):
            drops += _plan_checks({"ids": t[s], "order": got[0][s],
                                   "slot": got[1][s], "admit": got[2][s]},
                                  E, cap, f"(a) S={S} shard {s}")
        ms = time_cuda(lambda: mr.route_plan_call(t, E, cap, k), 50, 11)
        singles_ms = time_cuda(lambda: [mr.route_plan_call(r, E, cap, k)
                                        for r in single], 20, 11)
        plain_ms = time_cuda(lambda: mr.route_plan_plain(t, E, cap, k), 3, 5)
        lib_ms = time_cuda(lambda: torch.argsort(t, dim=-1, stable=True), 50,
                           11)
        bnd, by = bound_ms(17 * S * n, S * n)
        rows.append(dict(shards=S, n=n, n_experts=E, capacity=cap, ms=ms,
                         singles_ms=singles_ms, plain_ms=plain_ms,
                         argsort_ms=lib_ms, bound_ms=bnd, bound_by=by,
                         dropped=drops))
    print("sharding: (a) batched moe_plan equal to plain and to S single "
          "launches bit for bit, one launch a call: " + "; ".join(
              f"S={r['shards']} x {r['n']} ids, E={r['n_experts']}, C_l="
              f"{r['capacity']}: {r['ms'] * 1e3:.2f} us/call (S single "
              f"launches {r['singles_ms'] * 1e3:.2f} us, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, torch.argsort(stable) "
              f"{r['argsort_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.5f} us ({r['bound_by']}); "
              f"{r['dropped']} dropped)" for r in rows), flush=True)
    return rows


def sharded_train(mr, smi, train16):
    """(b) Phase 16's configuration with moe_arbitration_shards = 2: 3
    steps of 8 x 512 tokens, each layer's plan one batched moe_plan
    launch of 2 x 16,384 ids (no moe_route); the plans against the plain
    per-shard plans; step time, peak memory and dropped entries beside
    S = 1.  (c) remat none / full / dots on the same parameters and
    batch: forward + backward time and peak memory of each, the
    gradients of full and dots equal to none's bit for bit under
    deterministic algorithms.  Returns (the sharded path's numbers, the
    remat rows)."""
    from repro_torch.common.types import (ParallelConfig, ShapeConfig,
                                          TrainConfig)
    from repro_torch.configs.registry import get
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import grads_of, make_train_step
    from repro_torch.models import lm
    from repro_torch.models.moe import capacity_for
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import make_plan

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get(MOE_ARCH), n_layers=TRAIN_LAYERS)
    E, k, S = cfg.moe.n_experts, cfg.moe.top_k, 2
    par = ParallelConfig(remat="none", microbatch=1,
                         moe_arbitration_shards=S)
    plan = make_plan(cfg, ShapeConfig("train", "train", TRAIN_SEQ, TRAIN_B),
                     None, par)
    check(plan.parallel.moment_dtype == "int8" and plan.microbatch == 1,
          f"sharding: plan {plan.describe()}")
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(SEED))
    opt = adamw.init_state(params, "int8")
    data = SyntheticLM(cfg, TRAIN_SEQ, TRAIN_B)
    step_fn = make_train_step(cfg, plan.parallel, TrainConfig(warmup_steps=10))
    secs, losses, per_step = [], [], []
    for s in range(3):
        batch = data.batch(s)
        torch.cuda.synchronize()
        _reset(mr)
        t1 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        per_step.append(dict(mr.LAUNCHES))
    peak = torch.cuda.max_memory_allocated()
    want = {"moe_plan": cfg.n_layers, "moe_route": 0}
    check(all(p == want for p in per_step), f"sharding: (b) launches per "
          f"step {per_step}, expected {want}: one batched moe_plan a layer")
    check(all(np.isfinite(losses)), f"sharding: (b) losses {losses}")
    launches = sum(p["moe_plan"] for p in per_step)

    b0 = {n: torch.as_tensor(v, device="cuda")
          for n, v in data.batch(3).items()}
    capacity = capacity_for(TRAIN_B * TRAIN_SEQ, cfg.moe)
    cap_l = _cap_l(capacity, S)
    drops = {}
    for shards in (S, 1):
        plans, restore = _capture_moe(lm)
        try:
            with torch.no_grad():
                lm.loss_fn(cfg, params, b0, dataclasses.replace(
                    par, moe_arbitration_shards=shards))
        finally:
            restore()
        check(len(plans) == cfg.n_layers, "sharding: a MoE call was missed")
        drops[shards] = [
            _shard_plans_equal(mr, p, shards, E, cap_l if shards > 1
                               else capacity, k, f"(b) S={shards} layer {i}")
            for i, p in enumerate(plans)]
    plans, restore = _capture_moe(lm)
    try:
        with torch.no_grad():
            lm.loss_fn(cfg, params, b0, par)
    finally:
        restore()
    ids = plans[0]["ids"].reshape(S, -1).to(torch.int32).contiguous()
    del plans
    ms = time_cuda(lambda: mr.route_plan_call(ids, E, cap_l, k), 50, 11)
    plain_ms = time_cuda(lambda: mr.route_plan_plain(ids, E, cap_l, k), 3,
                         5)
    lib_ms = time_cuda(lambda: torch.argsort(ids, dim=-1, stable=True), 50,
                       11)
    bnd, by = bound_ms(17 * ids.numel(), ids.numel())
    step_ms = statistics.median(secs[1:]) * 1e3
    print(f"sharding: (b) {cfg.name} {cfg.n_layers} layers, 8 x 512 tokens, "
          f"moe_arbitration_shards={S} (C_l {cap_l} per shard, C "
          f"{capacity} global): losses {', '.join(f'{x:.6f}' for x in losses)}"
          f"; step times {', '.join(f'{x * 1e3:.3f}' for x in secs)} ms, "
          f"median of steps 1-2 {step_ms:.3f} ms (S=1, phase 16: "
          f"{train16['step_ms']:.3f} ms); peak {peak / 1e9:.2f} GB (S=1: "
          f"{train16['peak_gb']:.2f} GB); dropped per layer {drops[S]} (S=1 "
          f"on the same batch: {drops[1]}); launches per step "
          f"{per_step[0]}; the plan on layer 0's real 2 x "
          f"{ids.shape[1]} ids {ms * 1e3:.2f} us/call, plain "
          f"{plain_ms * 1e3:.2f} us, torch.argsort {lib_ms * 1e3:.2f} us, "
          f"bound {bnd * 1e3:.5f} us ({by}) | {smi}",
          flush=True)
    sharded = dict(launches=launches, shards=S, n=int(ids.shape[1]),
                   capacity=cap_l, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bnd,
                   bound_by=by, step_ms=step_ms, peak_gb=peak / 1e9,
                   dropped=drops[S], dropped_global=drops[1], losses=losses)
    del opt, step_fn
    torch.cuda.empty_cache()

    # (c) remat modes, deterministic: the gradients of one forward +
    # backward, none's kept on the host
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    remat_rows, ref = [], None
    try:
        for mode in ("none", "full", "dots"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            loss, grads = grads_of(cfg, ParallelConfig(
                remat=mode, microbatch=1), params, b0)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t1
            mpeak = torch.cuda.max_memory_allocated()
            if ref is None:
                ref = (float(loss), {n: g.cpu() for n, g in grads.items()})
                same = len(grads)
            else:
                same = sum(torch.equal(g.cpu(), ref[1][n])
                           for n, g in grads.items())
                check(float(loss) == ref[0] and same == len(grads),
                      f"sharding: (c) remat={mode}: loss {float(loss)} / "
                      f"{ref[0]}, {same} of {len(grads)} gradients equal "
                      "to remat=none's bit for bit")
            remat_rows.append(dict(remat=mode, ms=sec * 1e3,
                                   peak_gb=mpeak / 1e9, equal=same))
            del grads, loss
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(prev)
    print("sharding: (c) remat at full width, forward + backward of 8 x 512 "
          "tokens under deterministic algorithms, gradients of full and "
          "dots equal to none's bit for bit: " + "; ".join(
              f"{r['remat']} {r['ms']:.3f} ms, peak {r['peak_gb']:.2f} GB"
              for r in remat_rows) + f" | {smi}", flush=True)
    del params, ref
    torch.cuda.empty_cache()
    return sharded, remat_rows


def sharding_chain(mr):
    """(d) The smoke config at capacity factor 1.0 in float32, one set of
    converted parameters on the card and through the CPU port, with
    moe_arbitration_shards = 2, then moe_token_motion, then remat dots:
    the loss within 1e-5, gradients within rtol 1e-4 / atol 1e-6, the
    routing plans exactly."""
    from repro_torch.common.types import ParallelConfig
    from repro_torch.configs.registry import get_smoke
    from repro_torch.convert import convert_params
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import grads_of
    from repro_torch.models import lm

    cfg = get_smoke(MOE_ARCH)
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))
    flat = {n: t.numpy() for n, t in lm.init_params(
        cfg, torch.Generator().manual_seed(SEED)).items()}
    batch = SyntheticLM(cfg, 32, 2).batch(0)
    report = []
    for kw in (dict(moe_arbitration_shards=2), dict(moe_token_motion=True),
               dict(remat="dots")):
        par = ParallelConfig(**{"remat": "none", "microbatch": 1, **kw})
        out = {}
        for dev in ("cuda", "cpu"):
            params = convert_params(flat, cfg, dev)
            plans, restore = _capture_moe(lm)
            _reset(mr)
            try:
                loss, grads = grads_of(cfg, par, params, batch)
            finally:
                restore()
            out[dev] = (float(loss), {n: g.cpu() for n, g in grads.items()},
                        [{k: v.cpu() for k, v in p.items()} for p in plans],
                        dict(mr.LAUNCHES))
        (lg, gg, pg, launches), (lc, gc, pc, _) = out["cuda"], out["cpu"]
        check(abs(lg - lc) <= 1e-5 * abs(lc), f"sharding: (d) {kw} loss "
              f"{lg} against the CPU port's {lc}")
        worst = 0.0
        for n, g in gc.items():
            torch.testing.assert_close(gg[n], g, rtol=1e-4, atol=1e-6,
                                       msg=f"(d) {kw} grad {n}")
            worst = max(worst, float((gg[n] - g).abs().max()))
        check(len(pg) == len(pc) > 0 and all(
            torch.equal(a[f], b[f]) for a, b in zip(pg, pc)
            for f in ("order", "slot", "admit", "tok", "ids")),
            f"sharding: (d) {kw}: the routing plans differ between the card "
            "and the CPU")
        check(launches["moe_plan"] >= cfg.n_layers and
              launches["moe_route"] == 0, f"sharding: (d) {kw} launches "
              f"{launches}")
        report.append(f"{kw}: loss {lg:.7f} / {lc:.7f}, gradients max abs "
                      f"diff {worst:.3e}, {sum(int((~p['admit']).sum()) for p in pg)}"
                      f" dropped, launches {launches}")
    print("sharding: (d) smoke config, capacity factor 1.0, float32, card "
          "against the CPU port (loss 1e-5, gradients rtol 1e-4 / atol "
          "1e-6, plans exactly): " + "; ".join(report), flush=True)


def nccl_mesh(mr):
    """(e) A one-rank NCCL process group (a FileStore in a temporary
    directory) and ``make_local_mesh(1, 1)`` on cuda: the smoke
    parameters distributed by ``param_shardings``, the forward under
    ``mesh_axes`` with DTensor parameters equal to the plain forward bit
    for bit; ``compressed_mean`` over the group equal to
    dequantize(quantize(x)) bit for bit."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.registry import get_smoke
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.optim.compress import (compressed_mean,
                                            dequantize_int8, quantize_int8)
    from repro_torch.parallel.ctx import mesh_axes
    from repro_torch.parallel.sharding import param_shardings, placements

    cfg = dataclasses.replace(get_smoke(MOE_ARCH), dtype="float32")
    params = lm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(SEED))
    batch = {n: torch.as_tensor(v, device="cuda")
             for n, v in SyntheticLM(cfg, 32, 2).batch(0).items()
             if n != "labels"}
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", store=dist.FileStore(f"{d}/store",
                                                             1),
                                rank=0, world_size=1)
        try:
            mesh = make_local_mesh(1, 1, "cuda")
            specs = param_shardings(cfg, mesh)
            dparams = {n: distribute_tensor(t, mesh, placements(specs[n],
                                                                mesh))
                       for n, t in params.items()}
            with torch.no_grad():
                want, _, _ = lm.forward(cfg, params, batch)
                _reset(mr)
                with mesh_axes(mesh.mesh_dim_names), implicit_replication():
                    got, _, _ = lm.forward(cfg, dparams, batch)
            launches = dict(mr.LAUNCHES)
            got = got.full_tensor() if hasattr(got, "full_tensor") else got
            check(torch.equal(got, want), "sharding: (e) the forward with "
                  "DTensor parameters differs from the plain forward")
            check(launches["moe_plan"] == cfg.n_layers, f"sharding: (e) "
                  f"launches {launches}")
            x = torch.randn(64, 96, generator=torch.Generator(
                device="cuda").manual_seed(SEED + 1), device="cuda")
            cm = compressed_mean(x, dist.group.WORLD)
            cm_mesh = compressed_mean(x, "data", mesh)
            ref = dequantize_int8(*quantize_int8(x))
            check(torch.equal(cm, ref) and torch.equal(cm_mesh, ref),
                  "sharding: (e) compressed_mean over one rank differs from "
                  "dequantize(quantize(x))")
        finally:
            dist.destroy_process_group()
    print(f"sharding: (e) one-rank NCCL mesh {tuple(mesh.shape)} "
          f"{mesh.mesh_dim_names}: the forward with DTensor parameters "
          f"equals the plain forward bit for bit (launches {launches}); "
          "compressed_mean over the group and over the mesh's data dim "
          "equals dequantize(quantize(x)) bit for bit; group destroyed",
          flush=True)


def _spec_local_bytes(cfg, shape, mesh_kind, microbatch, moment):
    """Rank 0's argument bytes of a dry-run cell from ``spec_for`` alone:
    each dim divided by the product of its axes' sizes."""
    from repro_torch.launch.specs import cache_specs, input_specs
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as Sh
    sizes = (dict(pod=2, data=16, model=16) if mesh_kind == "multi"
             else dict(data=16, model=16))

    def local(meta, spec):
        n = meta.element_size()
        for dim, part in zip(meta.shape, tuple(spec) + (None,) * 8):
            axes = () if part is None else (part if isinstance(part, tuple)
                                            else (part,))
            n *= dim // max(1, int(np.prod([sizes[a] for a in axes])))
        return n

    metas, specs = lm.abstract_params(cfg), Sh.param_shardings(cfg, sizes)
    total = sum(local(m, specs[n]) for n, m in metas.items())
    b = input_specs(cfg, shape)
    bs = Sh.batch_shardings(cfg, shape, sizes)
    total += sum(local(m, bs[n]) for n, m in b.items())
    if shape.kind == "train":
        st = adamw.abstract_state(metas, moment)
        ss = adamw.state_shardings(specs, sizes, moment)
        total += st.step.element_size()
        for f in ("m", "m_scale", "v", "v_scale"):
            total += sum(local(m, getattr(ss, f)[n])
                         for n, m in getattr(st, f).items())
    elif shape.kind == "decode":
        c = cache_specs(cfg, shape)
        cs = Sh.cache_shardings(cfg, shape.global_batch, shape.seq_len,
                                sizes)
        total += sum(local(m, cs[n]) for n, m in c.items())
    return total


def start_dryrun():
    """(f) The dry-run of DRY_CELLS, one subprocess per cell, all started
    together (CPU only: they run beside the untimed (d) and (e)).
    Returns what ``dryrun_cells`` needs."""
    out = Path("artifacts") / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    procs = [subprocess.Popen([sys.executable, "-m",
                               "repro_torch.launch.dryrun", "--arch", a,
                               "--shape", s, "--mesh", m, "--out", str(out)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a, s, m in DRY_CELLS]
    CHILDREN.extend(procs)
    return out, procs, time.perf_counter()


def dryrun_cells(started):
    """(f) Waits for the dry-run subprocesses: each must exit 0; prints
    per-device argument bytes (held equal to the local shards that
    spec_for gives), flops, collective wire bytes, peak and the roofline
    terms, the port's fake-mesh estimates."""
    from repro_torch.common.types import SHAPES_BY_NAME
    from repro_torch.configs.registry import canonical, get

    out, procs, t0 = started
    logs = [p.communicate(timeout=900)[0] for p in procs]
    secs = time.perf_counter() - t0
    rows = []
    for (a, s, m), p, log in zip(DRY_CELLS, procs, logs):
        check(p.returncode == 0, f"sharding: (f) dry-run {a} {s} {m} exited "
              f"{p.returncode}: {log[-3000:]}")
        rec = json.loads((out / f"{canonical(a)}__{s}__{m}.json")
                         .read_text())
        check(rec["status"] == "ok", f"sharding: (f) {a} {s} {m}: {rec}")
        pd, rf = rec["per_device"], rec["roofline"]
        want = _spec_local_bytes(get(a), SHAPES_BY_NAME[s], m,
                                 rec["microbatch"], rec["moment_dtype"])
        check(pd["argument_bytes"] == want, f"sharding: (f) {a} {s} {m}: "
              f"argument bytes {pd['argument_bytes']} against the local "
              f"shards of spec_for {want}")
        rows.append(dict(cell=f"{a} x {s} x {m}", chips=rec["chips"],
                         method=rec["cost_method"],
                         argument_bytes=pd["argument_bytes"],
                         flops=pd["flops"],
                         wire_bytes=pd["collective"]["wire_bytes"]["total"],
                         peak_bytes=pd["peak_bytes"],
                         compute_s=rf["compute_s"], memory_s=rf["memory_s"],
                         collective_s=rf["collective_s"],
                         dominant=rf["dominant"],
                         fallback_ops=rec.get("fallback_ops")))
    print(f"sharding: (f) dry-run, 3 cells in {secs:.1f} s beside (d), (e) "
          "(the port's "
          "fake-mesh estimates per device, rank 0; argument bytes equal "
          "to spec_for's local shards): " + "; ".join(
              f"{r['cell']} ({r['chips']} ranks, {r['method']}): args "
              f"{r['argument_bytes'] / 1e9:.3f} GB, flops {r['flops']:.4e}, "
              f"wire {r['wire_bytes']:.4e} B, peak "
              f"{r['peak_bytes'] / 1e9:.3f} GB, compute "
              f"{r['compute_s']:.4e} s / memory {r['memory_s']:.4e} s / "
              f"collective {r['collective_s']:.4e} s ({r['dominant']})"
              for r in rows), flush=True)
    return rows


def sharding(mr, smi, train16):
    """Phase 18: the sharding and dry-run group.  Returns the moe_route
    entry's ``sharded`` numbers."""
    t0 = time.perf_counter()
    rows = batched_plan_checks(mr)
    sharded, remat_rows = sharded_train(mr, smi, train16)
    # the dry-run's CPU-bound processes start after the timed parts
    # (they moved (a)'s times by up to 2.3x when they ran beside them)
    started = start_dryrun()
    sharding_chain(mr)
    nccl_mesh(mr)
    dry = dryrun_cells(started)
    print(f"sharding: phase 18 took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return dict(sharded, batched=rows, remat=remat_rows, dryrun=dry)


# --------------------------------------------------------------- phase 19 --

# (a) the registry's non-MoE configurations, trained at full width on the
# launcher's plan (float32 moments, one microbatch)
TRAIN_FAMILIES = ("qwen1p5_0p5b", "internvl2_1b", "gemma_2b",
                  "musicgen_large", "zamba2_2p7b", "rwkv6_7b",
                  "starcoder2_15b", "yi_34b")
# the block matrix each family's check probes for a change
TRAIN_PROBE = {"dense": "layers/wq", "vlm": "layers/wq", "audio": "layers/wq",
               "rwkv": "layers/tm/wr", "hybrid": "layers/wx"}
FT_B, FT_SEQ, FT_STEPS = 8, 512, 4
# bytes of the card's free memory a cut leaves beyond its projected peak
# allocation, for the caching allocator's fragmentation (before it
# reports out of memory it frees its cached blocks and retries, so most
# of the reserved-over-allocated slack the phase prints is reusable)
FT_HEADROOM = 3e9
# (c) one layer (one group for hybrid) of each family at its published
# widths in float32, card against the CPU port; 1 x 128 positions, the
# VLM's 256 patches + 128 tokens
TRAIN_CHAIN = ("qwen1p5_0p5b", "internvl2_1b", "musicgen_large", "rwkv6_7b",
               "zamba2_2p7b")
CHAIN_SEQ = 128
# each gradient's relative L2 difference, card against CPU: float32 sums
# over 4,096-wide rows and 128-position columns taken in another order
# (cuBLAS's split-K and tiles against MKL's) differ by a few ulps a sum,
# ~1e-7 relative each; 1e-4 leaves three orders for the chains of them
GRAD_REL_L2 = 1e-4
# (b) the launcher, 4 steps + resume to 6 against a continuous 6
LAUNCH_RESTART = (("qwen1.5-0.5b", dict(batch=FT_B, seq=FT_SEQ, smoke=False)),
                  ("rwkv6-7b", dict(batch=2, seq=32, smoke=True)),
                  ("zamba2-2.7b", dict(batch=2, seq=32, smoke=True)),
                  ("kimi-k2-1t-a32b", dict(batch=2, seq=32, smoke=True)))
# the example's short run on the card: --steps EX_STEPS[0], then resumed
# to EX_STEPS[1]
EX_STEPS = (30, 60)


def _unit(cfg) -> int:
    """Layers a cut moves by: hybrid's whole groups, else one."""
    return cfg.hybrid.attn_every if cfg.family == "hybrid" else 1


def _train_plan(cfg):
    """The launcher's plan for ``cfg`` at (a)'s batch
    (``launch/train.py``)."""
    from repro_torch.common.types import ParallelConfig, ShapeConfig
    from repro_torch.parallel.sharding import make_plan
    return make_plan(cfg, ShapeConfig("train", "train", FT_SEQ, FT_B), None,
                     ParallelConfig(remat="none", microbatch=1))


def _train_state(cfg, parallel):
    """Seeded random parameters on the card and zero AdamW moments."""
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    params = lm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(SEED))
    return params, adamw.init_state(params, parallel.moment_dtype)


def _probe_peak(cfg, parallel, tc, batch, base):
    """Peak bytes beyond ``base`` of a fresh state of ``cfg`` and one
    train step on ``batch``."""
    from repro_torch.launch.steps import make_train_step
    torch.cuda.reset_peak_memory_stats()
    params, opt = _train_state(cfg, parallel)
    make_train_step(cfg, parallel, tc)(params, opt, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del params, opt
    _free(base, "train_families")
    return peak


def _train_cut(full, parallel, tc, batch, base):
    """The deepest cut of ``full`` (whole groups for hybrid) whose train
    step fits the card: one step each at one and two units measures the
    fixed cost (embedding, head, the float32 logits) and the cost of a
    unit (its state and activations); the cut is the most units whose
    projected peak leaves ``FT_HEADROOM`` of the card's free memory
    free.  Returns (layers, the numbers behind the cut)."""
    unit = _unit(full)
    limit = torch.cuda.mem_get_info()[0] - FT_HEADROOM
    p1 = _probe_peak(dataclasses.replace(full, n_layers=unit), parallel, tc,
                     batch, base)
    p2 = _probe_peak(dataclasses.replace(full, n_layers=2 * unit), parallel,
                     tc, batch, base)
    per = p2 - p1
    units = min(full.n_layers // unit, 1 + int((limit - p1) // per))
    check(units >= 1, f"train_families: {full.name}: one layer's step "
          f"({p1 / 1e9:.2f} GB) does not fit the card")
    whole = p1 + (full.n_layers // unit - 1) * per
    return units * unit, dict(p1=p1, per=per, limit=limit, whole=whole,
                              projected=p1 + (units - 1) * per)


def train_family(mr, arch, smi, base):
    """(a) One configuration: its cut, steps 0-3 of 8 x 512 through
    ``make_train_step`` on the launcher's plan, the checks, step time,
    tokens/s, MFU, peak memory, the AdamW update's share and a profiled
    step.  Returns its row."""
    from repro_torch.common import hw
    from repro_torch.common.types import ShapeConfig, TrainConfig
    from repro_torch.configs.registry import get
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.dryrun import model_flops
    from repro_torch.launch.steps import grads_of, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    t0 = time.perf_counter()
    full = get(arch)
    plan = _train_plan(full)
    check(plan.microbatch == 1 and plan.parallel.moment_dtype == "float32",
          f"train_families: {arch} plan {plan.describe()}")
    par, tc = plan.parallel, TrainConfig(warmup_steps=10)
    data = SyntheticLM(full, FT_SEQ, FT_B)
    b0 = {k: torch.as_tensor(v, device="cuda")
          for k, v in data.batch(0).items()}
    n, why = _train_cut(full, par, tc, b0, base)
    cfg = dataclasses.replace(full, n_layers=n)
    cut_plan = _train_plan(cfg)
    check(cut_plan.parallel == par and cut_plan.microbatch == 1,
          f"train_families: {arch} cut to {n} layers plans "
          f"{cut_plan.describe()}")
    cut = f"{n} of {full.n_layers} layers"
    gb = lambda x: f"{x / 1e9:.2f} GB"
    reason = (f"whole model projected {gb(why['whole'])}" if
              n == full.n_layers else
              f"whole model projected {gb(why['whole'])} > {gb(why['limit'])}"
              f" (the card's free memory less {gb(FT_HEADROOM)}); "
              f"{n + _unit(full)} layers {gb(why['projected'] + why['per'])}")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_reserved()
    params, opt = _train_state(cfg, par)
    torch.cuda.synchronize()
    count = sum(t.numel() for t in params.values())
    state_gb = (torch.cuda.memory_allocated() - base) / 1e9
    step_fn = make_train_step(cfg, par, tc)
    _reset(mr)
    with torch.no_grad():
        ref0 = float(lm.loss_fn(cfg, params, b0, par)[0])
    names = ["embed" if "embed" in params else "head",
             TRAIN_PROBE[cfg.family], "final_norm"]
    probe = {nm: params[nm][..., :8].clone() for nm in names}
    losses, secs = [], []
    for s in range(FT_STEPS):
        batch = data.batch(s)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated() - base
    slack = torch.cuda.max_memory_reserved() - held - peak
    launches = dict(mr.LAUNCHES)
    check(not any(launches.values()), f"train_families: {arch} launched "
          f"{launches}: the non-MoE families route nothing")
    check(all(np.isfinite(losses)), f"train_families: {arch} losses {losses}")
    check(abs(losses[0] - ref0) <= 1e-3 * abs(ref0),
          f"train_families: {arch} step 0 loss {losses[0]} against loss_fn "
          f"{ref0}")
    changed = [nm for nm, t in probe.items()
               if not torch.equal(t, params[nm][..., :8])]
    # final_norm's bf16 entries start at 1.0, where a warm-up step's
    # update (lr x step / 10 <= 1.2e-4 here) is less than half an ulp
    # (2^-9 below 1.0) and rounds away: its update shows in its moment
    norm_m = float(opt.m["final_norm"].abs().max())
    check(names[:2] == changed[:2] and norm_m > 0,
          f"train_families: {arch} changed {changed}, final_norm's largest "
          f"|m| {norm_m}")
    step_s = statistics.median(secs[1:])
    tokens = FT_B * FT_SEQ
    flops = model_flops(cfg, ShapeConfig("train", "train", FT_SEQ, FT_B))[0]
    mfu = flops / step_s / hw.PEAK_FLOPS_BF16

    # the update alone, on real gradients
    _, grads = grads_of(cfg, par, params, b0)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    params, opt, _ = adamw.apply_updates(params, grads, opt, tc, "float32")
    e1.record()
    e1.synchronize()
    opt_ms = e0.elapsed_time(e1)
    del grads
    # the update's bytes: parameter read and written, gradient read,
    # float32 m and v each read and written
    opt_bound, _ = bound_ms(sum(t.numel() * (3 * t.element_size() + 16)
                                for t in params.values()), 0)
    busy = _profile(f"train_families: one step of {cfg.name} ({cut}) | {smi}",
                    lambda: step_fn(params, opt, batch), top=6)
    row = dict(arch=arch, family=cfg.family, cut=cut, n_layers=n, busy=busy,
               params=count, state_gb=state_gb, peak_gb=peak / 1e9,
               slack_gb=slack / 1e9,
               projected_gb=why["projected"] / 1e9, losses=losses,
               ref0=ref0, step_ms=[x * 1e3 for x in secs],
               median_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
               mfu=mfu, optimizer_ms=opt_ms, optimizer_bound_ms=opt_bound,
               optimizer_share=opt_ms / (step_s * 1e3))
    print(f"train_families: {cfg.name}, {cut} ({reason}; one layer's step "
          f"{gb(why['p1'])}, each further {_unit(full)} {gb(why['per'])}), "
          f"{count:,} parameters; parameters + float32 moments "
          f"{state_gb:.2f} GB; {plan.describe()}; {FT_STEPS} steps of {FT_B}"
          f" x {FT_SEQ}: losses {', '.join(f'{x:.6f}' for x in losses)} "
          f"(step 0 against loss_fn {ref0:.6f}: rel diff "
          f"{abs(losses[0] - ref0) / abs(ref0):.2e}); step times "
          f"{', '.join(f'{x * 1e3:.3f}' for x in secs)} ms, median of "
          f"steps 1-3 {step_s * 1e3:.3f} ms = {tokens / step_s:,.1f} "
          f"tokens/s; MFU {mfu:.4%} ({flops / 1e12:.3f} TFLOP a step = "
          f"6 x parameters x tokens, model_flops: no attention, WKV or SSD "
          f"recurrence term; over {hw.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s "
          f"bf16); peak {peak / 1e9:.2f} GB (projected "
          f"{why['projected'] / 1e9:.2f}; the allocator reserved "
          f"{slack / 1e9:.2f} GB more); AdamW {opt_ms:.3f} ms = "
          f"{opt_ms / (step_s * 1e3):.2%} of the median step, "
          f"{opt_ms / opt_bound:.1f}x its bytes bound {opt_bound:.3f} ms; "
          f"changed "
          f"{changed}, final_norm's largest |m| {norm_m:.3e}; launches "
          f"{launches} | {smi}", flush=True)
    del params, opt, step_fn, probe, b0
    _free(base, "train_families")
    row["seconds"] = time.perf_counter() - t0
    return row


def launcher_families(mr):
    """(b) ``launcher_restart`` on qwen1.5-0.5b at full width and on
    RWKV6, Zamba2 and Kimi-K2 at the smoke size."""
    for arch, kw in LAUNCH_RESTART:
        launcher_restart(mr, arch, what="train_families: (b)", **kw)


def _rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float64 (0 where both are 0)."""
    a, b = a.double(), b.double()
    den = float(b.norm())
    num = float((a - b).norm())
    return num / den if den else num


def train_chain_full(mr):
    """(c) One layer (one group for hybrid) of each family at its
    published widths in float32, one set of converted parameters on the
    card and through the CPU port, TF32 off: ``grads_of`` and one
    ``make_train_step``; the loss within 1e-5, each gradient within
    ``GRAD_REL_L2`` relative L2."""
    from repro_torch.common.types import ParallelConfig, TrainConfig
    from repro_torch.configs.registry import get
    from repro_torch.convert import convert_params
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import grads_of, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    par = ParallelConfig(remat="none", microbatch=1, moment_dtype="float32")
    report = []
    for arch in TRAIN_CHAIN:
        full = get(arch)
        cfg = dataclasses.replace(full, n_layers=_unit(full), dtype="float32")
        seq = CHAIN_SEQ + cfg.n_frontend_tokens * (
            cfg.frontend == "vision_stub")
        flat = {n: t.numpy() for n, t in lm.init_params(
            cfg, torch.Generator().manual_seed(SEED)).items()}
        batch = SyntheticLM(cfg, seq, 1).batch(0)
        out = {}
        for dev in ("cuda", "cpu"):
            params = convert_params(flat, cfg, dev)
            _, grads = grads_of(cfg, par, params, batch)
            grads = {n: g.cpu() for n, g in grads.items()}
            _reset(mr)
            _, _, m = make_train_step(cfg, par, TrainConfig(warmup_steps=10))(
                params, adamw.init_state(params, "float32"), batch)
            out[dev] = (float(m["loss"]), grads, dict(mr.LAUNCHES))
            del params
        (lg, gg, launches), (lc, gc_, _) = out["cuda"], out["cpu"]
        check(abs(lg - lc) <= 1e-5 * abs(lc), f"train_families: (c) {arch} "
              f"loss {lg} against the CPU port's {lc}")
        check(not any(launches.values()),
              f"train_families: (c) {arch} launches {launches}")
        rel = {n: _rel_l2(gg[n], g) for n, g in gc_.items()}
        worst = max(rel, key=rel.get)
        check(rel[worst] <= GRAD_REL_L2, f"train_families: (c) {arch} "
              f"gradient {worst} differs from the CPU port's by relative L2 "
              f"{rel[worst]:.3e} (gate {GRAD_REL_L2})")
        count = sum(int(np.prod(a.shape)) for a in flat.values())
        report.append(f"{arch} ({cfg.n_layers} of {full.n_layers} layers, "
                      f"{count:,} parameters, 1 x {seq}): loss {lg:.7f} / "
                      f"{lc:.7f}, worst gradient {worst} {rel[worst]:.2e}")
        del flat, out, gg, gc_
    print("train_families: (c) full width, one layer, float32, card "
          "against the CPU port (loss at 1e-5, each gradient's relative L2 "
          f"at {GRAD_REL_L2}): " + "; ".join(report) +
          f"; {time.perf_counter() - t0:.1f} s", flush=True)


def example_run(smi):
    """``examples/lm_train_torch.py`` on the card in a scratch directory:
    ``--steps`` EX_STEPS[0], then resumed to EX_STEPS[1]; its loss curve
    and step time."""
    import tempfile

    script = Path(__file__).resolve().parent / "examples" / "lm_train_torch.py"
    check(script.exists(), f"train_families: {script} is missing")
    curve, resumed = [], False
    with tempfile.TemporaryDirectory() as d:
        for steps in EX_STEPS:
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, str(script), "--steps",
                                  str(steps)], cwd=d, capture_output=True,
                                 text=True, timeout=600)
            if out.returncode != 0:
                fail(f"train_families: the example exited "
                     f"{out.returncode}: {out.stderr[-2000:]}")
            resumed |= f"resumed from step {EX_STEPS[0]}" in out.stdout
            curve += [(int(s), float(l), float(t))
                      for s, l, t in STEP_LINE.findall(out.stdout)]
            print(f"train_families: example --steps {steps}: "
                  f"{out.stdout.splitlines()[0]}; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        ckpts = sorted(os.listdir(f"{d}/artifacts/ckpt_demo"))
    check(resumed and [s for s, _, _ in curve] == list(range(EX_STEPS[1])),
          f"train_families: the example's steps {[s for s, _, _ in curve]}")
    losses = [l for _, l, _ in curve]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train_families: the example's losses {losses}")
    ms = statistics.median(t for _, _, t in curve[1:EX_STEPS[0]])
    print(f"train_families: example (4 x 256 tokens a step) loss by step "
          + " ".join(f"{s}:{l:.4f}" for s, l, _ in curve[::5])
          + f", last {losses[-1]:.4f}; median step {ms:.1f} ms (host clock, "
          f"the launcher's); checkpoints {ckpts} | {smi}", flush=True)
    return dict(losses=losses, median_ms=ms)


def train_families(mr, smi):
    """Phase 19: the registry's non-MoE configurations trained at full
    width, the launcher's restart, one-layer full-width train steps
    against the CPU port, and the training example.  Returns (a)'s rows."""
    import gc
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    check(base < 1e9, f"train_families: {base / 1e9:.2f} GB still allocated "
          "before the phase")
    rows = [train_family(mr, arch, smi, base) for arch in TRAIN_FAMILIES]
    launcher_families(mr)
    train_chain_full(mr)
    example_run(smi)
    busy = lambda r: ("not measured" if r["busy"] is None else
                      f"{r['busy']:.2%} (profiler on)")
    print("train_families: " + "; ".join(
        f"{r['arch']} ({r['cut']}) {r['median_ms']:.3f} ms a step, "
        f"{r['tokens_per_s']:,.1f} tokens/s, MFU {r['mfu']:.4%}, peak "
        f"{r['peak_gb']:.2f} GB, AdamW {r['optimizer_share']:.2%}, busy "
        f"{busy(r)}, {r['seconds']:.1f} s" for r in rows), flush=True)
    print(f"train_families: phase 19 took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rows


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    # phase 16 (b) runs under torch.use_deterministic_algorithms, which
    # asks for a fixed cuBLAS workspace before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    train = train_path(mr, smi)
    kernels[3]["train_launches"] = train.pop("launches")
    kernels[3]["train"] = train
    launcher_restart(mr)
    train_chain(mr)
    del gpu, cpu, hi, p, scan_gpu       # the P4DB clusters: done with
    fam = families(mr, smi)
    kimi = next(r for r in fam if r["family"] == "moe")
    kernels[3]["families"] = dict(arch=kimi["arch"], cut=kimi["cut"],
                                  launches=kimi["launches"]["moe_plan"],
                                  plan=kimi["plan"])
    kernels[3]["sharded"] = sharding(mr, smi, train)
    train_families(mr, smi)

    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
