"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (phase 23 uses
every visible card; one is enough).

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
              ``pallas`` mode and in ``auto`` mode (its CADD groups on the
              serial walk kernel, which must have launched), against the
              CPU port;
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
              resume to 60;
20. durability — P4DB's durability and contention-resilience paths at
              full width, each against a CPU port cluster: (a) the
              crash points mid_group_dispatch (sync and async),
              undrained_async, torn_tail, mid_migration (under an
              EpochController) and mid_failover on phase 4's YCSB-A
              cluster with a warm standby, each recovered to the CPU
              port's state and to an uncrashed card cluster of the
              surviving txns, every WAL verified, a further batch equal;
              (b) checkpoint_interval 0 / 512 / 128 / 32 on the 8 x 256
              stream: checkpoints and their cost, recover_switch's
              replay and seconds, fail_over replaying exactly the sends
              since the last checkpoint, and ``python -m
              repro_torch.db.wal verify`` on a saved WAL; (c) brown-out
              on YCSB-A and TPC-C at 32 warehouses (the reloads: one
              single-CTA switch_txn at N = 8,192, the large-N route at
              N = 32,768), equal to a cluster without it, and the
              demotion cap; (d) the ContentionArena on both storms,
              NO_WAIT / WAIT_DIE, early abort off / on (one B = 1
              switch_txn_smem launch per hot or warm dispatch); (e) the
              Prometheus export against the CPU port's; every recovery
              and takeover replay reports its launches by route (one walk
              launch a send);
21. walk    — the reference's compiled switch engines (serial, staged,
              affine) as the walk kernel: (a) each mode against its plain
              version at N = 1, 16, 4,096, 8,192, 8,193 and 32,768 on
              streams with every opcode, stray and negative slots and
              int32 wrap (registers, res, ok, compact equal; the route
              each N takes); (b) CUDA-event time per call and bare beside
              the plain version and the bytes bound; (c) one auto dispatch
              at N = 4,096 under the profiler: one device kernel, no
              device -> host copy (run right after phase 10's profiles);
              (d) ``switch_mode="auto"`` at full
              width against CPU port clusters: YCSB-A 8 x 256 and its
              recovery, sharded n = 2 beside n = 1, a safe-ADDP staged
              stream at B = 256, and the TPC-C brown-out whose N = 32,768
              reload takes the large route;
22. oltp_cluster — ``examples/oltp_cluster_torch.py``, the paper's
              8-node cluster example on the port's timing simulator (host
              only, no kernel), in a subprocess: all three sections
              printed (YCSB-A P4DB / No-Switch / lock manager in the
              switch, TPC-C, the open-loop sweep), a P4DB / No-Switch
              speedup above 1 and a saturation knee; its lines and wall
              time;
23. multicard — the multi-switch register plane across cards on phase
              4's full-width YCSB-A switch: with the default device a
              sharded switch puts plane i on ``cuda:(i % device_count)``
              (the JAX package's one-plane-a-device rule; one card holds
              every plane): (a) each plane's registers on its card at
              n_switches 2 and 4; (b) 2 x 256 YCSB-A txns at n = 1, 2, 4
              and n = 4 with async dispatch, equal to n = 1 (results,
              GIDs, per-key reads, WAL streams) and to a CPU port cluster
              (every plane's registers); (c) cross-shard rows on a
              round-robin placement in ``pallas`` mode and, with cross-
              shard ADDP, in ``auto`` mode at n = 2 and 4; (d) at n = 2
              with a standby: checkpoint, crash, recover_switch,
              fail_over, a migration and a brown-out against the CPU
              port; (e) with two cards or more, phase 4 on the last card
              (every launcher makes its tensors' card current); the
              cards, the placement, dispatches per plane and run_batch
              seconds at n = 1, 2, 4;
24. stream async — async hot dispatch on CUDA streams and events (an
              async engine on the card dispatches on the caller's thread
              under a stream of its own, pinned staging guarded by
              events): (a) phase 4's YCSB-A and phase 9's SmallBank in
              ``pallas`` and ``auto`` mode at max_inflight 2 and 4, each
              equal to a sync card cluster and an async CPU port
              cluster, no dispatch thread started; (b) a WRITE-only load
              burst three times the staging ring deep behind a spin, no
              drain, registers equal to the CPU port; (c) a deferred
              ``execute_batch`` behind a spin returns before its kernel
              ran: its host µs, then its results; (d) planes sharing a
              card at n = 2 and 4 on distinct streams; (e) sync against
              async ``run_batch`` totals at n = 1 and 4 (phase 23 (b)'s
              setup), in turns.  Phases 8, 20 and 23 run their async
              clusters on streams too.

Prints a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Imports nothing
of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
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

# torch.profiler on the H100 loses device events more and more as the
# process ages (see _window) unless CUPTI is torn down after each window
# and set up afresh; set before torch loads.
os.environ["TEARDOWN_CUPTI"] = "1"

import torch  # noqa: E402

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
    _exit(1)


def _exit(code: int):
    """Leave without the interpreter's exit: after a profiled window,
    CUPTI's teardown at exit can hang the process."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


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
                        "moe_route_kernel", "moe_plan_kernel",
                        "switch_walk_smem_kernel", "switch_walk_prep_kernel",
                        "switch_walk_link_kernel",
                        "switch_walk_gather_kernel",
                        "switch_walk_chains_kernel",
                        "switch_walk_tile_reduce_kernel",
                        "switch_walk_tile_prefix_kernel",
                        "switch_walk_tile_apply_kernel",
                        "switch_walk_fallback_prep_kernel",
                        "switch_walk_writeback_kernel", "switch_walk_kernel"):
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
    card = work.get_device()
    kernel_ms_txn = time_cuda(lambda: lib.switch_txn_smem_launch(
        card, work.data_ptr(), n_slots, R, op_t.data_ptr(), st_t.data_ptr(),
        rg_t.data_ptr(), val_t.data_ptr(), n, res_buf.data_ptr(),
        ok_buf.data_ptr(), idx_t.data_ptr(), cmp_buf.data_ptr(), m, stream),
        inner=200, reps=11)
    # the same kernel on a stream with no hot slot: load, sort and
    # epilogue without a long walk
    uni = [t(a) for a in _check_stream(np.random.default_rng(SEED + 8), n,
                                       skew=0.0)]
    uniform_ms = time_cuda(lambda: lib.switch_txn_smem_launch(
        card, work.data_ptr(), n_slots, R, uni[1].data_ptr(),
        uni[2].data_ptr(), uni[3].data_ptr(), uni[5].data_ptr(), n,
        res_buf.data_ptr(), ok_buf.data_ptr(), uni[6].data_ptr(),
        cmp_buf.data_ptr(), m, stream),
        inner=200, reps=11)
    # and at N = 16 (a B=1 group; the 256 tile): launch plus the least
    # work the kernel does
    tiny = [t(a) for a in _check_stream(np.random.default_rng(SEED + 7), 16)]
    tiny_ms = time_cuda(lambda: lib.switch_txn_smem_launch(
        card, work.data_ptr(), n_slots, R, tiny[1].data_ptr(),
        tiny[2].data_ptr(), tiny[3].data_ptr(), tiny[5].data_ptr(), 16,
        res_buf.data_ptr(), ok_buf.data_ptr(), tiny[6].data_ptr(),
        cmp_buf.data_ptr(), 16, stream), inner=200, reps=11)
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
            fn(d, src.data_ptr(), n, idx_t.data_ptr(), out.data_ptr(), m,
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
    card = flat.get_device()

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
                card, flat.data_ptr(), n_slots, ip, m, lo, hi, cap,
                out.data_ptr(), stream_h)
        else:
            n_scr = lib.scan_prune_scratch_len(m)
            scratch = torch.empty(n_scr, dtype=torch.int32, device=dev)
            check(lib.scan_prune_large_launch(
                card, flat.data_ptr(), n_slots, ip, m, lo, hi, cap,
                out.data_ptr(), scratch.data_ptr(), n_scr - 1, stream_h) != 0,
                "scan_prune_large_launch accepted a scratch one short")
            bare = lambda: lib.scan_prune_large_launch(
                card, flat.data_ptr(), n_slots, ip, m, lo, hi, cap,
                out.data_ptr(), scratch.data_ptr(), n_scr, stream_h)
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
    card = one.get_device()
    check(lib.moe_plan_launch(card, one.data_ptr(), pmax + 1, 128, 8, 8,
                              one.data_ptr(), one.data_ptr(), one.data_ptr(),
                              one.data_ptr(), 0) != 0
          and lib.moe_plan_launch(card, one.data_ptr(), 1,
                                  mr.PLAN_MAX_E + 1, 8, 8, one.data_ptr(),
                                  one.data_ptr(), one.data_ptr(),
                                  one.data_ptr(), 0) != 0,
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
            card, s_.data_ptr(), n, out.data_ptr(), stream_h), inner=200,
            reps=11)
        r_plain = time_cuda(lambda: mr.moe_route_plain(s_), inner=200,
                            reps=11)
        # the nearest single PyTorch call computes each run's first index;
        # the positions are one subtraction more
        r_lib = time_cuda(lambda: torch.searchsorted(s_, s_), inner=200,
                          reps=11)
        plan = lambda: mr.route_plan_call(t, 128, cap, 8)
        chain = lambda: mr._plan_from_sort(t, 128, cap, 8, mr.moe_route_call)
        o_p, s_p, k_p = (buf[i].data_ptr() for i in range(3))
        bare = lambda: lib.moe_plan_launch(card, t.data_ptr(), n, 128, cap,
                                           8, o_p, s_p, adm.data_ptr(), k_p,
                                           stream_h)
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


def _top_s(traces):
    """Seconds in the depth-0 spans of ``traces`` (nested spans lie inside
    them)."""
    return sum(s_.duration for tr in traces for s_ in tr.spans
               if s_.depth == 0)


def _same_clusters(a, b, what):
    check(np.array_equal(a.switch.read_all(), b.switch.read_all()),
          f"{what}: registers differ from the CPU port")
    check(a.switch.next_gid == b.switch.next_gid, f"{what}: next_gid differs")
    check(dict(a.stats) == dict(b.stats), f"{what}: stats differ")
    check(_wal_heads(a) == _wal_heads(b), f"{what}: WAL hash heads differ")


def main_path(tk, label, device="cuda"):
    """Phase 4 on ``device`` (phase 23 (e) runs it on the last card)."""
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
    gpu = Cluster(8, cfg, hi, switch_mode="pallas", device=device)
    cpu = Cluster(8, cfg, hi, switch_mode="pallas", device="cpu")
    for c in (gpu, cpu):
        c.snapshot_offload()
    print(f"main: setup {time.perf_counter() - t0:.1f} s "
          f"({len(hi.placement.slot)} hot keys, registers on "
          f"{gpu.switch.registers.device})", flush=True)

    _reset(tk)
    out_gpu, times = [], []
    for b in range(8):
        batch = txns[b * B:(b + 1) * B]
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out_gpu += gpu.run_batch(batch)
        torch.cuda.synchronize(device)
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
    rec_launches = _nonzero(_counts(tk))
    check(before.tobytes() == gpu.switch.read_all().tobytes(),
          "main: registers after crash recovery differ")
    check(rec_launches.get("switch_walk_smem.affine", 0) == known + unknown
          and set(rec_launches) == {"switch_walk_smem.affine"},
          f"main: the replay of {known}+{unknown} sends launched "
          f"{rec_launches}, not one affine walk a send")

    batches = _batch_traces(gpu)
    spans = _span_totals(batches)
    total = sum(times)
    groups = launches["switch_txn_smem"]
    print(f"main [{label}]: {len(txns)} txns ({gpu.stats['hot']} hot) in "
          f"{total:.4f} s = {len(txns) / total:.1f} txn/s, "
          f"{gpu.stats['hot'] / total:.1f} hot txn/s; median run_batch "
          f"{statistics.median(times) * 1e3:.3f} ms; {groups} hot groups "
          f"({groups / 8:.2f} per run_batch); launches {launches}", flush=True)
    print("main: host spans over 8 run_batch (s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in spans.items())
          + f", rest {total - _top_s(batches):.4f}", flush=True)
    # the replay runs each send in auto mode (Cluster._replay_into, as
    # the reference does): one affine walk launch a send
    print(f"main: crash_switch_and_recover replayed {known}+{unknown} sends "
          f"in {t_rec:.4f} s ({t_rec / max(known + unknown, 1) * 1e3:.3f} "
          f"ms a send), registers identical; kernel launches "
          f"{rec_launches}", flush=True)
    return launches, gpu, cpu, hi, p, len(txns) / total


# ---------------------------------------------------------------- phase 5 --

def _walk_module():
    from repro_torch.kernels.switch_engine import switch_engine as kw
    return kw


def _tk():
    from repro_torch.kernels.switch_txn import switch_txn as tk
    return tk


def _by_route(launches):
    """Launch counts with the walk's modes summed, by route."""
    return _walk_module().by_route(launches)


def _reset(tk):
    """Every launch counter of the P4DB kernels to 0: switch_txn's and the
    switch-engine walk's."""
    for counts in (tk.LAUNCHES, _walk_module().LAUNCHES):
        for k in counts:
            counts[k] = 0


def _counts(tk):
    """A copy of every launch counter of the P4DB kernels."""
    return {**tk.LAUNCHES, **_walk_module().LAUNCHES}


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
    _reset(tk)
    out_auto, t_auto = run(auto)
    auto_launches = _nonzero(_counts(tk))
    out_cpu, _ = run(cpu)
    check(launches["switch_txn_smem"] > 0, "cadd: switch_txn not launched")
    check(auto_launches.get("switch_walk_smem.serial", 0) > 0
          and not any(k.startswith("switch_txn") for k in auto_launches),
          f"cadd: auto mode did not run its CADD groups on the serial "
          f"walk: {auto_launches}")
    check(out_gpu == out_cpu, "cadd: per-txn results differ from CPU port")
    check(out_auto == out_cpu, "cadd: auto-mode results differ from CPU port")
    _same_clusters(gpu, cpu, "cadd")
    _same_clusters(auto, cpu, "cadd auto")
    print(f"cadd: {len(txns)} SmallBank txns ({gpu.stats['hot']} hot) equal "
          f"to the CPU port; launches {launches}, auto {auto_launches}; "
          f"run_batch total pallas {t_gpu:.4f} s, auto (the walk kernel) "
          f"{t_auto:.4f} s", flush=True)
    return dict(pallas_s=t_gpu, auto_s=t_auto, auto_launches=auto_launches)


# --------------------------------------------------------------- phase 10 --

def _device_by_name(prof):
    """[(device us, name, count)] by kernel name of a profile."""
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")) != "DeviceType.CUDA":
            continue                 # host ops repeat their kernels' time
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((t, e.key, e.count))
    return sorted(rows, reverse=True)


def _window(fn):
    """(rows by name, wall s of ``fn``) of one profiler window around
    ``fn()``, opened and closed by a spin kernel whose rows are dropped;
    rows are None when the profiler did not see both spins.  On the H100
    it drops whole windows (with CUPTI torn down after each window, every
    other one) and at times a window's first events
    (``tools/profiler_windows.py`` counts each kind)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    rows = _device_by_name(prof)
    spins = sum(c for _, k, c in rows if "spin_kernel" in k)
    return ([r for r in rows if "spin_kernel" not in r[1]]
            if spins == 2 else None), wall


def _profile_steps(fn, tries=12):
    """(device us, rows by name, windows taken) of one warm call of
    ``fn`` under the profiler: ``fn`` runs once before, then in windows
    until one is kept, up to ``tries``; rows are empty when none was."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        rows, _ = _window(fn)
        if rows is not None:
            break
        time.sleep(0.1)
    rows = rows or []
    return sum(t for t, _, _ in rows), rows, attempt


def _profile(label, fn, top=None):
    """Wall time and device busy time of ``fn()`` under torch.profiler,
    with the ``top`` kernels by device time (all when None); returns the
    busy share (None where the window was lost).  ``fn`` runs once: empty
    windows first, until the profiler loses one, since the window after
    a lost one is kept."""
    torch.cuda.synchronize()
    for _ in range(3):
        if _window(lambda: None)[0] is None:
            break
    rows, wall = _window(fn)
    dev_us = sum(t for t, _, _ in rows or [])
    if not dev_us:
        print(f"profile [{label}]: device time not measured (the profiler "
              "lost the window)", flush=True)
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
    gpu._run_hot = lambda txn, tr=None, **kw: run_hot(txn, tr=warm, **kw)
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
          + "; inside the warm switch sub-txns: "
          + ", ".join(f"{k} {v:.4f}" for k, v in wspans.items())
          + f"; rest (outside every span) {total - _top_s(batches):.4f}",
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


# --------------------------------------------------------------- phase 20 --

CKPT_INTERVALS = (0, 512, 128, 32)  # benchmarks/common.py:294
CKPT_CHUNK = 64                     # txns per run_batch there (:291)
# (point, async_hot, FaultPlan arguments, Cluster arguments)
CRASH_CASES = (
    ("mid_group_dispatch", False, dict(after=2), {}),
    ("mid_group_dispatch", True, dict(after=2), {}),
    ("undrained_async", True, dict(after=3), dict(max_inflight=4)),
    ("torn_tail", False, dict(after=2, tear_records=2, tear_node=0), {}),
    ("mid_migration", False, {}, {}),
    ("mid_failover", False, {}, {}),
)
STORMS = ("ycsb_a_storm", "tpcc_payment_storm")


def _same_state(a, b, what):
    _same_clusters(a, b, what)
    check(_stores(a) == _stores(b), f"{what}: node stores differ")


def _ycsb_setup():
    """Phase 4's configuration: the switch, its 400-key hot index, and a
    stream of 8 x 256 YCSB-A txns plus one batch more."""
    from repro_torch.core.hotset import build_hot_index
    from repro_torch.core.packets import SwitchConfig
    from repro_torch.workloads import ycsb

    cfg = SwitchConfig(n_stages=S, regs_per_stage=R, max_instrs=K)
    p = ycsb.YCSBParams(variant="A")
    sample = ycsb.generate(np.random.default_rng(SEED), 4000, p)
    hi = build_hot_index(ycsb.traces(sample), top_k=400, switch=cfg)
    txns = ycsb.generate(np.random.default_rng(SEED + 1), 9 * B, p)
    return cfg, hi, txns[:8 * B], txns[8 * B:]


def _feed(c, txns, chunk=B):
    for b in range(0, len(txns), chunk):
        c.run_batch(copy.deepcopy(txns[b:b + chunk]))


def _crashed(c, point, what, fn):
    """Run ``fn`` and return the context of the SimulatedCrash it must
    raise at ``point``."""
    from repro_torch.db.faults import SimulatedCrash
    try:
        fn()
    except SimulatedCrash as e:
        check(e.point == point, f"{what}: crashed at {e.point}")
        return e.ctx
    fail(f"{what}: the armed {point} never fired")


def crash_case(cfg, hi, txns, more, point, async_hot, plan, kw):
    """One crash point on a card cluster and a CPU port cluster under the
    same plan and txns: the crash fires at the armed point, recovery
    replays the same sends into equal state, the registers equal an
    uncrashed card cluster that ran only the txns whose sends survived
    (tests/test_durability.py:110-118), every WAL verifies, and the
    recovered clusters commit a further batch alike.  Returns the
    clusters and the card's recovery seconds."""
    from repro_torch.core.heat import HeatTracker
    from repro_torch.db import migrate as mig
    from repro_torch.db.dbms import Cluster
    from repro_torch.db.faults import FaultPlan, SwitchUnavailable

    what = f"durability (a) {point}{' async' if async_hot else ''}"
    runs = []
    for dev in ("cuda", "cpu"):
        c = Cluster(8, cfg, hi, switch_mode="pallas", standby=True,
                    async_hot=async_hot, device=dev,
                    fault_plan=FaultPlan(point, **plan), **kw)
        c.snapshot_offload()
        if point == "mid_migration":
            mig._MIG_TID = itertools.count(1 << 40)
            mig.EpochController(c, HeatTracker(window=1024, decay=0.2),
                                interval=512, top_k=400)
        if point == "mid_failover":
            _feed(c, txns[:4 * B])
            c.drain()
            ctx = _crashed(c, point, what, c.fail_over)
            check(c._standby is None and c._switch_down,
                  f"{what}: the standby survived the double fault")
        else:
            ctx = _crashed(c, point, what, lambda: _feed(c, txns))
        check(c._switch_down and not c._inflight,
              f"{what}: the switch is up or handles survived the crash")
        evicted = sorted(c._mid_migration_evicted)
        avail = None
        if point == "mid_migration":
            live = next(k for k in sorted(hi.placement.slot)
                        if k not in c._mid_migration_evicted)
            try:
                c.read(live)
                avail = "served"
            except SwitchUnavailable:
                avail = [c.read(k) for k in evicted]
        old = c.switch
        torch.cuda.synchronize()
        _reset(_tk())
        t0 = time.perf_counter()
        counts = c.recover_switch()
        torch.cuda.synchronize()
        t_rec = time.perf_counter() - t0
        if dev == "cuda":
            replay = _nonzero(_counts(_tk()))
        # the crashed engine's queued dispatches run to their end on its
        # own registers; nothing of it is left waiting
        old._join()
        runs.append((c, ctx, evicted, avail, counts, t_rec))
    (gpu, ctx, evicted, avail, counts, t_rec), cpu_run = runs
    cpu = cpu_run[0]
    check((ctx, evicted, avail, counts) == cpu_run[1:5],
          f"{what}: crash context, evicted keys, availability or replay "
          f"counts differ from the CPU port: {(ctx, evicted, avail, counts)}"
          f" vs {cpu_run[1:5]}")
    if point == "mid_migration":
        check(evicted and isinstance(avail, list),
              f"{what}: no evicted key, or a live hot key was served "
              f"while the switch was down: {avail}")
    if point in ("mid_group_dispatch", "undrained_async"):
        check(counts[1] > 0, f"{what}: the lost group replayed as known")
    _same_state(gpu, cpu, what)
    sent = {e.tid for n in gpu.nodes for e in n.wal
            if e.kind == "switch_send"}
    survivors = [t for t in txns if t.tid in sent]
    ref = Cluster(8, cfg, hi, switch_mode="pallas", device="cuda")
    ref.snapshot_offload()
    _feed(ref, survivors)
    check(np.array_equal(gpu.switch.read_all(), ref.switch.read_all()),
          f"{what}: registers after recovery differ from an uncrashed "
          f"cluster of the {len(survivors)} surviving txns")
    wals = gpu.verify_wals()
    check(wals == cpu.verify_wals(), f"{what}: verify_wals differs")
    out = [c.run_batch(copy.deepcopy(more)) for c in (gpu, cpu)]
    for c in (gpu, cpu):
        c.drain()
    check(out[0] == out[1], f"{what}: the batch after recovery differs")
    _same_state(gpu, cpu, f"{what}, after recovery and a further batch")
    shown = ", ".join(f"{k} {len(v) if isinstance(v, list) else v}"
                      for k, v in ctx.items())
    print(f"durability (a) {point}{' async' if async_hot else ''}: crash "
          f"raised at the armed point ({shown}); recover_switch replayed "
          f"{counts[0]} known + {counts[1]} "
          f"unknown sends in {t_rec:.4f} s (launches {replay}); registers "
          f"equal an uncrashed "
          f"cluster of the {len(survivors)} surviving txns; "
          f"{sum(w['records'] for w in wals)} WAL records verify on "
          f"{len(wals)} nodes"
          + (f"; {len(evicted)} evicted keys read from their stores while "
             "the switch was down, live hot keys unavailable"
             if point == "mid_migration" else "")
          + "; registers, replay counts, stats, stores and WAL heads equal "
          "to the CPU port, also after a further batch", flush=True)
    # the crashed async engine's queued switch_txn jobs may finish inside
    # the window; the replay itself is one walk launch a send
    walks = _by_route(replay).get("switch_walk_smem", 0)
    check(walks == sum(counts),
          f"{what}: the replay of {counts} sends launched {replay}")
    return gpu, cpu, t_rec, replay


def bounded_recovery(cfg, hi, txns):
    """The 8 x 256 stream at each checkpoint interval of the reference's
    sweep, admitted in its 64-txn chunks (a checkpoint is due after a hot
    group: at 256 txns every group would cross 128 and 32), in two passes
    (the sweep, then the sweep reversed: host times drift within a call):
    checkpoints and their cost, recover_switch's replay and seconds, and
    warm-standby takeover, which must replay exactly the sends logged
    since the last checkpoint."""
    from repro_torch.db.dbms import Cluster

    rows, regs = [], None
    for interval in CKPT_INTERVALS + CKPT_INTERVALS[::-1]:
        c = Cluster(8, cfg, hi, switch_mode="pallas", standby=True,
                    checkpoint_interval=interval, device="cuda")
        c.snapshot_offload()
        ck, real = [], c.checkpoint

        def timed(*a, real=real, ck=ck, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            ck.append(time.perf_counter() - t0)
            return out

        c.checkpoint = timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _feed(c, txns, CKPT_CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del c.checkpoint
        before, since = c.switch.read_all(), c._sends_since_ckpt
        check(regs is None or np.array_equal(before, regs),
              f"durability (b): registers at interval {interval} differ")
        regs = before
        c.crash_switch()
        torch.cuda.synchronize()
        _reset(_tk())
        t0 = time.perf_counter()
        known, unknown = c.recover_switch()
        torch.cuda.synchronize()
        t_rec = time.perf_counter() - t0
        rec_launches = _nonzero(_counts(_tk()))
        check(np.array_equal(c.switch.read_all(), before)
              and known + unknown == since,
              f"durability (b) interval {interval}: recovery replayed "
              f"{known}+{unknown} of {since} sends, or its registers differ")
        torch.cuda.synchronize()
        _reset(_tk())
        t0 = time.perf_counter()
        fk, fu = c.fail_over()
        torch.cuda.synchronize()
        t_fo = time.perf_counter() - t0
        fo_launches = _nonzero(_counts(_tk()))
        check(sum(rec_launches.values()) == known + unknown
              and sum(fo_launches.values()) == fk + fu
              and not any(k.startswith("switch_txn") for k in
                          {**rec_launches, **fo_launches}),
              f"durability (b) interval {interval}: replays of "
              f"{known + unknown} / {fk + fu} sends launched "
              f"{rec_launches} / {fo_launches}")
        check(fk + fu == since and np.array_equal(c.switch.read_all(),
                                                  before),
              f"durability (b) interval {interval}: takeover replayed "
              f"{fk}+{fu} sends, not the {since} since the last checkpoint")
        if interval == 128 and len(rows) < len(CKPT_INTERVALS):
            # pass 1 at 128 (checkpoints and a replay of 97 sends): the
            # same crash, recovery and takeover on the CPU port
            cpu = Cluster(8, cfg, hi, switch_mode="pallas", standby=True,
                          checkpoint_interval=interval, device="cpu")
            cpu.snapshot_offload()
            _feed(cpu, txns, CKPT_CHUNK)
            cpu.crash_switch()
            check(cpu.recover_switch() == (known, unknown)
                  and cpu.fail_over() == (fk, fu),
                  f"durability (b) interval {interval}: the CPU port "
                  "replayed other sends")
            _same_clusters(c, cpu, f"durability (b) interval {interval} "
                           "after recovery and takeover")
        rows.append(dict(interval=interval, txn_s=len(txns) / wall,
                         checkpoints=len(ck), ckpt_s=sum(ck),
                         replayed=known + unknown, recover_s=t_rec,
                         takeover_s=t_fo, recover_launches=rec_launches,
                         takeover_launches=fo_launches))
    half = len(CKPT_INTERVALS)
    base = [rows[0]["txn_s"], rows[-1]["txn_s"]]

    def two(key, r1, r2, fmt):
        return f"{r1[key]:{fmt}} / {r2[key]:{fmt}}"

    for r1, r2 in zip(rows[:half], rows[:half - 1:-1]):
        check(r1["replayed"] == r2["replayed"]
              and r1["checkpoints"] == r2["checkpoints"],
              f"durability (b) interval {r1['interval']}: the passes differ")
        ck_ms = (f" ({r1['ckpt_s'] / r1['checkpoints'] * 1e3:.3f} / "
                 f"{r2['ckpt_s'] / r2['checkpoints'] * 1e3:.3f} ms each)"
                 if r1["checkpoints"] else "")
        print(f"durability (b) checkpoint_interval {r1['interval']}, pass "
              f"1 / 2: {two('txn_s', r1, r2, '.1f')} txn/s "
              f"({r1['txn_s'] / base[0]:.3f}x / {r2['txn_s'] / base[1]:.3f}x "
              f"of interval 0) over {len(txns) // CKPT_CHUNK} run_batch; "
              f"{r1['checkpoints']} checkpoints in "
              f"{two('ckpt_s', r1, r2, '.4f')} s{ck_ms}; recover_switch "
              f"replayed {r1['replayed']} sends in "
              f"{two('recover_s', r1, r2, '.4f')} s; fail_over replayed the "
              f"same {r1['replayed']} (all since the last checkpoint) in "
              f"{two('takeover_s', r1, r2, '.4f')} s; replay launches by "
              f"route {_by_route(r1['recover_launches'])} / "
              f"{_by_route(r1['takeover_launches'])}", flush=True)

    import tempfile
    with tempfile.TemporaryDirectory() as d:
        c.nodes[0].wal.save(d)
        src = str(Path(__file__).resolve().parent / "src")
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.db.wal", "verify", d],
            capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=src))
    check(out.returncode == 0, f"durability (b): wal verify exited "
          f"{out.returncode}: {out.stdout} {out.stderr}")
    print(f"durability (b): python -m repro_torch.db.wal verify on node "
          f"0's saved WAL: {out.stdout.strip()}", flush=True)
    return rows


def brownout_case(tk, what, make, txns):
    """256 txns, enter_brownout, 256 demoted txns, exit_brownout (one
    logged WRITE dispatch of every evicted key), 256 more, on the card
    and on the CPU port, beside a card cluster that never browned out.
    Returns the reload's launches by route and the enter / exit
    seconds."""
    gpu, ref, cpu = make("cuda"), make("cuda"), make("cpu")
    hot = sorted(gpu.hot_index.placement.slot)
    parts = [txns[i * B:(i + 1) * B] for i in range(3)]
    for c in (gpu, cpu):
        c.run_batch(copy.deepcopy(parts[0]))
    torch.cuda.synchronize()
    _reset(tk)
    t0 = time.perf_counter()
    gpu.enter_brownout()
    torch.cuda.synchronize()
    t_enter = time.perf_counter() - t0
    enter = _counts(tk)
    cpu.enter_brownout()
    for c in (gpu, cpu):
        c.run_batch(copy.deepcopy(parts[1]))
    torch.cuda.synchronize()
    _reset(tk)
    t0 = time.perf_counter()
    gpu.exit_brownout()
    torch.cuda.synchronize()
    t_exit = time.perf_counter() - t0
    reload = _counts(tk)
    cpu.exit_brownout()
    for c in (gpu, cpu):
        c.run_batch(copy.deepcopy(parts[2]))
        c.drain()
    for part in parts:
        ref.run_batch(copy.deepcopy(part))
    demoted = gpu.stats["demoted_brownout"]
    check(demoted > 0, f"{what}: no txn was demoted")
    _same_state(gpu, cpu, what)
    check(np.array_equal(gpu.switch.read_all(), ref.switch.read_all()),
          f"{what}: registers differ from a cluster without the brown-out")
    vals = [c.read_batch(hot) for c in (gpu, ref, cpu)]
    check(vals[0] == vals[1] == vals[2],
          f"{what}: hot values differ from a cluster without the brown-out")
    cold = [{k: v for k, v in n.store.items() if k not in
             gpu.hot_index.placement.slot} for n in gpu.nodes]
    check(cold == [{k: v for k, v in n.store.items() if k not in
                    ref.hot_index.placement.slot} for n in ref.nodes],
          f"{what}: cold stores differ from a cluster without the "
          "brown-out")
    n_pad = 1 << (len(hot) - 1).bit_length()
    print(f"durability (c) {what}: {len(hot)} hot keys; enter_brownout "
          f"{t_enter:.4f} s (launches {_nonzero(enter)}), {demoted} txns "
          f"demoted, exit_brownout {t_exit:.4f} s: one WRITE dispatch of "
          f"{len(hot)} keys (N = {n_pad} x {K} = {n_pad * K}), launches "
          f"{_nonzero(reload)}; registers, stats, stores and WAL heads equal "
          "to the CPU port; registers, hot values and cold stores equal to "
          "a cluster without the brown-out", flush=True)
    return gpu, cpu, dict(enter=enter, reload=reload, enter_s=t_enter,
                          exit_s=t_exit, n=n_pad * K)


def _nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def brownout_cap(gpu, cpu, txns):
    """A Brownout(demote_cap=64) sheds its 65th demotion with
    SwitchUnavailable, on the card as on the CPU port."""
    from repro_torch.db.faults import Brownout, SwitchUnavailable
    out = []
    for c in (gpu, cpu):
        c.enter_brownout(Brownout(demote_cap=64))
        d0, shed = c.stats["demoted_brownout"], None
        for t in copy.deepcopy(txns):
            try:
                c.run(t)
            except SwitchUnavailable as e:
                shed = str(e)
                break
        out.append((c.stats["demoted_brownout"] - d0, shed))
        c.exit_brownout()
    check(out[0] == out[1] and out[0][0] == 64 and out[0][1],
          f"durability (c) cap: {out}")
    _same_state(gpu, cpu, "durability (c) cap")
    print(f"durability (c) Brownout(demote_cap=64): 64 txns demoted, the "
          f"65th shed: SwitchUnavailable({out[0][1][:48]}...), as on the "
          "CPU port", flush=True)


ARENA_RETRIES = 24      # benchmarks/bench_contention.py's budget
# the off/on identity needs runs in which no txn gives up: at 300 txns
# NO_WAIT still gives one ycsb_a_storm txn up at the reference tests' 64
ARENA_SAME_RETRIES = 96


def _arena(tk, dev, cfg, hi, p, hot, txns, proto, ea, retries):
    """One ContentionArena run on a fresh cluster; returns the cluster,
    the ArenaResult, its wall seconds, the launches and the dispatches."""
    from repro_torch.db.conflict import ContentionArena, RetryPolicy
    from repro_torch.db.dbms import Cluster

    c = Cluster(p.n_nodes, cfg, hi, protocol=proto, switch_mode="pallas",
                device=dev)
    for k in hot:
        c.load(k, 10)
    c.snapshot_offload()
    arena = ContentionArena(c, policy=RetryPolicy.for_protocol(
        proto, max_retries=retries, seed=1), early_abort=ea)
    torch.cuda.synchronize()
    _reset(tk)
    d0 = c.switch.dispatch_count
    t0 = time.perf_counter()
    r = arena.run(copy.deepcopy(txns), workers=16)
    torch.cuda.synchronize()
    return (c, r, time.perf_counter() - t0, dict(tk.LAUNCHES),
            c.switch.dispatch_count - d0)


def arena_runs(tk):
    """The ContentionArena on both storms (benchmarks/bench_contention.py:
    62-71: StormParams(n_nodes=4), 300 txns, 16 workers, 24 retries;
    p_hot_txn 0.4 as tests/test_contention.py:386-388 sets it) on the
    full-width switch in pallas mode, NO_WAIT and WAIT_DIE, early abort
    off and on, against the CPU port; then off and on again on the card
    at a budget under which no txn gives up, which must reach the same
    committed state."""
    from repro_torch.core.hotset import build_hot_index
    from repro_torch.core.packets import ADD, SwitchConfig
    from repro_torch.workloads import storms

    cfg = SwitchConfig(n_stages=S, regs_per_stage=R, max_instrs=K)
    p = storms.StormParams(n_nodes=4, p_hot_txn=0.4)
    hot = storms.hot_keys(p)
    hi = build_hot_index([[(k, ADD)] for k in hot], len(hot), cfg)
    rows = []
    for storm in STORMS:
        txns = getattr(storms, storm)(np.random.default_rng(SEED), 300, p)
        # the retry backoffs hash the tid: number the storm from 0, so its
        # outcome does not depend on how many txns earlier phases made
        for i, t in enumerate(txns):
            t.tid = i
        for proto in ("NO_WAIT", "WAIT_DIE"):
            for ea in (False, True):
                gpu, r, wall, launches, dispatches = _arena(
                    tk, "cuda", cfg, hi, p, hot, txns, proto, ea,
                    ARENA_RETRIES)
                cpu, rc, *_ = _arena(tk, "cpu", cfg, hi, p, hot, txns,
                                     proto, ea, ARENA_RETRIES)
                what = f"durability (d) {storm} {proto} early_abort={ea}"
                check(r == rc, f"{what}: an ArenaResult field differs from "
                      "the CPU port")
                _same_state(gpu, cpu, what)
                check(launches["switch_txn_smem"] == dispatches
                      and launches["switch_txn"] == 0
                      and (dispatches > 0) == (storm == "ycsb_a_storm"),
                      f"{what}: {launches} for {dispatches} dispatches")
                rows.append(dict(storm=storm, proto=proto, ea=ea,
                                 committed=len(r.committed),
                                 gave_up=len(r.gave_up), aborts=r.aborts,
                                 early_aborts=r.early_aborts,
                                 wounds=r.wounds, wasted_ops=r.wasted_ops,
                                 p99=r.percentile(0.99), ticks=r.ticks,
                                 wall_s=wall,
                                 launches=launches["switch_txn_smem"]))
            (off, r_off, *_), (on, r_on, *_) = (
                _arena(tk, "cuda", cfg, hi, p, hot, txns, proto, ea,
                       ARENA_SAME_RETRIES) for ea in (False, True))
            what = (f"durability (d) {storm} {proto} at "
                    f"{ARENA_SAME_RETRIES} retries")
            check(not r_off.gave_up and not r_on.gave_up,
                  f"{what}: {len(r_off.gave_up)} / {len(r_on.gave_up)} "
                  "txns gave up (early abort off / on)")
            check(r_off.committed == r_on.committed
                  and _stores(off) == _stores(on)
                  and np.array_equal(off.switch.read_all(),
                                     on.switch.read_all()),
                  f"{what}: early abort off and on reach different "
                  "committed states")
            print(f"{what}: early abort off and on commit all "
                  f"{len(r_on.committed)} txns into equal registers and "
                  f"stores ({r_on.early_aborts} early aborts on)",
                  flush=True)
    for r in rows:
        print(f"durability (d) {r['storm']} {r['proto']} early_abort="
              f"{r['ea']}: {r['committed']} committed, {r['gave_up']} gave "
              f"up, {r['aborts']} aborts ({r['early_aborts']} early, "
              f"{r['wounds']} wounds), wasted ops {r['wasted_ops']}, p99 "
              f"{r['p99']:.0f} ticks of {r['ticks']}, wall {r['wall_s']:.4f}"
              f" s, switch_txn_smem launches {r['launches']} (one per hot "
              f"or warm dispatch); every ArenaResult field, registers, "
              f"stores and WAL heads equal to the CPU port", flush=True)
    return rows


def _export_families(text):
    """Counter and gauge families whole, histograms by their observation
    counts (their values are wall-clock seconds)."""
    from repro_torch.obs.export import parse_prometheus
    out = {}
    for name, fam in parse_prometheus(text).items():
        samples = fam["samples"]
        if fam["type"] == "histogram":
            samples = [s_ for s_ in samples if s_[0].endswith("_count")]
        out[name] = (fam["type"], sorted(
            (n, sorted(lbl.items()), v) for n, lbl, v in samples))
    return out


def telemetry(gpu, cpu):
    """export_metrics() of a crashed and recovered card cluster parses
    under the strict parser, with counter and gauge families and
    histogram counts equal to the CPU port's."""
    from repro_torch.obs.export import parse_prometheus
    text = gpu.export_metrics()
    fams = _export_families(text)
    check(fams == _export_families(cpu.export_metrics()),
          "durability (e): exported families differ from the CPU port")
    hist = {name: sum(v for n, _, v in fam["samples"]
                      if n.endswith("_sum"))
            for name, fam in parse_prometheus(text).items()
            if fam["type"] == "histogram"}
    n_counters = sum(t == "counter" for t, _ in fams.values())
    print(f"durability (e): export_metrics() {len(text)} bytes, "
          f"{len(fams)} families ({n_counters} counters) parse under the "
          "strict parser, counters, gauges and histogram counts equal to "
          "the CPU port; wall-clock histogram sums (s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(hist.items())),
          flush=True)


def durability(tk, smi):
    """Phase 20: P4DB's durability and contention-resilience paths at full
    width, each against a CPU port cluster: (a) the crash-point matrix,
    (b) recovery bounded by the checkpoint interval and warm-standby
    takeover, (c) brown-out on YCSB-A and TPC-C, (d) the ContentionArena,
    (e) the telemetry export."""
    from repro_torch.core.hotset import build_hot_index
    from repro_torch.db.dbms import Cluster
    from repro_torch.workloads import tpcc

    t_phase = time.perf_counter()
    cfg, hi, txns, more = _ycsb_setup()
    rec_s, replays, first = {}, {}, None
    for point, async_hot, plan, kw in CRASH_CASES:
        gpu, cpu, rec_s[(point, async_hot)], replay = crash_case(
            cfg, hi, txns, more, point, async_hot, plan, kw)
        replays[(point, async_hot)] = replay
        first = first or (gpu, cpu)
    bounded = bounded_recovery(cfg, hi, txns)

    def ycsb_cluster(dev):
        c = Cluster(8, cfg, hi, switch_mode="pallas", device=dev)
        c.snapshot_offload()
        return c

    tp = tpcc.TPCCParams(n_nodes=8, n_warehouses=32, dist_frac=0.2)
    top_k = tp.n_warehouses * (1 + 2 * tpcc.N_DISTRICTS + tpcc.HOT_ITEMS)
    thi = build_hot_index(tpcc.traces(tpcc.generate(
        np.random.default_rng(SEED), 5000, tp)), top_k=top_k, switch=cfg)

    def tpcc_cluster(dev):
        c = Cluster(8, cfg, thi, switch_mode="pallas", device=dev)
        c.snapshot_offload()
        return c

    ygpu, ycpu, yb = brownout_case(tk, "ycsb_a", ycsb_cluster, txns)
    brownout_cap(ygpu, ycpu, more)
    tt = tpcc.generate(np.random.default_rng(SEED + 1), 3 * B, tp)
    _, _, tb = brownout_case(tk, "tpcc", tpcc_cluster, tt)
    check(yb["reload"]["switch_txn_smem"] == 1
          and yb["reload"]["switch_txn"] == 0,
          f"durability (c): the YCSB-A reload (N = {yb['n']}) left the "
          f"single-CTA route: {yb['reload']}")
    check(tb["reload"]["switch_txn"] == 1
          and tb["reload"]["switch_txn_smem"] == 0
          and tb["reload"]["result_gather"] >= 1,
          f"durability (c): the TPC-C reload (N = {tb['n']}) did not take "
          f"the large-N route: {tb['reload']}")
    check(yb["enter"]["result_gather"] == tb["enter"]["result_gather"] == 1,
          "durability (c): enter_brownout's read_batch is not one "
          f"result_gather launch: {yb['enter']} / {tb['enter']}")
    arena = arena_runs(tk)
    telemetry(*first)
    took = time.perf_counter() - t_phase
    print(f"durability [{smi}]: phase 20 took {took:.1f} s", flush=True)
    return dict(recover_s={f"{p}{'/async' if a else ''}": round(s_, 4)
                           for (p, a), s_ in rec_s.items()},
                replay_launches={f"{p}{'/async' if a else ''}": _by_route(v)
                                 for (p, a), v in replays.items()},
                bounded=bounded, ycsb_brownout=yb, tpcc_brownout=tb,
                arena=arena, seconds=took)


# --------------------------------------------------------------- phase 21 --

# (B, K) of each stream the walk kernel is held against its plain version
# on: N = B x K = 1, 16, 4,096 (the main path's group), WALK_SMEM_MAX, the
# first N of the large route, and 32,768 (the TPC-C brown-out reload)
WALK_SHAPES = ((1, 1), (1, 16), (256, 16), (512, 16), (2731, 3), (2048, 16))
# the serial plain version loops over the stream in Python (a few scalar
# launches an instruction); beyond this N it runs on the CPU, same inputs
WALK_SERIAL_PLAIN_ON_CARD = 4096


def _walk_stream(rng, mode, B_, K_):
    """A full-width stream with every opcode ``mode`` takes, a third of it
    on four hot slots (long chains), 30% on stray slots (past the file or
    a row, negative within and beyond the file's length, a stage that
    wraps int32, stage -1, reg -1; the chain of g = -2 writes back onto a
    hot slot), int32-edge operands and registers, ADDP sources anywhere in
    the row.  Returns registers [S, R] and op, stage, reg, val [B, K] and
    idx [N // 2 + 1], int32."""
    ops = {"serial": (0, 1, 2, 3, 4, 5), "affine": (0, 1, 2, 3),
           "staged": (0, 1, 2, 3, 5)}[mode]
    shape = (B_, K_)
    op = rng.choice(ops, shape).astype(np.int32)
    st = rng.integers(0, S, shape).astype(np.int32)
    rg = rng.integers(0, R, shape).astype(np.int32)
    hot = rng.random(shape) < 0.35
    hs, hr = np.array([0, 1, S - 1, S - 1]), np.array([-2, 3, R - 1, R - 2])
    pick = rng.integers(0, 4, int(hot.sum()))
    st[hot], rg[hot] = hs[pick], hr[pick]
    stray = rng.random(shape) < 0.3
    kinds = rng.integers(0, 6, int(stray.sum()))
    s_st, s_rg = st[stray], rg[stray]
    s_st = np.where(kinds == 0, S + 2, s_st)
    s_rg = np.where(kinds == 1, R + 3, s_rg)
    s_st = np.where(kinds == 2, 0, s_st)
    s_rg = np.where(kinds == 2, -rng.integers(1, S * R + 3, kinds.size), s_rg)
    s_st = np.where(kinds == 3, 2**31 // R + 1, s_st)
    s_st = np.where(kinds == 4, -1, s_st)
    s_rg = np.where(kinds == 5, -1, s_rg)
    st[stray], rg[stray] = s_st, s_rg
    val = rng.integers(-100, 100, shape).astype(np.int32)
    edge = rng.random(shape) < 0.1
    val[edge] = rng.choice([2**31 - 1, -2**31, 2**30], int(edge.sum()))
    addp = op == 5
    val[addp] = rng.integers(-1, K_ + 1, int(addp.sum()))
    regs = rng.integers(-1000, 1000, (S, R)).astype(np.int32)
    regs[0, 0], regs[S - 1, R - 1] = 2**31 - 20, -2**31 + 5
    idx = rng.integers(-3, B_ * K_ + 8, B_ * K_ // 2 + 1).astype(np.int32)
    return regs, op, st, rg, val, idx


def _walk_rng(mode, n):
    return np.random.default_rng(SEED + 21 + n + 7 * ("serial", "staged",
                                                      "affine").index(mode))


def _ladder_stream(rng, mode, B_, K_, depth=K - 1):
    """Rows that each climb an ADDP ladder: instruction k <= depth adds
    instruction k - 1's result on a slot of its own (staged: ascending
    stages, every ADDP forwarded), the first an ADD, the rest READ / ADD;
    ``depth`` levels past ROUND_CAP make serial rounds give up."""
    shape = (B_, K_)
    op = rng.choice([1, 3], shape).astype(np.int32)
    op[:, 0] = 3
    op[:, 1:depth + 1] = 5
    val = rng.integers(1, 1000, shape).astype(np.int32)
    val[:, 1:depth + 1] = np.arange(depth, dtype=np.int32)
    if mode == "staged":
        st = np.sort(np.argsort(rng.random((B_, S)), axis=1)[:, :K_],
                     axis=1).astype(np.int32)
        rg = rng.integers(0, 64, shape).astype(np.int32)
    else:
        flat = rng.integers(0, S * R, shape)
        st, rg = (flat // R).astype(np.int32), (flat % R).astype(np.int32)
    regs = rng.integers(-1000, 1000, (S, R)).astype(np.int32)
    idx = rng.integers(0, B_ * K_, B_ * K_ // 2 + 1).astype(np.int32)
    return regs, op, st, rg, val, idx


def _captured_groups():
    """Real dispatches, captured at the walk's entry from CPU port
    clusters in auto mode (the card's equal them, phase 21 (d)): the
    largest YCSB-A affine group, the largest serial group of SmallBank
    with its ADDP txns (amalgamate), and a safe-ADDP staged group of B x
    K.  Returns {name: (mode, registers before, op, stage, reg, val,
    idx)} as numpy arrays."""
    from repro_torch.core import engine as teng
    from repro_torch.core.engine import SwitchEngine
    from repro_torch.core.hotset import build_hot_index
    from repro_torch.db.dbms import Cluster
    from repro_torch.workloads import smallbank

    seen = []
    orig = teng.kwk.engine_exec_gather

    def record(mode, registers, op, stage, reg, val, idx):
        seen.append((mode,) + tuple(t.cpu().numpy().copy() for t in (
            registers, op, stage, reg, val, idx)))
        return orig(mode, registers, op, stage, reg, val, idx)

    def largest(mode):
        got = [g for g in seen if g[0] == mode]
        check(got, f"walk (a): no {mode} group was captured")
        return max(got, key=lambda g: g[2].size)

    out = {}
    teng.kwk.engine_exec_gather = record
    try:
        cfg, hi, txns, _ = _ycsb_setup()
        c = Cluster(8, cfg, hi, switch_mode="auto", device="cpu")
        c.snapshot_offload()
        c.run_batch(copy.deepcopy(txns[:B]))
        out["ycsb-A group"] = largest("affine")
        seen.clear()
        p = smallbank.SmallBankParams()
        sample = smallbank.generate(np.random.default_rng(SEED), 6000, p)
        shi = build_hot_index(smallbank.traces(sample),
                              top_k=p.hot_per_node * p.n_nodes * 2,
                              switch=cfg)
        c = Cluster(8, cfg, shi, switch_mode="auto", device="cpu")
        for k in smallbank.hot_keys(p):
            c.load(k, 100)
        c.snapshot_offload()
        c.run_batch(smallbank.generate(np.random.default_rng(SEED + 1),
                                       2 * B, p))
        out["smallbank group"] = largest("serial")
        seen.clear()
        SwitchEngine(cfg, device="cpu").execute_batch(
            _staged_group(np.random.default_rng(SEED + 23), cfg, B),
            mode="auto")
        out["safe-ADDP staged group"] = largest("staged")
    finally:
        teng.kwk.engine_exec_gather = orig
    return out


def _walk_once(kw, mode, arrays, dev, where):
    """The kernel (with its rounds) and the plain version on ``where`` of
    one stream; checks registers, res, ok and compact equal.  Returns
    (max abs error, rounds)."""
    t = lambda a, d=dev: torch.tensor(a, dtype=torch.int32, device=d)
    regs, op, st, rg, val, idx = arrays
    got = kw.switch_walk_gather_call(mode, t(regs), t(op), t(st), t(rg),
                                     t(val), t(idx), rounds=True)
    want = kw.switch_walk_plain(mode, *(t(a, where) for a in arrays))
    torch.cuda.synchronize()
    err = 0
    for name, a, b in zip(("registers", "res", "ok", "compact"), got, want):
        a, b = a.cpu(), b.cpu()
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"walk: {mode} {name} differ from plain at N={op.size}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err, int(got[4].item())


def walk_kernel_checks(kw, tk, dev):
    """(a) The walk kernels against their plain version on the card, each
    mode at every N of WALK_SHAPES, then real captured groups (YCSB-A
    affine, SmallBank serial, safe-ADDP staged), the serial N = 4,096
    stream without its ADDPs (one round), and ADDP ladders (serial past
    ROUND_CAP, staged 15 stages deep) at N = 4,096 and 32,768:
    registers, res, ok and compact equal, and the route each N must take.
    Prints the rounds each stream took; serial must both converge in
    rounds and give up to the one-thread walk somewhere.  Returns (max abs
    error, shared memory by tile, rounds by stream, the streams (b) also
    times)."""
    from repro_torch.kernels import build
    lib = build.library("switch_engine")
    wmax = kw.WALK_SMEM_MAX
    check(lib.switch_walk_smem_bytes(wmax) > 0
          and lib.switch_walk_smem_bytes(wmax + 1) == 0,
          f"WALK_SMEM_MAX={wmax} disagrees with the CUDA source")
    smem_bytes = {n: lib.switch_walk_smem_bytes(n)
                  for n in (32, 256, 1024, 4096, wmax)}
    streams = []
    for mode in kw.MODES:
        for B_, K_ in WALK_SHAPES:
            streams.append((f"{mode} N={B_ * K_}", mode, _walk_stream(
                _walk_rng(mode, B_ * K_), mode, B_, K_)))
    extra = {}                          # timed in (b) too
    for name, (mode, *arrays) in _captured_groups().items():
        name = f"{name} ({mode}, N={arrays[1].size})"
        streams.append((name, mode, arrays))
        extra[name] = (mode, arrays)
    arrays = _walk_stream(_walk_rng("serial", B * K), "serial", B, K)
    arrays[1][arrays[1] == 5] = 3          # ADDP -> ADD: one round
    streams.append((f"serial no-ADDP N={B * K}", "serial", arrays))
    extra[streams[-1][0]] = ("serial", arrays)
    for mode in ("serial", "staged"):
        for B_ in (B, 2048):
            name = f"{mode} ADDP ladder N={B_ * K}"
            streams.append((name, mode, _ladder_stream(
                np.random.default_rng(SEED + 31 + B_), mode, B_, K)))
            if B_ == B:
                extra[name] = (mode, streams[-1][2])
    err, lines, rounds = 0, [], {}
    for name, mode, arrays in streams:
        n = arrays[1].size
        where = (dev if mode != "serial" or n <= WALK_SERIAL_PLAIN_ON_CARD
                 else torch.device("cpu"))
        _reset(tk)
        e, r = _walk_once(kw, mode, arrays, dev, where)
        launched = _nonzero(_counts(tk))
        err = max(err, e)
        route = "switch_walk_smem" if n <= wmax else "switch_walk"
        expect = {f"{route}.{mode}": 1}
        if route == "switch_walk":
            expect["result_gather"] = 1
        check(launched == expect, f"walk: {name} launched {launched}, "
              f"expected {expect}")
        check(r == 1 if mode == "affine" else r != 0,
              f"walk: {name} took {r} rounds")
        rounds[name] = r
        lines.append(f"{name} {route} rounds {r}"
                     + (" (plain on the CPU)" if where != dev else ""))
    serial = [r for (name, mode, _), r in zip(streams, rounds.values())
              if mode == "serial"]
    check(any(r > 0 for r in serial) and any(r < 0 for r in serial),
          f"walk (a): serial streams did not both converge and give up "
          f"(rounds {serial})")
    print(f"walk (a): equal to plain (registers, res, ok, compact) on "
          f"{'; '.join(lines)}; shared memory by tile {smem_bytes} bytes "
          f"(rounds < 0: the rounds gave up, the one-thread walk ran)",
          flush=True)
    return err, smem_bytes, rounds, extra


def _walk_bound(op, st, rg, n_idx):
    """(ms, by) of the least time for one dispatch: op/stage/reg/val and
    idx in, res + ok (bytes) + compact out, one read and one write of each
    distinct register the stream touches; one RMW per instruction."""
    g = (st.astype(np.int64) * R + rg).reshape(-1)
    live = op.reshape(-1) != 0
    distinct = np.unique(np.clip(np.where(g < 0, g + S * R, g)[live], 0,
                                 S * R - 1)).size
    n = op.size
    return bound_ms(16 * n + 4 * n_idx + 5 * n + 4 * n_idx + 8 * distinct,
                    n)


def _kernel_name(name):
    """A profiler row's kernel name without namespaces, template arguments
    and parameters."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()


def walk_timing(kw, tk, dev, extra):
    """(b) CUDA-event time of each mode per call (the launcher) and bare
    (the C call alone) at the main path's N = 4,096 and at N = 16 (a B = 1
    group); the large route at N = 32,768; ``extra`` ({name: (mode,
    arrays)}: the captured groups and the 4,096 ladders) per call and
    bare; the profiler's device time of one call at 4,096 and 32,768 (the
    large route's kernels by name; "not measured" where a window came
    back empty); the plain version at 4,096 and 32,768 (serial at 4,096
    only); each beside its bytes bound."""
    streams = [(f"{mode}@{B_ * K_}", mode, _walk_stream(
        _walk_rng(mode, B_ * K_), mode, B_, K_))
        for mode in kw.MODES for B_, K_ in ((256, 16), (1, 16), (2048, 16))]
    streams += [(name, mode, arrays) for name, (mode, arrays) in
                extra.items()]
    rows = {}
    for name, mode, (regs, op, st, rg, val, idx) in streams:
        n = op.size
        t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
        work, op_t, st_t, rg_t, val_t, idx_t = (
            t(a) for a in (regs, op, st, rg, val, idx))
        m = idx_t.numel()
        call = lambda: kw.switch_walk_gather_call(
            mode, work, op_t, st_t, rg_t, val_t, idx_t)
        large = n > kw.WALK_SMEM_MAX
        row = dict(n=n, ms=time_cuda(call, inner=5 if large else 20,
                                     reps=5 if large else 7))
        if not large:
            res_b = torch.empty_like(op_t)
            ok_b = torch.empty(op_t.shape, dtype=torch.bool, device=dev)
            cmp_b = torch.empty_like(idx_t)
            stream = torch.cuda.current_stream(dev).cuda_stream
            mid = kw.MODES.index(mode)
            row["kernel_ms"] = time_cuda(lambda: kw._SMEM(
                work.get_device(), mid, work.data_ptr(), S, R, op.shape[1],
                op_t.data_ptr(), st_t.data_ptr(), rg_t.data_ptr(),
                val_t.data_ptr(), n,
                res_b.data_ptr(), ok_b.data_ptr(), idx_t.data_ptr(),
                cmp_b.data_ptr(), m, None, stream), inner=50, reps=7)
        if n >= 4096 and name.startswith(mode):
            dev_us, kernels, _ = _profile_steps(call)
            row["device_us"] = dev_us if kernels else None
            if large:
                row["device_kernels"] = [(_kernel_name(k), c, round(t_, 2))
                                         for t_, k, c in kernels]
        if n > 16 and name.startswith(mode) and (mode != "serial"
                                                 or n <= 4096):
            row["plain_ms"] = time_cuda(lambda: kw.switch_walk_plain(
                mode, work, op_t, st_t, rg_t, val_t, idx_t),
                inner=1, reps=3)
        row["bound_ms"], row["bound_by"] = _walk_bound(op, st, rg, m)
        rows[name] = row
    fmt = lambda x, d: "nan" if x is None else f"{x:.{d}f}"
    print("walk (b): per call / bare / device / plain (ms, device us), "
          "bound: " + "; ".join(
              f"{k} {r['ms']:.5f} / {fmt(r.get('kernel_ms'), 5)} / "
              f"{fmt(r.get('device_us'), 2)} us / "
              f"{fmt(r.get('plain_ms'), 4)}, {r['bound_ms']:.6f} "
              f"({r['bound_by']})" for k, r in rows.items()), flush=True)
    for k, r in rows.items():
        if r.get("device_kernels"):
            print(f"walk (b) {k} device kernels: " + "; ".join(
                f"{n_} x{c} {t_} us" for n_, c, t_ in r["device_kernels"]),
                flush=True)
    return rows


def _ycsb_group(rng, cfg, n_rows):
    """An all-hot {READ, WRITE, ADD} packet batch of ``n_rows`` x K on
    random in-range slots (auto mode runs it on the affine walk)."""
    from repro_torch.core.packets import empty_packets
    p = empty_packets(n_rows, cfg)
    p["op"] = rng.integers(1, 4, p["op"].shape).astype(np.int32)
    p["stage"] = rng.integers(0, S, p["op"].shape).astype(np.int32)
    p["reg"] = rng.integers(0, 512, p["op"].shape).astype(np.int32)
    p["operand"] = rng.integers(-100, 100, p["op"].shape).astype(np.int32)
    return p


def _host_us(fn, n=51):
    """Median host-clock microseconds of ``fn()`` over ``n - 1`` calls,
    each started on an idle card (the first call warms up)."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(out[1:]) * 1e6


def walk_profile(tk, cfg):
    """(c) One auto dispatch at N = 4,096 on a full-width engine under the
    profiler: exactly one device kernel, the single-CTA walk, and no
    device -> host copy (nothing is drained); and where its host time
    goes: ``execute_batch`` with the packet metadata ``build_packets``
    gives (and in pallas mode), the walk's launcher alone, its fast-path
    tests, the precise checks those skip, and its bare C call, on an idle
    card.  main() runs it right after phase 10's profiles."""
    from repro_torch.core.engine import SwitchEngine
    eng = SwitchEngine(cfg, device="cuda")
    pkts = _ycsb_group(np.random.default_rng(SEED + 22), cfg, B)
    n = pkts["op"].size
    host = []
    for _ in range(51):                       # the first call warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pb = eng.execute_batch(pkts, mode="auto")
        host.append(time.perf_counter() - t0)
        pb.results_np()
    check(pb.mode == "affine", f"walk (c): auto resolved {pb.mode}")
    host_us = statistics.median(host[1:]) * 1e6
    dev_us, rows, attempts = _profile_steps(
        lambda: eng.execute_batch(pkts, mode="auto"))
    kernels = [(t, k, c) for t, k, c in rows
               if not k.startswith(("Memcpy", "Memset"))]
    d2h = sum(c for _, k, c in rows if "DtoH" in k)
    names = "; ".join(f"{k} x{c} {t:.2f} us" for t, k, c in rows)
    print(f"walk (c) profile [one auto dispatch, B={B}, N={n}]: {names}; "
          f"device total {dev_us:.2f} us (profiler windows taken "
          f"{attempts}); host time of execute_batch alone, median of 50: "
          f"{host_us:.1f} us", flush=True)
    check(len(kernels) == 1 and kernels[0][2] == 1
          and "switch_walk_smem_kernel" in kernels[0][1] and d2h == 0,
          f"walk (c): an auto dispatch at N={n} ran {names or 'nothing'}")

    from repro_torch.core.packets import result_plane, scan_flags
    from repro_torch.kernels.switch_engine import switch_engine as kw
    base, idx = result_plane(pkts)
    meta = dict(scan_flags(pkts), res_base=base, gather_idx=idx)
    t = lambda a: torch.tensor(a, dtype=torch.int32, device="cuda")
    op, st, rg, v = (t(pkts[f]) for f in ("op", "stage", "reg", "operand"))
    ix = t(idx)
    res, cm = torch.empty_like(op), torch.empty_like(ix)
    ok = torch.empty(op.shape, dtype=torch.bool, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    split = {
        "execute_batch, no metadata": host_us,
        "execute_batch": _host_us(
            lambda: eng.execute_batch(pkts, meta, mode="auto")),
        "execute_batch, pallas": _host_us(
            lambda: eng.execute_batch(pkts, meta, mode="pallas")),
        "launcher": _host_us(lambda: kw.switch_walk_gather_call(
            "affine", eng.registers, op, st, rg, v, ix)),
        "launcher's fast-path tests": _host_us(lambda: kw._fast(
            "affine", eng.registers, op, st, rg, v, ix)),
        "the precise checks it skips": _host_us(lambda: kw._check(
            "affine", eng.registers, op, st, rg, v, ix)),
        "bare C call": _host_us(lambda: kw._SMEM(
            eng.registers.get_device(), kw.MODES.index("affine"),
            eng.registers.data_ptr(), S, R, K,
            op.data_ptr(), st.data_ptr(), rg.data_ptr(), v.data_ptr(), n,
            res.data_ptr(), ok.data_ptr(), ix.data_ptr(), cm.data_ptr(),
            ix.numel(), None, stream)),
    }
    print(f"walk (c) host time of one auto dispatch at N={n}, us, median of "
          f"50 on an idle card: " + "; ".join(f"{k} {u:.1f}"
                                             for k, u in split.items()),
          flush=True)
    return dict(device_us=kernels[0][0], host_us=split)


def _staged_group(rng, cfg, n_rows):
    """Safe-ADDP packets (the declustered layout's shape): each row's K
    instructions on K distinct ascending stages, 40% ADDP forwarding an
    earlier instruction's result, the rest {READ, WRITE, ADD}."""
    from repro_torch.core.packets import empty_packets
    p = empty_packets(n_rows, cfg)
    for b in range(n_rows):
        p["stage"][b] = np.sort(rng.choice(S, K, replace=False))
        addp = (rng.random(K) < 0.4) & (np.arange(K) > 0)
        p["op"][b] = np.where(addp, 5, rng.integers(1, 4, K))
        p["operand"][b] = np.where(addp, rng.integers(0, np.maximum(
            np.arange(K), 1)), rng.integers(-50, 50, K))
        p["reg"][b] = rng.integers(0, 64, K)
    return p


def walk_clusters(tk, smi):
    """(d) switch_mode="auto" at full width against CPU port clusters:
    YCSB-A 8 x 256 (affine groups, then crash recovery), sharded n = 2
    (serial cross-shard minis) beside n = 1, a safe-ADDP staged stream at
    B = 256, and the TPC-C brown-out with its N = 32,768 WRITE reload on
    the large route.  Returns launches by path and the times."""
    from repro_torch.core.engine import SwitchEngine
    from repro_torch.core.hotset import build_hot_index
    from repro_torch.core.packets import SwitchConfig, scan_flags
    from repro_torch.db.dbms import Cluster
    from repro_torch.workloads import tpcc, ycsb

    out = {}
    cfg, hi, txns, _ = _ycsb_setup()
    gpu, cpu = (Cluster(8, cfg, hi, switch_mode="auto", device=d)
                for d in ("cuda", "cpu"))
    for c in (gpu, cpu):
        c.snapshot_offload()
    _reset(tk)
    times, out_gpu = [], []
    for b in range(8):
        batch = copy.deepcopy(txns[b * B:(b + 1) * B])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_gpu += gpu.run_batch(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ycsb_l = _nonzero(_counts(tk))
    out_cpu = []
    for b in range(8):
        out_cpu += cpu.run_batch(copy.deepcopy(txns[b * B:(b + 1) * B]))
    check(out_gpu == out_cpu, "walk (d) ycsb: results differ from the CPU "
          "port")
    _same_clusters(gpu, cpu, "walk (d) ycsb")
    check(set(ycsb_l) == {"switch_walk_smem.affine"}
          and ycsb_l["switch_walk_smem.affine"] == gpu.switch.dispatch_count,
          f"walk (d) ycsb: {ycsb_l} for {gpu.switch.dispatch_count} "
          "dispatches")
    before = gpu.switch.read_all()
    _reset(tk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    known, unknown = gpu.crash_switch_and_recover()
    t_rec = time.perf_counter() - t0
    rec_l = _nonzero(_counts(tk))
    check(np.array_equal(before, gpu.switch.read_all()),
          "walk (d) ycsb: registers after recovery differ")
    out["ycsb"] = dict(launches=ycsb_l, run_batch_s=sum(times),
                       median_ms=statistics.median(times) * 1e3,
                       replay_sends=known + unknown, replay_s=t_rec,
                       replay_launches=rec_l)
    print(f"walk (d) ycsb [{smi}]: 8 x {B} YCSB-A txns in auto mode equal "
          f"to the CPU port (results, registers, GIDs, stats, WAL heads) in "
          f"{sum(times):.4f} s, median run_batch "
          f"{statistics.median(times) * 1e3:.3f} ms, launches {ycsb_l}; "
          f"recovery replayed {known}+{unknown} sends in {t_rec:.4f} s "
          f"({t_rec / max(known + unknown, 1) * 1e3:.4f} ms a send), "
          f"launches {rec_l}", flush=True)

    # sharded: n = 1 and n = 2 on the card, n = 2 on the CPU port
    p = ycsb.YCSBParams(variant="A")
    sample = ycsb.generate(np.random.default_rng(SEED), 4000, p)
    txs = ycsb.generate(np.random.default_rng(SEED + 3), 2 * B, p)
    worlds = {}
    for n_sw, d in ((1, "cuda"), (2, "cuda"), (2, "cpu")):
        cfg_n = SwitchConfig(n_stages=S, regs_per_stage=R, max_instrs=K,
                             n_switches=n_sw)
        hi_n = build_hot_index(ycsb.traces(sample), top_k=400, switch=cfg_n)
        c = Cluster(8, cfg_n, hi_n, switch_mode="auto", device=d)
        c.snapshot_offload()
        _reset(tk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = []
        for b in range(2):
            res += c.run_batch(copy.deepcopy(txs[b * B:(b + 1) * B]))
        torch.cuda.synchronize()
        worlds[(n_sw, d)] = (c, res, time.perf_counter() - t0,
                             _nonzero(_counts(tk)))
    (c1, r1, t1, l1), (c2, r2, t2, l2), (cc, rc, _, _) = worlds.values()
    check(r1 == r2 == rc, "walk (d) sharded: results differ")
    _same_clusters(c2, cc, "walk (d) sharded n=2")
    check(c1.switch.next_gid == c2.switch.next_gid,
          "walk (d) sharded: GIDs differ from n=1")
    stream = lambda c: [[(e.kind, e.tid) for e in n.wal] for n in c.nodes]
    check(stream(c1) == stream(c2), "walk (d) sharded: WAL streams differ")
    check(l2.get("switch_walk_smem.serial", 0) > 0
          and not any(k.startswith("switch_txn") for k in l2),
          f"walk (d) sharded: no serial cross-shard mini on the walk: {l2}")
    out["sharded"] = dict(n1_s=t1, n2_s=t2, n1_launches=l1, n2_launches=l2)
    print(f"walk (d) sharded [{smi}]: 2 x {B} YCSB-A txns in auto mode, "
          f"n_switches=2 equal to n=1 and to the CPU port (results, GIDs, "
          f"registers, WAL); run_batch total n=1 {t1:.4f} s, n=2 {t2:.4f} "
          f"s; launches n=1 {l1}, n=2 {l2}", flush=True)

    # a safe-ADDP stream at B = 256: auto runs it on the staged walk
    engines = [SwitchEngine(cfg, device=d) for d in ("cuda", "cpu")]
    rng = np.random.default_rng(SEED + 23)
    _reset(tk)
    for _ in range(3):
        pk = _staged_group(rng, cfg, B)
        flags = scan_flags(pk)
        check(flags["has_addp"] and not flags["addp_unsafe"],
              "walk (d) staged: the stream is not safe-ADDP")
        outs = [e.execute_batch(pk, mode="auto") for e in engines]
        check(outs[0].mode == "staged", f"walk (d): auto ran {outs[0].mode}")
        check(np.array_equal(outs[0].results_np(), outs[1].results_np())
              and np.array_equal(outs[0].ok_np(), outs[1].ok_np())
              and np.array_equal(outs[0].gids, outs[1].gids),
              "walk (d) staged: results differ from the CPU port")
    staged_l = _nonzero(_counts(tk))
    check(np.array_equal(engines[0].read_all(), engines[1].read_all()),
          "walk (d) staged: registers differ from the CPU port")
    check(staged_l == {"switch_walk_smem.staged": 3},
          f"walk (d) staged: {staged_l}")
    out["staged"] = dict(launches=staged_l)
    print(f"walk (d) staged: 3 safe-ADDP groups of {B} x {K} in auto mode "
          f"equal to the CPU port (results, ok, GIDs, registers); launches "
          f"{staged_l}", flush=True)

    # TPC-C brown-out in auto mode: the reload is a WRITE-only N = 32,768
    tp = tpcc.TPCCParams(n_nodes=8, n_warehouses=32, dist_frac=0.2)
    top_k = tp.n_warehouses * (1 + 2 * tpcc.N_DISTRICTS + tpcc.HOT_ITEMS)
    thi = build_hot_index(tpcc.traces(tpcc.generate(
        np.random.default_rng(SEED), 5000, tp)), top_k=top_k, switch=cfg)

    def tpcc_auto(dev):
        c = Cluster(8, cfg, thi, switch_mode="auto", device=dev)
        c.snapshot_offload()
        return c

    tt = tpcc.generate(np.random.default_rng(SEED + 1), 3 * B, tp)
    _, _, tb = brownout_case(tk, "walk (d) tpcc auto", tpcc_auto, tt)
    reload = _nonzero(tb["reload"])
    check(reload.get("switch_walk.affine") == 1
          and reload.get("result_gather", 0) >= 1
          and not any(k.startswith("switch_txn") for k in reload),
          f"walk (d) tpcc: the reload (N = {tb['n']}) did not take the "
          f"large route: {reload}")
    out["tpcc_brownout"] = dict(reload=reload, n=tb["n"],
                                exit_s=tb["exit_s"])
    return out


def walk_path(tk, kw, smi, prof):
    """Phase 21: the reference's compiled switch engines as the walk
    kernel: (a) against its plain version, (b) timed, (d) auto-mode
    clusters against the CPU port; ``prof`` is (c), one auto dispatch
    profiled (``walk_profile``, run earlier).  Returns the kernels line's
    two entries."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    err, smem_bytes, rounds, extra = walk_kernel_checks(kw, tk, dev)
    rows = walk_timing(kw, tk, dev, extra)
    paths = walk_clusters(tk, smi)
    launches = {}
    for part in ("ycsb", "sharded", "staged", "tpcc_brownout"):
        got = paths[part]
        for key in ("launches", "n2_launches", "reload"):
            for k, v in got.get(key, {}).items():
                launches[k] = launches.get(k, 0) + v
    routes = _by_route(launches)
    check(routes.get("switch_walk_smem", 0) > 0
          and routes.get("switch_walk", 0) > 0,
          f"walk: a route was not launched on the auto paths: {launches}")
    took = time.perf_counter() - t_phase
    print(f"walk [{smi}]: phase 21 took {took:.1f} s; launches on the auto "
          f"paths {launches}", flush=True)
    src = "src/repro_torch/kernels/switch_engine/csrc/switch_engine.cu"
    replaces = ["src/repro/core/engine.py:98 (_serial_engine_impl)",
                "src/repro/core/engine.py:132 (_staged_engine_impl)",
                "src/repro/core/engine.py:170 (_affine_engine_impl)"]
    main_row, large_row = rows[f"affine@{B * K}"], rows["affine@32768"]
    return [
        dict(name="switch_walk_smem", route="cuda", source=src,
             replaces="src/repro/core/engine.py:170",
             replaces_all=replaces, launches=routes["switch_walk_smem"],
             max_abs_err=err, ms=main_row["ms"],
             plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
             bound_by=main_row["bound_by"], library_ms=None,
             kernel_ms=main_row["kernel_ms"], shape=[S * R, B * K],
             smem_bytes=smem_bytes, by_mode=rows, rounds=rounds,
             profile=prof, paths=paths),
        dict(name="switch_walk", route="cuda", source=src,
             replaces="src/repro/core/engine.py:170",
             replaces_all=replaces, launches=routes["switch_walk"],
             max_abs_err=err, ms=large_row["ms"],
             plain_ms=large_row["plain_ms"], bound_ms=large_row["bound_ms"],
             bound_by=large_row["bound_by"], library_ms=None,
             shape=[S * R, 32768]),
    ]


# --------------------------------------------------------------- phase 22 --

OLTP_SECTIONS = ("YCSB-A, 8 nodes x 20 workers",
                 "TPC-C (warm transactions), 8 warehouses",
                 "Open-loop serving, YCSB-A")
SPEEDUP_LINE = re.compile(r"speedup P4DB / No-Switch: (\S+)x")
KNEE_LINE = re.compile(r"saturation knee \(.*\): (\S+) M/s")


def oltp_cluster(smi):
    """Phase 22: ``examples/oltp_cluster_torch.py`` (the timing simulator
    on the host; it launches no kernel) in a subprocess.  Returns its
    speedup, knee and wall seconds."""
    script = (Path(__file__).resolve().parent / "examples"
              / "oltp_cluster_torch.py")
    check(script.exists(), f"oltp_cluster: {script} is missing")
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        fail("oltp_cluster: the example ran past 300 s")
    took = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"oltp_cluster: the example exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    for line in out.stdout.splitlines():
        print(f"oltp_cluster: | {line}", flush=True)
    missing = [h for h in OLTP_SECTIONS if h not in out.stdout]
    check(not missing, f"oltp_cluster: sections not printed: {missing}")
    speedup = SPEEDUP_LINE.search(out.stdout)
    knee = KNEE_LINE.search(out.stdout)
    check(speedup is not None and float(speedup.group(1)) > 1,
          f"oltp_cluster: P4DB / No-Switch speedup "
          f"{speedup and speedup.group(1)}")
    check(knee is not None and float(knee.group(1)) > 0,
          f"oltp_cluster: saturation knee {knee and knee.group(1)}")
    print(f"oltp_cluster [{smi}]: phase 22 took {took:.1f} s (the example's "
          f"wall time, host only); speedup {speedup.group(1)}x, knee "
          f"{knee.group(1)} M/s", flush=True)
    return dict(speedup=float(speedup.group(1)),
                knee_m_per_s=float(knee.group(1)), seconds=took)

# --------------------------------------------------------------- phase 23 --

def _sync_cards():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _planes(c):
    sw = c.switch
    return sw.planes if hasattr(sw, "planes") else [sw]


def _mixed_stream(rng, keys, n_txns, pool):
    """tests/test_multiswitch.py's ``_mixed_txns`` shape over ``keys``:
    1-4 distinct keys a txn, each op drawn from ``pool``, operands 1-8; an
    ADDP forwards the result of an earlier op of its txn (as a first op it
    is an ADD)."""
    from repro_torch.core.packets import ADD, ADDP
    from repro_torch.db.txn import Txn, node_of
    txns = []
    for _ in range(n_txns):
        picks = rng.choice(len(keys), size=int(rng.integers(1, 5)),
                           replace=False)
        ops = []
        for j, i in enumerate(picks):
            o, v = pool[int(rng.integers(len(pool)))], int(rng.integers(1, 9))
            if o == ADDP:
                o, v = (ADDP, int(rng.integers(j))) if j else (ADD, v)
            ops.append((o, keys[int(i)], v))
        txns.append(Txn("mixed", ops, node_of(ops[0][1])))
    return txns


def _round_robin(keys, n):
    """tests/test_multiswitch.py's ``_round_robin_placement`` at full
    width: keys dealt across the n planes, then stages, then registers,
    so every plane holds keys and co-accessed keys straddle planes."""
    from repro_torch.core.hotset import HotIndex
    from repro_torch.core.layout import Placement
    return HotIndex(Placement(slot={k: (i % n, (i // n) % S, i // (n * S))
                                    for i, k in enumerate(keys)}))


def _cross_rows(txns, hi):
    """Hot txns whose keys lie on more than one plane."""
    return sum(1 for t in txns if all(hi.is_hot(k) for _, k, _ in t.ops)
               and len({hi.placement.slot[k][0] for _, k, _ in t.ops}) > 1)


def _run_timed(c, txns):
    """``txns`` through ``run_batch`` in groups of 256, every card
    synchronised around each call; (results, seconds).  An async cluster
    is drained after the timed calls: that fills its results in place."""
    outs, took = [], 0.0
    for b in range(0, len(txns), B):
        batch = copy.deepcopy(txns[b:b + B])
        _sync_cards()
        t0 = time.perf_counter()
        outs.append(c.run_batch(batch))
        _sync_cards()
        took += time.perf_counter() - t0
    c.drain()
    return [r for out in outs for r in out], took


def _same_as_n1(c1, r1, cn, rn, hot, what, wal="order"):
    """Results, GIDs, per-key reads and WAL streams of an n-plane cluster
    against the one-plane cluster of the same txns.  ``wal``: "order",
    each node's (kind, tid) records equal one for one; "records", the
    same records in any order (an auto-mode cluster splits a hot group at
    multipass ADDP txns, and which txns are multipass depends on the
    placement); None, not held here (an async cluster logs its results at
    its drains; its WAL is held against its CPU port twin)."""
    check(rn == r1, f"{what}: per-txn results differ from n_switches=1")
    check(cn.switch.next_gid == c1.switch.next_gid,
          f"{what}: GIDs differ from n_switches=1")
    check(cn.read_batch(hot) == c1.read_batch(hot),
          f"{what}: per-key reads differ from n_switches=1")
    stream = lambda c: [[(e.kind, e.tid) for e in n.wal] for n in c.nodes]
    if wal == "records":
        stream = lambda c: [sorted((e.kind, e.tid) for e in n.wal)
                            for n in c.nodes]
    check(wal is None or stream(cn) == stream(c1),
          f"{what}: WAL records differ from n_switches=1")


def multicard_path(tk, smi):
    """Phase 23: the multi-switch register plane across cards, on phase
    4's full-width YCSB-A switch (24 x 65536 registers a plane).  With the
    default device a sharded switch puts plane i on ``cuda:(i %
    device_count)`` (``core/engine.py::plane_devices``, the JAX package's
    one-plane-a-device rule); on one card every plane is on cuda:0.
    (a) at n_switches 2 and 4, each plane's registers on its card; (b) 2 x
    256 YCSB-A txns at n = 1, 2, 4 (and n = 4 with async dispatch, a
    stream a plane): results, GIDs, per-key reads and WAL streams equal
    to n = 1, and every plane's registers, stats and WAL heads equal to a
    CPU port cluster of the same n; (c) a ``_mixed_txns`` stream of cross-
    shard rows at n = 2 and 4 in ``pallas`` mode (READ, WRITE, ADD, CADD)
    and in ``auto`` mode with cross-shard ADDP as well, against n = 1 and
    the CPU port; (d) at n = 2 with a standby: checkpoint, crash,
    recover_switch, crash, fail_over, a migration and a brown-out, each
    against the CPU port; (e) with two cards or more, phase 4 on the last
    card.  Prints the cards, the placement, dispatches per plane and
    run_batch seconds at n = 1, 2, 4 (for the record, not a claim).
    Returns the cards, the placements and the launches of each run."""
    from repro_torch.core.engine import plane_devices
    from repro_torch.core.hotset import build_hot_index
    from repro_torch.core.packets import (ADD, ADDP, CADD, READ, WRITE,
                                          SwitchConfig)
    from repro_torch.db import migrate as mig
    from repro_torch.db.dbms import Cluster
    from repro_torch.workloads import ycsb

    t_phase = time.perf_counter()
    p = ycsb.YCSBParams(variant="A")            # phase 4's
    cards = torch.cuda.device_count()
    print(f"multicard [{smi}]: {cards} card{'s' if cards > 1 else ''} "
          f"visible" + ("" if cards > 1 else ": every plane on cuda:0, the "
                        "placement rule's one-card case"), flush=True)
    sample = ycsb.generate(np.random.default_rng(SEED), 4000, p)
    txns = ycsb.generate(np.random.default_rng(SEED + 3), 2 * B, p)
    cfgs, his = {}, {}
    for n in (1, 2, 4):
        cfgs[n] = SwitchConfig(n_stages=S, regs_per_stage=R, max_instrs=K,
                               n_switches=n)
        his[n] = build_hot_index(ycsb.traces(sample), top_k=400,
                                 switch=cfgs[n])
    hot = sorted(his[1].placement.slot)
    check(all(sorted(h.placement.slot) == hot for h in his.values()),
          "multicard: hot sets differ across shard counts")

    def pair(n, mode="pallas", hi=None, **kw):
        made = [Cluster(8, cfgs[n], his[n] if hi is None else hi,
                        switch_mode=mode, device=d, **kw)
                for d in ("cuda", "cpu")]
        for c in made:
            c.snapshot_offload()
        return made

    # (a) and (b)
    rows, worlds = [], {}
    record = dict(cards=cards, placement={}, launches={})
    for n, kw in ((1, {}), (2, {}), (4, {}),
                  (4, dict(async_hot=True, max_inflight=4))):
        gpu, cpu = pair(n, **kw)
        placed = [pl.registers.device for pl in _planes(gpu)]
        want = plane_devices(n, "cuda", cards)
        check(n == 1 or placed == want,
              f"multicard (a): n={n} planes on {placed}, expected {want}")
        _reset(tk)
        out, took = _run_timed(gpu, txns)
        launches = _nonzero(_counts(tk))
        out_cpu, _ = _run_timed(cpu, txns)
        what = f"multicard (b) n={n}{' async' if kw else ''}"
        check(out == out_cpu, f"{what}: results differ from the CPU port")
        _same_clusters(gpu, cpu, what)
        check(launches.get("switch_txn_smem", 0) > 0,
              f"{what}: the single-CTA switch_txn was not launched: "
              f"{launches}")
        per_plane = [pl.dispatch_count for pl in _planes(gpu)]
        holding = {sl[0] for sl in his[n].placement.slot.values()}
        check(all(per_plane[i] for i in holding),
              f"{what}: a plane that holds hot keys took no dispatch: "
              f"{per_plane}")
        if n > 1:
            _same_as_n1(worlds[1][0], worlds[1][1], gpu, out, hot, what,
                        wal=None if kw else "order")
        worlds.setdefault(n, (gpu, out))
        record["placement"][n] = [str(d) for d in placed]
        record["launches"][what[len("multicard "):]] = launches
        rows.append(f"n={n}{' async' if kw else ''}: planes on "
                    f"{[str(d) for d in placed]}, dispatches per plane "
                    f"{per_plane}, run_batch total {took:.4f} s, "
                    f"{_cross_rows(txns, his[n])} cross-shard hot rows, "
                    f"launches {launches}")
    del worlds
    print("multicard (a), (b): 2 x 256 YCSB-A txns equal to n=1 and to the "
          "CPU port; " + "; ".join(rows), flush=True)

    # (c) cross-shard rows, with cross-shard ADDP in auto mode, on the
    # round-robin placement: every plane (every card) holds hot keys
    rows = []
    for mode, pool in (("pallas", [READ, WRITE, ADD, CADD]),
                       ("auto", [READ, WRITE, ADD, CADD, ADDP])):
        stream = _mixed_stream(np.random.default_rng(SEED + 23), hot,
                               2 * B, pool)
        c1 = Cluster(8, cfgs[1], _round_robin(hot, 1), switch_mode=mode,
                     device="cuda")
        c1.snapshot_offload()
        r1, t1 = _run_timed(c1, stream)
        for n in (2, 4):
            rr = _round_robin(hot, n)
            gpu, cpu = pair(n, mode, rr)
            _reset(tk)
            out, took = _run_timed(gpu, stream)
            launches = _nonzero(_counts(tk))
            out_cpu, _ = _run_timed(cpu, stream)
            what = f"multicard (c) {mode} n={n}"
            check(out == out_cpu, f"{what}: results differ from the CPU "
                  f"port")
            _same_clusters(gpu, cpu, what)
            _same_as_n1(c1, r1, gpu, out, hot, what,
                        wal="order" if mode == "pallas" else "records")
            check(launches.get("switch_walk_smem.serial", 0) > 0,
                  f"{what}: no cross-shard row ran its serial minis: "
                  f"{launches}")
            per_plane = [pl.dispatch_count for pl in _planes(gpu)]
            check(all(per_plane), f"{what}: a plane took no dispatch: "
                  f"{per_plane}")
            record["launches"][what[len("multicard "):]] = launches
            rows.append(f"{mode} n={n}: {_cross_rows(stream, rr)} "
                        f"cross-shard rows, dispatches per plane "
                        f"{per_plane}, run_batch total {took:.4f} s (n=1 "
                        f"{t1:.4f} s), launches {launches}")
    print("multicard (c): " + "; ".join(rows), flush=True)

    # (d) durability on spread planes
    gpu, cpu = pair(2, standby=True)
    steps = []

    def both(what, fn):
        for c in (gpu, cpu):
            fn(c)
        _same_state(gpu, cpu, f"multicard (d) {what}")
        steps.append(what)

    both("first batch", lambda c: c.run_batch(copy.deepcopy(txns[:B])))
    both("checkpoint", lambda c: c.checkpoint())
    both("second batch", lambda c: c.run_batch(copy.deepcopy(txns[B:])))
    before = gpu.switch.read_all()
    both("crash, recover_switch",
         lambda c: (c.crash_switch(), c.recover_switch()))
    check(np.array_equal(before, gpu.switch.read_all()),
          "multicard (d): registers after recover_switch differ")
    both("crash, fail_over", lambda c: (c.crash_switch(), c.fail_over()))
    check(np.array_equal(before, gpu.switch.read_all()),
          "multicard (d): registers after fail_over differ")
    moved = build_hot_index(ycsb.traces(ycsb.generate(
        np.random.default_rng(SEED + 24), 4000, p)), top_k=400,
        switch=cfgs[2])
    # the migration's tids come from one module counter: restart it for
    # each cluster, so both log the same WAL records
    both("migrate", lambda c: (setattr(mig, "_MIG_TID",
                                       itertools.count(1 << 40)),
                               mig.migrate(c, moved)))
    both("brown-out", lambda c: (c.enter_brownout(), c.exit_brownout()))
    more = ycsb.generate(np.random.default_rng(SEED + 25), B, p)
    both("third batch", lambda c: c.run_batch(copy.deepcopy(more)))
    print(f"multicard (d): n=2 planes on "
          f"{[str(pl.registers.device) for pl in _planes(gpu)]} (standby "
          f"{[str(pl.registers.device) for pl in gpu._standby.planes]}): "
          f"{', '.join(steps)} equal to the CPU port (registers, GIDs, "
          f"stats, WAL heads, stores)", flush=True)
    del gpu, cpu

    # (e) the launcher repair alone: phase 4 on the last card
    if cards > 1:
        main_path(tk, smi, device=f"cuda:{cards - 1}")
    print(f"multicard: phase 23 took {time.perf_counter() - t_phase:.1f} s"
          + ("" if cards > 1 else "; (e) needs two cards"), flush=True)
    return record



# --------------------------------------------------------------- phase 24 --

SPIN_CYCLES = 20_000_000        # torch.cuda._sleep: ~10 ms on an H100


def _dispatch_threads():
    """The dispatch threads alive (the CPU port's async engines')."""
    import threading
    return {t.ident for t in threading.enumerate()
            if t.name.startswith("switch-dispatch")}


def _wal_by_tid(c):
    """Each node's WAL records, its switch_result records set apart and
    ordered by tid: an async cluster logs a hot group's results at its
    drain, which may come later in the log than a sync cluster's;
    nothing else moves."""
    return [([(e.kind, e.tid, e.payload) for e in n.wal
              if e.kind != "switch_result"],
             sorted(((e.tid, e.payload) for e in n.wal
                     if e.kind == "switch_result"), key=lambda r: r[0]))
            for n in c.nodes]


def _same_as_sync(a, s_, what):
    check(np.array_equal(a.switch.read_all(), s_.switch.read_all()),
          f"{what}: registers differ from the sync card cluster")
    check(a.switch.next_gid == s_.switch.next_gid,
          f"{what}: next_gid differs from the sync card cluster")
    check(dict(a.stats) == dict(s_.stats),
          f"{what}: stats differ from the sync card cluster")
    check(_wal_by_tid(a) == _wal_by_tid(s_),
          f"{what}: WAL records differ from the sync card cluster")


def _drained(c, batches):
    """``batches`` through ``run_batch``, then one drain; the results."""
    outs = [c.run_batch(b) for b in batches]
    c.drain()
    return [r for out in outs for r in out]


def _dispatch_pieces(cfg, pkts, meta, reps=21):
    """Median host µs of each piece of one ``pallas`` dispatch of
    ``pkts``, on a throwaway async card engine (its stream queue) and a
    sync one, each piece alone with the card idle before it: staging,
    entering the stream, the H2D copy, the launch, the D2H copies, the
    done event; the sync engine's pageable H2D, launch and drain reads.
    For the record: where the host time of a dispatch goes."""
    from repro_torch.core.engine import SwitchEngine, _bucket, _run_fused
    B, K = pkts["op"].shape
    idx = meta["gather_idx"]
    M, Bp = len(idx), _bucket(B)
    Mp = min(_bucket(max(M, 1)), Bp * K)
    out = {}

    def timed(name, fn):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        out[name] = statistics.median(ts)

    for kind in ("async", "sync"):
        eng = SwitchEngine(cfg, async_dispatch=kind == "async",
                           device="cuda")
        q = eng._queue
        scope = (lambda: q._scope) if kind == "async" \
            else contextlib.nullcontext
        buf = q.stager.stage(pkts, idx, Bp, Mp)
        with scope():
            fused = q.put(buf)
            _, _, ok, compact = _run_fused("pallas", eng.registers, fused, Mp)
        timed(f"{kind} execute_batch", lambda: eng.execute_batch(
            pkts, meta, mode="pallas", defer=True))
        timed(f"{kind} stage", lambda: q.stager.stage(pkts, idx, Bp, Mp))

        def put():
            with scope():
                q.put(buf)

        def launch():
            with scope():
                _run_fused("pallas", eng.registers, fused, Mp)
        timed(f"{kind} put (H2D)", put)
        timed(f"{kind} launch", launch)
        if kind == "async":
            def enter():
                with scope():
                    pass

            def enter_torch():
                with torch.cuda.stream(q.stream):
                    pass

            def host():
                with scope():
                    q.host(ok[:B], compact[:M])

            def event():
                torch.cuda.Event().record(q.stream)
            timed("async stream scope", enter)
            timed("(torch.cuda.stream scope)", enter_torch)
            timed("async 2 D2H into one pinned buffer", host)
            timed("async done event", event)
        else:
            timed("sync drain reads (.cpu() x 2)",
                  lambda: (compact[:M].cpu(), ok[:B].cpu()))
    return out


def stream_async(tk, smi):
    """Phase 24: async hot dispatch on CUDA streams and events.  An async
    engine on the card runs every dispatch on the caller's thread under
    a stream of its own (``core/dispatch.py::StreamQueue``), with pinned
    staging slots each guarded by the event recorded after its copy.
    (a) phase 4's YCSB-A and phase 9's SmallBank in ``pallas`` and
    ``auto`` mode, ``async_hot`` at max_inflight 2 and 4, each equal to a
    sync card cluster (results, registers, GIDs, stats, WAL records) and
    to an async CPU port cluster (the same and WAL heads), no dispatch
    thread started; (b) a WRITE-only load burst three times the stager's
    pool deep, queued behind a spin kernel on the plane's stream, no
    drain, then ``read_all`` equal to the CPU port; (c) a deferred
    ``execute_batch`` behind a spin returns before its kernel ran (its
    done event's ``query()`` False): its host µs, then its results
    against a CPU engine; (d) planes at n_switches 2 and 4 on one card
    each on a stream of its own; (e) phase 23 (b)'s 2 x 256 YCSB-A
    ``run_batch`` totals, sync against async, at n = 1 and 4, in turns,
    a first and a second pass on each cluster.
    Returns (e)'s totals."""
    from repro_torch.core.dispatch import StreamQueue
    from repro_torch.core.engine import ShardedSwitchEngine, SwitchEngine
    from repro_torch.core.hotset import build_hot_index
    from repro_torch.core.packets import ADDP, SwitchConfig, build_packets
    from repro_torch.db.dbms import Cluster
    from repro_torch.workloads import smallbank, ycsb

    t_phase = time.perf_counter()
    cfg, yhi, ytxns, _ = _ycsb_setup()
    sp = smallbank.SmallBankParams()            # phase 9's
    sample = smallbank.generate(np.random.default_rng(SEED), 6000, sp)
    shi = build_hot_index(smallbank.traces(sample),
                          top_k=sp.hot_per_node * sp.n_nodes * 2, switch=cfg)
    stxns = smallbank.generate(np.random.default_rng(SEED + 1), 4 * B, sp)
    sloads = [(k, 100) for k in smallbank.hot_keys(sp)]
    no_addp = [t for t in stxns if all(o != ADDP for o, _, _ in t.ops)]
    cases = [("YCSB-A", "pallas", yhi, ytxns, []),
             ("YCSB-A", "auto", yhi, ytxns, []),
             ("SmallBank", "pallas", shi, no_addp, sloads),
             ("SmallBank", "auto", shi, stxns, sloads)]

    def make(hi, mode, loads, device, **kw):
        c = Cluster(8, cfg, hi, switch_mode=mode, device=device, **kw)
        for k, v in loads:
            c.load(k, v)
        c.snapshot_offload()
        return c

    def batches(txns):
        return [copy.deepcopy(txns[i:i + B]) for i in range(0, len(txns), B)]

    # (a)
    rows = []
    for name, mode, hi, txns, loads in cases:
        want = _drained(make(hi, mode, loads, "cuda"), batches(txns))
        sync = make(hi, mode, loads, "cuda")
        check(_drained(sync, batches(txns)) == want,
              f"stream async (a) {name} {mode}: two sync runs differ")
        for inflight in (2, 4):
            what = f"stream async (a) {name} {mode} max_inflight={inflight}"
            before = _dispatch_threads()
            gpu = make(hi, mode, loads, "cuda", async_hot=True,
                       max_inflight=inflight)
            check(isinstance(gpu.switch._queue, StreamQueue),
                  f"{what}: the engine is not on the stream queue")
            _reset(tk)
            out = _drained(gpu, batches(txns))
            launches = _nonzero(_counts(tk))
            check(_dispatch_threads() <= before,
                  f"{what}: a switch-dispatch thread started on the card")
            cpu = make(hi, mode, loads, "cpu", async_hot=True,
                       max_inflight=inflight)
            out_cpu = _drained(cpu, batches(txns))
            check(out == want, f"{what}: results differ from the sync card "
                  f"cluster")
            check(out == out_cpu, f"{what}: results differ from the CPU port")
            _same_as_sync(gpu, sync, what)
            _same_clusters(gpu, cpu, what)
            check(gpu.switch.dispatch_count > 0 and launches,
                  f"{what}: no dispatch ran on the card: {launches}")
            rows.append(f"{name} {mode} max_inflight={inflight}: "
                        f"{len(txns)} txns ({gpu.stats['hot']} hot), "
                        f"{gpu.switch.dispatch_count} dispatches, launches "
                        f"{launches}")
    print("stream async (a): equal to the sync card cluster (results, "
          "registers, GIDs, stats, WAL records) and to the async CPU port "
          "(the same, WAL heads); no dispatch thread; " + "; ".join(rows),
          flush=True)

    # (b) the staging guard: a WRITE-only load burst behind a spin
    gpu = make(yhi, "pallas", [], "cuda", async_hot=True, max_inflight=2)
    cpu = make(yhi, "pallas", [], "cpu", async_hot=True, max_inflight=2)
    q = gpu.switch._queue
    depth = q.stager.pool
    loads = [(k, 1000 + i)
             for i, k in enumerate(sorted(yhi.placement.slot)[:3 * depth])]
    torch.cuda.synchronize()
    with torch.cuda.stream(q.stream):
        torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for k, v in loads:
        gpu.load(k, v)
    burst_ms = (time.perf_counter() - t0) * 1e3
    for k, v in loads:
        cpu.load(k, v)
    _same_clusters(gpu, cpu, "stream async (b)")
    check(all(gpu.read(k) == v for k, v in loads),
          "stream async (b): a load was lost")
    print(f"stream async (b): {len(loads)} WRITE-only loads through a "
          f"{depth}-slot staging ring behind a {SPIN_CYCLES:,}-cycle spin, "
          f"no drain: {burst_ms:.3f} ms on the host (the guard waits on the "
          f"slots' copy events), read_all equal to the CPU port", flush=True)

    # (c) a deferred dispatch returns while its kernel waits
    hot = [t for t in ytxns if all(yhi.is_hot(k) for _, k, _ in t.ops)][:B]
    pkts, meta = build_packets(hot, yhi, cfg)
    before = _dispatch_threads()
    eng = SwitchEngine(cfg, async_dispatch=True, device="cuda")
    syn = SwitchEngine(cfg, device="cuda")
    ref = SwitchEngine(cfg, device="cpu")
    for e in (eng, syn, ref):       # the first call resolves the launcher
        e.execute_batch(pkts, meta, mode="pallas").results_np()
    async_us, sync_us, pending = [], [], []
    for _ in range(9):
        torch.cuda.synchronize()
        with torch.cuda.stream(eng._queue.stream):
            torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        pb = eng.execute_batch(pkts, meta, mode="pallas", defer=True)
        async_us.append((time.perf_counter() - t0) * 1e6)
        pending.append(not pb._fut.done())
        want = ref.execute_batch(pkts, meta, mode="pallas")
        check(np.array_equal(pb.results_np(), want.results_np())
              and np.array_equal(pb.ok_np(), want.ok_np()),
              "stream async (c): deferred results differ from the CPU engine")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sb = syn.execute_batch(pkts, meta, mode="pallas")
        sync_us.append((time.perf_counter() - t0) * 1e6)
        sb.results_np()
    check(all(pending), f"stream async (c): a deferred execute_batch "
          f"returned after its kernel ran: {pending}")
    check(np.array_equal(eng.read_all(), ref.read_all()),
          "stream async (c): registers differ from the CPU engine")
    check(_dispatch_threads() <= before,
          "stream async (c): a switch-dispatch thread started on the card")
    pieces = _dispatch_pieces(cfg, pkts, meta)
    print(f"stream async (c): a deferred execute_batch ({len(hot)} hot txns, "
          f"N = {pkts['op'].size}) behind a spin returned with its done "
          f"event pending {sum(pending)}/{len(pending)} times in "
          f"{statistics.median(async_us):.1f} µs on the host (median; "
          f"{min(async_us):.1f}-{max(async_us):.1f}); the sync engine's "
          f"call {statistics.median(sync_us):.1f} µs "
          f"({min(sync_us):.1f}-{max(sync_us):.1f}); results equal to the "
          f"CPU engine; host µs by piece, the card idle (medians): "
          + ", ".join(f"{k} {v:.1f}" for k, v in pieces.items()),
          flush=True)

    # (d) one stream a plane, planes sharing a card too
    rows = []
    for n in (2, 4):
        e = ShardedSwitchEngine(dataclasses.replace(cfg, n_switches=n),
                                async_dispatch=True, device="cuda:0")
        handles = [pl._queue.stream.cuda_stream for pl in e.planes]
        check(all(isinstance(pl._queue, StreamQueue) for pl in e.planes)
              and len(set(handles)) == n
              and torch.cuda.current_stream(0).cuda_stream not in handles,
              f"stream async (d): n={n} planes on streams {handles}")
        rows.append(f"n={n}: {[hex(h) for h in handles]}")
    check(_dispatch_threads() <= before,
          "stream async (d): a switch-dispatch thread started on the card")
    print("stream async (d): one stream a plane on cuda:0, " + "; ".join(rows)
          + "; no dispatch thread started by a card engine", flush=True)

    # (e) sync against async run_batch totals (phase 23 (b)'s setup): each
    # cluster runs the stream twice, a first pass on fresh engines (a new
    # stream's allocator pool, new pinned staging) and a second
    p = ycsb.YCSBParams(variant="A")
    sample = ycsb.generate(np.random.default_rng(SEED), 4000, p)
    txns = ycsb.generate(np.random.default_rng(SEED + 3), 2 * B, p)
    totals, first = {}, {}
    for n in (1, 4):
        cfg_n = dataclasses.replace(cfg, n_switches=n)
        hi = build_hot_index(ycsb.traces(sample), top_k=400, switch=cfg_n)
        for kind in ("sync", "async", "async", "sync"):
            kw = dict(async_hot=True, max_inflight=4) if kind == "async" \
                else {}
            c = Cluster(8, cfg_n, hi, switch_mode="pallas", device="cuda",
                        **kw)
            c.snapshot_offload()
            for pass_ in ("first", "second"):
                work = batches(txns)
                _sync_cards()
                t0 = time.perf_counter()
                out = _drained(c, work)
                _sync_cards()
                totals.setdefault(f"n={n} {kind} {pass_}", []).append(
                    time.perf_counter() - t0)
                check(out == first.setdefault(pass_, out),
                      f"stream async (e) n={n} {kind} {pass_} pass: results "
                      f"differ")
    ratio = {f"n={n} {pass_}":
             statistics.mean(totals[f"n={n} async {pass_}"])
             / statistics.mean(totals[f"n={n} sync {pass_}"])
             for n in (1, 4) for pass_ in ("first", "second")}
    print(f"stream async (e) [{smi}]: 2 x {B} YCSB-A pallas run_batch "
          f"totals, drain included, s (sync, async, async, sync clusters; "
          f"a first and a second pass each): "
          + "; ".join(f"{k} {', '.join(f'{t:.4f}' for t in v)}"
                      for k, v in totals.items())
          + "; async / sync " + ", ".join(f"{k} {r:.3f}"
                                          for k, r in ratio.items()),
          flush=True)
    print(f"stream async: phase 24 took {time.perf_counter() - t_phase:.1f} "
          f"s", flush=True)
    return totals


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    # phase 16 (b) runs under torch.use_deterministic_algorithms, which
    # asks for a fixed cuBLAS workspace before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.moe_route import moe_route as mr
    from repro_torch.kernels.switch_engine import switch_engine as kw
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
    smallbank = cadd_path(tk)
    kernels[0]["dispatch_device_us"], kernels[0]["dispatch_host_us"] = \
        profile_batch(tk, gpu, hi, p)
    walk_prof = walk_profile(tk, gpu.switch_cfg)        # phase 21 (c)
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
    dur = durability(tk, smi)
    kernels[0]["durability"] = dict(
        brownout_reload={w: _nonzero(dur[f"{w}_brownout"]["reload"])
                         for w in ("ycsb", "tpcc")},
        arena_launches=sum(r["launches"] for r in dur["arena"]))
    kernels[1]["durability"] = dict(
        brownout_enter={w: dur[f"{w}_brownout"]["enter"]["result_gather"]
                        for w in ("ycsb", "tpcc")},
        tpcc_reload=dur["tpcc_brownout"]["reload"]["result_gather"])
    walk = walk_path(tk, kw, smi, walk_prof)
    walk[0]["smallbank_auto"] = smallbank
    walk[0]["replays"] = dict(durability=dur["replay_launches"],
                              bounded=[_by_route(r["recover_launches"])
                                       for r in dur["bounded"]])
    kernels += walk
    oltp_cluster(smi)
    kernels[0]["multicard"] = multicard_path(tk, smi)
    stream_async(tk, smi)

    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    _exit(0)
