"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each one exits non-zero on failure):

1. device   — the card's name and power limit;
2. build    — compile the switch_txn kernels from ``src/repro_torch``;
3. kernels  — each kernel against its plain PyTorch version on the card at
              the hot path's shapes, timed with CUDA events;
4. main     — P4DB's hot-transaction path at full width: an 8-node YCSB-A
              cluster on a 24 x 65536 switch register file in ``pallas``
              mode, 8 ``run_batch`` calls of 256 txns, held against the
              same txns through a CPU port cluster, then crash recovery;
5. cadd     — SmallBank without ADDP (CADD constraints) on the card against
              the CPU port;
6. profile  — one more YCSB batch under ``torch.profiler`` for the device's
              busy share.

Prints a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Imports nothing
of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
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

def kernel_checks(tk, lib, dev):
    rng = np.random.default_rng(SEED)
    n_slots, n = S * R, B * K
    regs = rng.integers(-1000, 1000, n_slots).astype(np.int32)
    hot = np.array([7, 3 * R + 11, n_slots - 1])
    regs[hot] = [2**31 - 20, -2**31 + 5, 0]                  # int32 edges
    op = rng.integers(0, 5, n).astype(np.int32)             # all 5 opcodes
    g = rng.integers(0, n_slots, n).astype(np.int32)
    skew = rng.random(n) < 0.5                               # hot-key skew
    g[skew] = hot[rng.integers(0, 3, int(skew.sum()))]
    g[rng.integers(0, n, 4)] = n_slots + 7                   # clamped slots
    val = rng.integers(-100, 100, n).astype(np.int32)
    edge = rng.random(n) < 0.05
    val[edge] = rng.choice([2**31 - 1, -2**31, 2**30], int(edge.sum()))
    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    regs_t, op_t, g_t, val_t = t(regs), t(op), t(g), t(val)

    r_k, res_k, ok_k = tk.switch_txn_call(regs_t.clone(), op_t, g_t, val_t)
    r_p, res_p, ok_p = tk.switch_txn_plain(regs_t.clone(), op_t, g_t, val_t)
    torch.cuda.synchronize()
    for name, a, b in (("registers", r_k, r_p), ("res", res_k, res_p),
                       ("ok", ok_k, ok_p)):
        check(torch.equal(a, b), f"switch_txn {name} differ from plain")
    check(int((ok_k == 0).sum()) > 0, "no CADD was refused in the check")
    err_txn = max(int((a.long() - b.long()).abs().max()) for a, b in
                  ((r_k, r_p), (res_k, res_p), (ok_k, ok_p)))

    work = regs_t.clone()
    ms_txn = time_cuda(lambda: tk.switch_txn_call(work, op_t, g_t, val_t),
                       inner=50, reps=11)
    plain_ms_txn = time_cuda(
        lambda: tk.switch_txn_plain(work, op_t, g_t, val_t), inner=2, reps=5)
    sorted_g, perm = torch.sort(tk._sort_key(work, op_t, g_t), stable=True)
    res_buf, ok_buf = torch.empty_like(op_t), torch.empty_like(op_t)
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernel_ms_txn = time_cuda(lambda: lib.switch_txn_launch(
        work.data_ptr(), n_slots, op_t.data_ptr(), val_t.data_ptr(),
        sorted_g.data_ptr(), perm.data_ptr(), res_buf.data_ptr(),
        ok_buf.data_ptr(), n, stream), inner=200, reps=11)
    distinct = int(torch.unique(sorted_g[sorted_g < n_slots]).numel())
    # stream in (op, g, val), res + ok out, one read + one write per
    # distinct register touched; one RMW per instruction
    b_txn, by_txn = bound_ms(4 * 3 * n + 4 * 2 * n + 8 * distinct, n)

    m = 4096
    src = res_k
    idx = rng.integers(0, n + 64, m).astype(np.int32)       # some past end
    idx[rng.integers(0, m, 8)] = -3                         # low clamp
    idx_t = t(idx)
    out_k = tk.result_gather_call(src, idx_t)
    out_p = tk.result_gather_plain(src, idx_t)
    torch.cuda.synchronize()
    check(torch.equal(out_k, out_p), "result_gather differs from plain")
    err_g = int((out_k.long() - out_p.long()).abs().max())
    ms_g = time_cuda(lambda: tk.result_gather_call(src, idx_t),
                     inner=200, reps=11)
    plain_ms_g = time_cuda(lambda: tk.result_gather_plain(src, idx_t),
                           inner=200, reps=11)
    out_buf = torch.empty_like(idx_t)
    kernel_ms_g = time_cuda(lambda: lib.result_gather_launch(
        src.data_ptr(), n, idx_t.data_ptr(), out_buf.data_ptr(), m, stream),
        inner=200, reps=11)
    idx_c = idx_t.clamp(0, n - 1).long()
    lib_ms_g = time_cuda(lambda: torch.take(src, idx_c), inner=200, reps=11)
    b_g, by_g = bound_ms(4 * 3 * m, m)                       # idx, src, out
    print(f"kernels: switch_txn {ms_txn * 1e3:.2f} us/call "
          f"(bare launch {kernel_ms_txn * 1e3:.2f} us, plain "
          f"{plain_ms_txn * 1e3:.1f} us, {distinct} distinct slots); "
          f"result_gather {ms_g * 1e3:.2f} us (bare launch "
          f"{kernel_ms_g * 1e3:.2f} us, plain {plain_ms_g * 1e3:.2f} us, "
          f"torch.take {lib_ms_g * 1e3:.2f} us)", flush=True)
    return [
        dict(name="switch_txn", route="cuda",
             source="src/repro_torch/kernels/switch_txn/csrc/switch_txn.cu",
             replaces="src/repro/kernels/switch_txn/switch_txn.py:29",
             launches=0, max_abs_err=err_txn, ms=ms_txn,
             plain_ms=plain_ms_txn, bound_ms=b_txn, bound_by=by_txn,
             library_ms=None, kernel_ms=kernel_ms_txn, shape=[n_slots, n]),
        dict(name="result_gather", route="cuda",
             source="src/repro_torch/kernels/switch_txn/csrc/switch_txn.cu",
             replaces="src/repro/kernels/switch_txn/switch_txn.py:61",
             launches=0, max_abs_err=err_g, ms=ms_g, plain_ms=plain_ms_g,
             bound_ms=b_g, bound_by=by_g, library_ms=lib_ms_g,
             kernel_ms=kernel_ms_g, shape=[n, m]),
    ]


# ---------------------------------------------------------------- phase 4 --

def _wal_heads(c):
    return [n.wal[-1].hash if len(n.wal) else None for n in c.nodes]


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
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the main path: {launches}")
    check(gpu.switch.dispatch_count == launches["switch_txn"],
          "dispatches and switch_txn launches disagree")

    out_cpu = []
    for b in range(8):
        out_cpu += cpu.run_batch(copy.deepcopy(txns[b * B:(b + 1) * B]))
    check(out_gpu == out_cpu, "main: per-txn results differ from CPU port")
    _same_clusters(gpu, cpu, "main")
    check(gpu.stats["hot"] > 0, "main: no hot txns")

    before = gpu.switch.read_all()
    t0 = time.perf_counter()
    known, unknown = gpu.crash_switch_and_recover()
    t_rec = time.perf_counter() - t0
    check(before.tobytes() == gpu.switch.read_all().tobytes(),
          "main: registers after crash recovery differ")

    spans = {}
    for tr in gpu.tracer.traces:
        if tr.label.startswith("batch:"):
            for s_ in tr.spans:
                spans[s_.name] = spans.get(s_.name, 0.0) + s_.duration
    total = sum(times)
    groups = launches["switch_txn"]
    print(f"main [{label}]: {len(txns)} txns ({gpu.stats['hot']} hot) in "
          f"{total:.4f} s = {len(txns) / total:.1f} txn/s, "
          f"{gpu.stats['hot'] / total:.1f} hot txn/s; median run_batch "
          f"{statistics.median(times) * 1e3:.3f} ms; {groups} hot groups "
          f"({groups / 8:.2f} per run_batch); launches {launches}", flush=True)
    print("main: host spans over 8 run_batch (s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in spans.items())
          + f", rest {total - sum(spans.values()):.4f}", flush=True)
    print(f"main: crash_switch_and_recover replayed {known}+{unknown} sends "
          f"in {t_rec:.2f} s, registers identical", flush=True)
    return launches, gpu, txns, p


# ---------------------------------------------------------------- phase 5 --

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
    cpu = Cluster(8, cfg, hi, switch_mode="pallas", device="cpu")
    for c in (gpu, cpu):
        for k in smallbank.hot_keys(p):
            c.load(k, 100)
        c.snapshot_offload()
    for k in tk.LAUNCHES:
        tk.LAUNCHES[k] = 0
    out_gpu, out_cpu = [], []
    for i in range(0, len(txns), B):
        out_gpu += gpu.run_batch(txns[i:i + B])
    launches = dict(tk.LAUNCHES)
    for i in range(0, len(txns), B):
        out_cpu += cpu.run_batch(copy.deepcopy(txns[i:i + B]))
    check(launches["switch_txn"] > 0, "cadd: switch_txn not launched")
    check(out_gpu == out_cpu, "cadd: per-txn results differ from CPU port")
    _same_clusters(gpu, cpu, "cadd")
    print(f"cadd: {len(txns)} SmallBank txns ({gpu.stats['hot']} hot) equal "
          f"to the CPU port; launches {launches}", flush=True)


# ---------------------------------------------------------------- phase 6 --

def profile_batch(gpu, p):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.workloads import ycsb
    batch = ycsb.generate(np.random.default_rng(SEED + 2), B, p)
    gpu.run_batch(batch[:16])                 # warm the recovered engine
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gpu.run_batch(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = 0.0
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")) != "DeviceType.CUDA":
            continue                 # host ops repeat their kernels' time
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            dev_us += t
            rows.append((t, e.key, e.count))
    rows.sort(reverse=True)
    if dev_us == 0:
        print("profile: device time not measured (profiler saw no device "
              "activity)", flush=True)
        return
    short = lambda k: k.replace("(anonymous namespace)::", "").split(
        "(")[0].split("<")[0].split("::")[-1]
    print(f"profile: one run_batch of {B} YCSB-A txns, wall "
          f"{wall * 1e3:.3f} ms (profiler on), device busy "
          f"{dev_us / 1e3:.3f} ms = {dev_us / 1e6 / wall:.4%}; by name: "
          + "; ".join(f"{short(k)} x{c} {t:.1f} us" for t, k, c in rows),
          flush=True)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels.switch_txn import build
    from repro_torch.kernels.switch_txn import switch_txn as tk

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {name} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib = build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'})",
          flush=True)

    kernels = kernel_checks(tk, lib, dev)
    launches, gpu, _, p = main_path(tk, smi)
    for kd in kernels:
        kd["launches"] = launches[kd["name"]]
    cadd_path(tk)
    profile_batch(gpu, p)

    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
