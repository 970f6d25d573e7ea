"""Where the host time of async dispatch on CUDA streams goes.  First the
host µs of the stream path's CUDA calls alone: a pinned host allocation
(new size, cached size), an event made and recorded, a stream made
current (``core/dispatch.py::OnStream`` beside ``torch.cuda.stream``), a
stream made.  Then one cross-shard mini (a B = 1 serial dispatch read
back at once, as ``ShardedSwitchEngine._exec_cross_row`` runs 808-1,384
of them a sharded run) on a warm sync and a warm async engine in turns,
and each under ``cProfile``.  Last, phase 23 (b)'s 2 x 256 YCSB-A
``run_batch`` runs (``pallas`` mode) at n_switches 1 and 4, sync and
async, each on a fresh cluster once to warm up and once under
``cProfile``.  cProfile adds cost to every Python call, so its shares
are a guide, not a measurement.

Usage, from the repository root: python3 tools/stream_costs.py [--top N]
"""
import argparse
import copy
import cProfile
import dataclasses
import io
import pstats
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core.hotset import build_hot_index  # noqa: E402
from repro_torch.db.dbms import Cluster  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.workloads import ycsb  # noqa: E402


def _us(fn, n=201):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(ts)


def runs(top):
    cfg, _, _, _ = cs._ycsb_setup()
    p = ycsb.YCSBParams(variant="A")
    sample = ycsb.generate(np.random.default_rng(cs.SEED), 4000, p)
    txns = ycsb.generate(np.random.default_rng(cs.SEED + 3), 2 * cs.B, p)
    for n in (1, 4):
        cfg_n = dataclasses.replace(cfg, n_switches=n)
        hi = build_hot_index(ycsb.traces(sample), top_k=400, switch=cfg_n)
        for kind in ("sync", "async"):
            kw = dict(async_hot=True, max_inflight=4) if kind == "async" \
                else {}
            for label in ("warm-up", "profiled"):
                c = Cluster(8, cfg_n, hi, switch_mode="pallas",
                            device="cuda", **kw)
                c.snapshot_offload()
                work = [copy.deepcopy(txns[i:i + cs.B])
                        for i in range(0, len(txns), cs.B)]
                torch.cuda.synchronize()
                prof = cProfile.Profile() if label == "profiled" else None
                t0 = time.perf_counter()
                if prof:
                    prof.enable()
                cs._drained(c, work)
                if prof:
                    prof.disable()
                torch.cuda.synchronize()
                took = time.perf_counter() - t0
                print(f"n={n} {kind} {label}: {took:.4f} s", flush=True)
            print(_top(prof, top), flush=True)


def _top(prof, top):
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(top)
    return "\n".join(line for line in out.getvalue().splitlines()
                     if line.strip() and not line.startswith(
                         ("   Ordered", "   List reduced")))


def minis(top, rounds=4, reps=400):
    """Host µs of one cross-shard mini (``_exec_cross_row``'s B = 1 serial
    dispatch, then its ``results_np`` and ``ok_np``) on a warm sync and a
    warm async engine, in turns (sync, async, async, sync a round)."""
    from repro_torch.core.engine import SwitchEngine
    from repro_torch.core.packets import ADD
    cfg, _, _, _ = cs._ycsb_setup()
    mini = dict(op=np.array([[ADD]], np.int32), stage=np.array([[3]],
                                                                 np.int32),
                reg=np.array([[7]], np.int32),
                operand=np.array([[1]], np.int32))
    engines = {kind: SwitchEngine(cfg, async_dispatch=kind == "async",
                                  device="cuda") for kind in ("sync", "async")}

    def cycle(e):
        pb = e.execute_batch(mini, mode="serial")
        pb.results_np()
        pb.ok_np()

    for e in engines.values():
        for _ in range(50):
            cycle(e)
    got = {k: [] for k in engines}
    for _ in range(rounds):
        for kind in ("sync", "async", "async", "sync"):
            e = engines[kind]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                cycle(e)
            got[kind].append((time.perf_counter() - t0) / reps * 1e6)
    for kind, e in engines.items():
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(reps):
            cycle(e)
        prof.disable()
        print(f"mini cycle, {kind}, {reps} under cProfile:\n"
              + _top(prof, top), flush=True)
    check = engines["sync"].read_all() == engines["async"].read_all()
    print("mini cycle host µs (B = 1 serial dispatch + results_np + ok_np, "
          f"{reps} a turn): " + "; ".join(
              f"{k} {', '.join(f'{v:.1f}' for v in vs)} (median "
              f"{statistics.median(vs):.1f})" for k, vs in got.items())
          + f"; registers equal: {bool(check.all())}", flush=True)


def calls():
    dev = torch.device("cuda", 0)
    s = torch.cuda.Stream(device=dev)
    on = dispatch.OnStream(s)
    sizes, kept = iter(1 << k for k in range(14, 40)), []

    def torch_scope():
        with torch.cuda.stream(s):
            pass

    out = {
        "pinned alloc, a new size": _us(lambda: kept.append(torch.empty(
            next(sizes), dtype=torch.uint8, pin_memory=True)), n=11),
        "pinned alloc, a cached size": _us(lambda: torch.empty(
            4096, dtype=torch.uint8, pin_memory=True)),
        "Event() + record": _us(lambda: torch.cuda.Event().record(s)),
        "OnStream enter + exit": _us(lambda: on.__enter__() or
                                     on.__exit__(None, None, None)),
        "torch.cuda.stream enter + exit": _us(torch_scope),
        "torch.cuda.Stream()": _us(lambda: torch.cuda.Stream(device=dev),
                                   n=51),
    }
    print("host µs, medians: " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in out.items()),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a GPU")
    t0 = time.perf_counter()
    print(f"device: {torch.cuda.get_device_name(0)} | {cs.nvidia_smi()}",
          flush=True)
    with ThreadPoolExecutor(len(build.LIBRARIES)) as pool:  # one nvcc each
        list(pool.map(build.library, build.LIBRARIES))
    calls()
    minis(args.top)
    runs(args.top)
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
    cs._exit(0)
