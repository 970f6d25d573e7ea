"""The async paths of ``chip_smoke.py`` alone, after building the kernel
libraries: phase 4 (whose cluster phase 8 reads), phase 8 (reads with
undrained async groups), phase 20 (the crash points, async ones too),
phase 23 (n = 4 async among the sharded runs) and phase 24 (async hot
dispatch on CUDA streams and events, with its sync-against-async
``run_batch`` totals).  Prints the phases' lines and the seconds taken.
``--phases 23,24`` runs only those (phase 8 needs phase 4); on a machine
with several cards phase 23 spreads the planes over them, each plane on
a stream of its own card.

Usage, from the repository root:
    python3 tools/stream_async.py [--phases 4,8,20,23,24]
"""
import argparse
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.switch_txn import switch_txn as tk  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="4,8,20,23,24")
    phases = {int(x) for x in ap.parse_args().phases.split(",")}
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: these phases need a "
                "GPU")
    t0 = time.perf_counter()
    smi = cs.nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    with ThreadPoolExecutor(len(build.LIBRARIES)) as pool:  # one nvcc each
        list(pool.map(build.library, build.LIBRARIES))
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    if phases & {4, 8}:
        _, gpu, cpu, hi, p, _ = cs.main_path(tk, smi)
        del gpu, cpu
        if 8 in phases:
            cs.async_read_path(tk, hi, p)
    if 20 in phases:
        cs.durability(tk, smi)
    if 23 in phases:
        cs.multicard_path(tk, smi)
    if 24 in phases:
        cs.stream_async(tk, smi)
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
    cs._exit(0)
