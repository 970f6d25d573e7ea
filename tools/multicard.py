"""Phase 23 of ``chip_smoke.py`` alone: the multi-switch register plane
across the visible cards (``chip_smoke.multicard_path``), after building
the kernel libraries.  On a machine with four cards it puts plane i of an
n_switches = 4 cluster on cuda:i and runs phase 4 on the last card too;
with one card every plane is on cuda:0.  Prints the phase's lines, then
one JSON object (the cards, the placements, the launches of each run).

Usage, from the repository root: python3 tools/multicard.py
"""
import json
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
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: phase 23 needs a GPU")
    t0 = time.perf_counter()
    smi = cs.nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | cards "
          f"{torch.cuda.device_count()}", flush=True)
    with ThreadPoolExecutor(len(build.LIBRARIES)) as pool:  # one nvcc each
        list(pool.map(build.library, build.LIBRARIES))
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(cs.multicard_path(tk, smi)), flush=True)
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
    cs._exit(0)
