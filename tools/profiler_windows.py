"""Count torch.profiler windows on a CUDA card that miss device activity,
by the way the window is opened.

Each window profiles one warm call of four elementwise kernels and one
device -> host copy, the shape of the checked profiles in
``chip_smoke.py``.  Three kinds of window take turns in one process:

- ``schedule``: ``torch.profiler.schedule(wait=0, warmup=1, active=1)``,
  the call made once in the warmup step and once in the active step;
- ``plain``: one plain session around the call;
- ``spins``: a plain session with a spin kernel before the call and one
  after it (what ``chip_smoke._profile_steps`` does, which keeps a
  window only when both spins were seen).

A window is ``empty`` when it saw no device activity and ``partial`` when
it saw some of the kernels and the copy but not all.  For ``spins``,
``rejected`` counts the windows without both spins, and ``kept_partial``
the kept ones that still missed a kernel or the copy.  ``--age`` seconds
of idle host time pass before the count starts, so a window in an older
process can be seen.  Prints one JSON object.

Usage: python tools/profiler_windows.py [--windows 400] [--age 0]
"""
import argparse
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, schedule

ACT = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
KERNELS = 4


def _rows(prof):
    out = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")) != "DeviceType.CUDA":
            continue
        if getattr(e, "self_device_time_total", 0.0) > 0 \
                and not e.key.startswith("ProfilerStep"):
            out.append((e.key, e.count))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=400)
    ap.add_argument("--age", type=float, default=0.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profiler_windows: needs a CUDA card")
    x = torch.zeros(1 << 20, device="cuda")

    def fn():
        for _ in range(KERNELS):
            x.add_(1)
        return x[:4].cpu()

    def sched():
        with profile(activities=ACT, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        return _rows(prof)

    def plain():
        with profile(activities=ACT) as prof:
            fn()
            torch.cuda.synchronize()
        return _rows(prof)

    def spins():
        with profile(activities=ACT) as prof:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        return _rows(prof)

    kinds = dict(schedule=sched, plain=plain, spins=spins)
    stat = {k: dict(empty=0, partial=0, pattern=[]) for k in kinds}
    stat["spins"].update(rejected=0, kept_partial=0)
    for f in kinds.values():                  # one window each to warm up
        f()
    time.sleep(args.age)
    t0 = time.perf_counter()
    for _ in range(args.windows):
        for k, f in kinds.items():
            rows = f()
            n_spin = sum(c for name, c in rows if "spin_kernel" in name)
            rows = [r for r in rows if "spin_kernel" not in r[0]]
            kernels = sum(c for name, c in rows if "Memcpy" not in name)
            copies = sum(c for name, c in rows if "DtoH" in name)
            whole = kernels >= KERNELS and copies >= 1
            s = stat[k]
            if not rows and not n_spin:
                s["empty"] += 1
                s["pattern"].append("E")
            elif not whole:
                s["partial"] += 1
                s["pattern"].append("P")
            else:
                s["pattern"].append(".")
            if k == "spins":
                s["rejected"] += n_spin != 2
                s["kept_partial"] += n_spin == 2 and not whole
    for s in stat.values():
        s["pattern"] = "".join(s["pattern"])
    print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                          windows=args.windows, age_s=args.age,
                          seconds=time.perf_counter() - t0, **stat)),
          flush=True)


if __name__ == "__main__":
    main()
