"""The benchmark of the P4DB port: one run of one cell.

    python3 p4bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up the cell named in ``BENCHMARK.json`` on the card (its cluster,
its tables and traffic from ``--seed``, a warm-up), drives
``Cluster.run_batch`` in a closed loop for ``--seconds`` and drains,
checks every answer and the state the program holds against the plain
reference, and prints one JSON line last: the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics (from a traced run) with
``--trace 1``.  Needs a CUDA card; exits non-zero without a result where
there is none.
"""
import time

_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _process_age() -> float:
    """Seconds since this process started (Linux), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = _START - _process_age()
EXEC_AT = "P4BENCH_EXEC_AT"    # the clock when the first interpreter re-ran


def _start_parts() -> dict:
    """Set-up before ``main``: the first interpreter until its re-exec,
    and the second one's start (the clock is the system's monotonic one,
    the same in both)."""
    at = os.environ.pop(EXEC_AT, None)
    if at is None:
        return {"interpreter": _START - T0}
    return {"interpreter": float(at) - T0, "re_exec": _START - float(at)}


def _fail(msg: str, code: int):
    print(f"p4bench: {msg}", file=sys.stderr, flush=True)
    sys.stdout.flush()
    os._exit(code)


def _forbidden_modules():
    return sorted({n.split(".")[0] for n in sys.modules} & FORBIDDEN)


def _environment():
    """Settings every run takes before torch loads (a re-exec for the
    first)."""
    # str hashes are salted per process unless PYTHONHASHSEED is set, and
    # the salt moves the layout of every str-keyed dict the host path
    # probes (attributes, the cluster's stats): one process runs up to a
    # third faster than another on the same traffic.  Every run takes the
    # same salt; the exec keeps the process and its start time.
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.environ["PYTHONHASHSEED"] = "0"
        os.environ[EXEC_AT] = repr(time.perf_counter())
        os.execv(sys.executable, [sys.executable, *sys.argv])
    # the profiler loses windows as a process ages unless CUPTI is torn
    # down after each one
    os.environ["TEARDOWN_CUPTI"] = "1"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main():
    _environment()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args()
    parts = _start_parts()

    def part(name, t0):
        parts[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    from p4bench import harness
    cell = harness.load_cell(a.workload)
    part("imports", t0)
    t0 = time.perf_counter()
    import torch
    part("torch_import", t0)
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        _fail("no CUDA card found: this benchmark runs only on the card", 3)
    if torch.cuda.device_count() < cell["chips"]:
        _fail(f"{a.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", 3)
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)           # the card's context
    torch.cuda.synchronize(device)
    part("cuda_init", t0)
    t0 = time.perf_counter()
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        _fail(f"the program (src/repro_torch) is not in this checkout: {e}",
              4)
    part("program_package", t0)
    try:
        out, info = harness.measure(cell, a.seed, a.seconds, bool(a.trace),
                                    device, T0, parts)
    except harness.TrafficExhausted as e:
        _fail(str(e), 5)
    if a.trace and "busy_s" not in out["device"]:
        _fail("the profiler kept no window of this run", 6)
    found = _forbidden_modules()
    if found:
        _fail(f"modules of JAX or the JAX package were loaded: {found}", 7)
    print(f"p4bench: {info}", flush=True)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    os._exit(0)


if __name__ == "__main__":
    main()
