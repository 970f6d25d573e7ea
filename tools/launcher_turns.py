"""The walk launcher's host time on two checkouts, in turns, on one card.

Runs phase 21 (c) of each checkout's ``chip_smoke.py`` (``walk_profile``:
one auto dispatch's host time, split into the launcher, its fast-path
tests, the precise checks they skip and its bare C call) in a process of
its own, in the order A, B, B, A, ``--rounds`` times.  Prints every
reading, each tree's median launcher and bare C call host us, and the
median of the paired differences B - A (each B run against the A run next
to it), with the card's name and power limit.  Each tree is the root of a
checkout (another commit unpacked with ``git archive``, for example); it
builds its own kernels on first use.

Usage, from the repository root:
    python3 tools/launcher_turns.py [--rounds N] TREE_A TREE_B
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# phase 21 (c) in a process of its own, run from a tree's root
CHILD = r"""
import json, sys
sys.path.insert(0, "."); sys.path.insert(0, "src")
import chip_smoke as cs
from repro_torch.kernels import build
from repro_torch.core.packets import SwitchConfig
from repro_torch.kernels.switch_txn import switch_txn as tk
build.library("switch_engine"); build.library("switch_txn")
out = cs.walk_profile(tk, SwitchConfig(n_stages=cs.S, regs_per_stage=cs.R,
                                       max_instrs=cs.K))
print("RESULT " + json.dumps(out["host_us"]), flush=True)
cs._exit(0)
"""
PIECES = ("launcher", "bare C call")


def phase21c(tree):
    """walk_profile's host split, us, from a process run in ``tree``."""
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                          capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        print(proc.stdout[-3000:], proc.stderr[-3000:])
        cs.fail(f"phase 21 (c) in {tree} failed ({proc.returncode})")
    return json.loads(lines[-1][len("RESULT "):])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    smi = cs.nvidia_smi()
    trees = {"A": args.tree_a, "B": args.tree_b}
    runs = {"A": [], "B": []}
    for r in range(args.rounds):
        for name in ("A", "B", "B", "A"):
            split = phase21c(trees[name])
            runs[name].append(split)
            print(f"round {r} {name} ({trees[name]}): " + "; ".join(
                f"{k} {v:.1f}" for k, v in split.items()), flush=True)
    summary = {}
    for piece in PIECES:
        a = [s[piece] for s in runs["A"]]
        b = [s[piece] for s in runs["B"]]
        diff = [y - x for x, y in zip(a, b)]
        summary[piece] = dict(A=statistics.median(a), B=statistics.median(b),
                              B_minus_A=statistics.median(diff))
        print(f"{piece} [{smi}], us, medians of {len(a)} processes a tree: "
              f"A {summary[piece]['A']:.2f}, B {summary[piece]['B']:.2f}; "
              f"B - A median {summary[piece]['B_minus_A']:+.2f} over "
              f"{len(diff)} pairs (spread {min(diff):+.1f} to "
              f"{max(diff):+.1f})", flush=True)
    print(json.dumps(dict(trees=trees, runs=runs, summary=summary)),
          flush=True)


if __name__ == "__main__":
    main()
    cs._exit(0)
