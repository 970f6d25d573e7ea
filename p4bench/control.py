"""The readings that the limits of ``correct`` are set from (not part of a
benchmark run).

    python3 p4bench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--txns N]

For each of ``--seeds`` the program runs the cell's traffic (``N``
transactions, as many as a run checks) through ``Cluster.run_batch`` in
a closed loop on the card and is compared as a run is: the lower
readings.  For each of ``--control-seeds`` the control takes the
program's place: the plain reference with the deployment's guarantee of
admission order broken, each batch run grouped by home node (stable),
as a cluster without the switch's global order might.  Its answers and
final values are compared the same way (it keeps no WAL and counts no
commits): the upper readings.  Prints one JSON line a seed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from p4bench import harness  # noqa: E402
from p4bench.reference import compare  # noqa: E402


def node_grouped(stream, batch: int) -> list:
    """Admission order broken: each batch's txns grouped by home node."""
    order = []
    for lo in range(0, stream.n, batch):
        ids = list(range(lo, min(lo + batch, stream.n)))
        order += sorted(ids, key=lambda i: int(stream.home[i]))
    return order


def control_numbers(cell, seed: int, n: int) -> dict:
    stream = harness.generator(cell).generate(harness.rng_of(seed), n,
                                              harness.params(cell))
    keys, values = harness.initial(cell, seed)
    loaded = dict(zip(keys.tolist(), values.tolist()))
    reference = harness.reference(cell)
    ref = reference.execute(stream, loaded)
    ctl = reference.execute(stream, loaded, order=node_grouped(
        stream, cell["traffic"]["batch"]))
    lens = np.where(ctl.committed, np.diff(stream.start), compare.GAVE_UP)
    return dict(results_bad=compare.results_bad(
                    stream, ref, lens, ctl.res[np.repeat(
                        ctl.committed, np.diff(stream.start))]),
                values_bad=compare.values_bad(ref, ctl.values))


def program_numbers(cell, seed: int, n: int, device) -> dict:
    run = harness.Run(cell, seed, 0.0, device, warmup_batches=0)
    run.setup(n_txns=n)
    while run.next < len(run.batches):
        run._one()
    run.cluster.drain()
    run._pack(final=True)
    got = run.outputs()
    run.cluster = None
    return run.check(got)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--txns", type=int, default=0)
    a = ap.parse_args()
    import torch
    cell = harness.load_cell(a.workload)
    n = a.txns or harness.traffic_txns(cell, cell["run_seconds"])
    device = torch.device("cuda")
    for kind, seeds in (("program", a.seeds), ("control", a.control_seeds)):
        for s in filter(None, seeds.split(",")):
            t0 = time.perf_counter()
            nums = program_numbers(cell, int(s), n, device) \
                if kind == "program" else control_numbers(cell, int(s), n)
            print(json.dumps(dict(workload=a.workload, side=kind, seed=int(s),
                                  txns=n, seconds=time.perf_counter() - t0,
                                  **nums)), flush=True)


if __name__ == "__main__":
    main()
