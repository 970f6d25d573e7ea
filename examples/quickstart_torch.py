"""Quickstart on the PyTorch port: offload hot tuples to the switch engine
and run hot transactions abort-free, exactly like the paper's Figure 3
flow.  The switch's register file lives on ``--device`` (default cuda,
which must exist; ``--device cpu`` runs the plain PyTorch versions).

  PYTHONPATH=src python examples/quickstart_torch.py               # GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core.engine import resolve_device
from repro_torch.core.hotset import build_hot_index
from repro_torch.core.packets import ADD, READ, SwitchConfig
from repro_torch.db.dbms import Cluster
from repro_torch.db.txn import Txn
from repro_torch.workloads import ycsb

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="device of the switch registers (default cuda)")
device = resolve_device(ap.parse_args().device)

# 1. sample a representative workload and detect the hot set offline
params = ycsb.YCSBParams(n_nodes=4, keys_per_node=10_000, hot_per_node=16)
rng = np.random.default_rng(0)
sample = ycsb.generate(rng, 2000, params)
switch = SwitchConfig(n_stages=12, regs_per_stage=4096, max_instrs=12)
hot_index = build_hot_index(ycsb.traces(sample), top_k=64, switch=switch)
print(f"hot set: {len(hot_index.placement.slot)} tuples, "
      f"single-pass rate "
      f"{hot_index.placement.stats['single_pass_rate']:.2f}")

# 2. bring up the cluster (4 DB nodes + the switch as an extra node)
cluster = Cluster(4, switch, hot_index, use_switch=True, device=device)
cluster.snapshot_offload()

# 3. run transactions — the cluster classifies hot/cold/warm automatically
txns = ycsb.generate(np.random.default_rng(1), 500, params)
for t in txns:
    cluster.run(t)
print("execution stats:", dict(cluster.stats))

# 4. a hand-written hot transaction with a read-dependent write (B += A)
a, b = list(hot_index.placement.slot)[:2]
cluster.run(Txn("manual", [(ADD, a, 5)], home=0))
res = cluster.run(Txn("rdw", [(READ, a, 0)], home=0))
print(f"switch read returned {res[0]}")

# 5. crash the switch and rebuild its registers from the nodes' WALs
before = cluster.switch.read_all()
known, inflight = cluster.crash_switch_and_recover()
assert np.array_equal(before, cluster.switch.read_all())
print(f"switch recovered from WALs: {known} logged txns, "
      f"{inflight} in-flight")
