"""End-to-end OLTP serving example on the PyTorch port (the paper's kind of
system): a simulated 8-node cluster serving batched transaction requests,
P4DB vs baselines, reproducing the headline speedups.  It runs the port's
timing simulator on the host and prints the same lines as
``examples/oltp_cluster.py``.

  PYTHONPATH=src python examples/oltp_cluster_torch.py
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.bench import common as C
from repro_torch.sim.model import SystemConfig

print("YCSB-A, 8 nodes x 20 workers, 20% distributed txns")
profs, hi = C.ycsb_profiles(variant="A")
print(f"  hot-set layout single-pass rate: "
      f"{hi.placement.stats['single_pass_rate']:.2f}")
results = {}
for kind in ("p4db", "noswitch", "lmswitch"):
    out = C.run_sim(profs, SystemConfig(kind=kind))
    results[kind] = out
    print(f"  {kind:9s}: {out['throughput'] / 1e6:6.2f} M txn/s   "
          f"mean latency {out.get('lat_all', 0) * 1e6:6.1f} us   "
          f"aborts {sum(out['aborts'].values())}")
print(f"  speedup P4DB / No-Switch: "
      f"{results['p4db']['throughput'] / results['noswitch']['throughput']:.2f}x")

print("\nTPC-C (warm transactions), 8 warehouses")
tpcc_profs, _ = C.tpcc_profiles(warehouses=8)
for kind in ("p4db", "noswitch"):
    out = C.run_sim(tpcc_profs, SystemConfig(kind=kind))
    print(f"  {kind:9s}: {out['throughput'] / 1e6:6.2f} M txn/s")

# ------------------------------------------------------------------------
# Open-loop serving: latency is an SLO number, so it comes from the
# telemetry histograms (deterministic log-bucket p50/p99, repro_torch.obs),
# not a mean — and offered load is set by Poisson client sources, so
# pushing past the saturation knee visibly blows up the tail instead of
# silently slowing the load generator down (the closed-loop blind spot).
# ------------------------------------------------------------------------
from repro_torch.obs import find_knee

print("\nOpen-loop serving, YCSB-A on the bottlenecked serving config "
      "(10G NIC + switch ingress)")
serve_cfg = C.serve_system("p4db")
capacity = C.run_sim(profs, serve_cfg)["throughput"]
print(f"  closed-loop capacity: {capacity / 1e6:.2f} M txn/s")
rows = []
for frac in (0.5, 0.9, 1.3):
    r = C.serve_sim_row(C.run_open_loop_sim(profs, serve_cfg,
                                            frac * capacity))
    rows.append(r)
    print(f"  offered {r['offered_rate'] / 1e6:5.2f} M/s -> achieved "
          f"{r['achieved_rate'] / 1e6:5.2f} M/s   "
          f"p50 {r['p50'] * 1e6:6.1f} us   p99 {r['p99'] * 1e6:7.1f} us   "
          f"p999 {r['p999'] * 1e6:7.1f} us   shed {r['dropped']}")
knee = find_knee(rows)
print(f"  saturation knee (highest rate with >= 90% goodput): "
      f"{knee / 1e6:.2f} M/s")
for r in rows:
    if r["offered_rate"] > knee:
        print(f"  WARNING: offered {r['offered_rate'] / 1e6:.2f} M/s is "
              f"past the measured knee — the p99/p999 above is queueing + "
              f"admission shedding, not service time; size deployments "
              f"below {knee / 1e6:.2f} M/s")
