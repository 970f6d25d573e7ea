"""Shared setup of the port's cluster examples: a copy of the part of
``benchmarks/common.py`` that ``examples/oltp_cluster_torch.py`` needs
(the switch and cluster constants, the YCSB and TPC-C profiles, the
closed-loop timing sim and the open-loop serving config).  The code is
unchanged; only the imports name ``repro_torch``.  The bench scripts'
helpers are not copied yet."""
from __future__ import annotations

from dataclasses import replace

import numpy as np

from repro_torch.core.hotset import build_hot_index
from repro_torch.core.layout import random_layout
from repro_torch.core.packets import SwitchConfig
from repro_torch.sim.model import ClusterSim, SystemConfig, Timing, profile_txn
from repro_torch.workloads import tpcc, ycsb

# 12 MAU stages x 2 register arrays == 24 virtual stages (DESIGN.md)
SWITCH = SwitchConfig(n_stages=24, regs_per_stage=65536, max_instrs=16)
N_NODES = 8
SIM_TIME = 0.025
WARMUP = 0.005


def ycsb_profiles(variant="A", dist=0.2, hot_per_node=50, n=3000,
                  layout="optimal", top_k=None, seed=0, p_hot=0.75):
    p = ycsb.YCSBParams(n_nodes=N_NODES, hot_per_node=hot_per_node,
                        variant=variant, dist_frac=dist, p_hot_txn=p_hot)
    rng = np.random.default_rng(seed)
    sample = ycsb.generate(rng, 4000, p)
    lf = random_layout if layout == "random" else None
    kw = dict(layout_fn=lf) if lf else {}
    hi = build_hot_index(ycsb.traces(sample),
                         top_k=top_k or hot_per_node * N_NODES,
                         switch=SWITCH, **kw)
    txns = ycsb.generate(np.random.default_rng(seed + 1), n, p)
    return [profile_txn(t, hi, t.home) for t in txns], hi


def tpcc_profiles(warehouses=8, dist=0.2, n=3000, layout="optimal", seed=0):
    p = tpcc.TPCCParams(n_nodes=N_NODES, n_warehouses=warehouses,
                        dist_frac=dist)
    rng = np.random.default_rng(seed)
    sample = tpcc.generate(rng, 5000, p)
    lf = random_layout if layout == "random" else None
    kw = dict(layout_fn=lf) if lf else {}
    nhot = warehouses * (1 + 2 * tpcc.N_DISTRICTS + tpcc.HOT_ITEMS)
    hi = build_hot_index(tpcc.traces(sample), top_k=nhot, switch=SWITCH, **kw)
    txns = tpcc.generate(np.random.default_rng(seed + 1), n, p)
    return [profile_txn(t, hi, t.home) for t in txns], hi


def run_sim(profiles, system: SystemConfig, workers=20, sim_time=SIM_TIME,
            seed=0, timing=None, batch_window=None, max_batch=None,
            pipeline_depth=None, nic_line_rate=None):
    """Run the timing sim; ``batch_window``/``max_batch``/
    ``pipeline_depth``/``nic_line_rate`` override the switch-admission
    knobs on ``system`` when given (None = keep)."""
    overrides = {k: v for k, v in dict(
        batch_window=batch_window, max_batch=max_batch,
        pipeline_depth=pipeline_depth, nic_line_rate=nic_line_rate).items()
        if v is not None}
    if overrides:
        system = replace(system, **overrides)
    cs = ClusterSim(profiles, N_NODES, workers, system,
                    timing=timing or Timing(), seed=seed,
                    sim_time=sim_time, warmup=WARMUP)
    return cs.run()


NIC_10G = 1.25e9                                 # paper setup: 10G NICs


# ------------------------------------------------- open-loop serving ----
# The figure-sweep default SystemConfig folds NIC wire time and
# switch-ingress admission away (nic_line_rate=0, switch_service_rate=0 ->
# no serving bottleneck at any offered rate); the serving config makes both
# explicit so the open-loop sweep has a saturation knee INSIDE the swept
# range.

SERVE_SWITCH_RATE = 2e6          # shared switch-ingress admission, pkts/s
SERVE_ADMIT_CAP = 64             # queued arrivals/node before shedding


def serve_system(kind="p4db"):
    """Bottlenecked serving config: explicit 10G NICs + finite switch
    ingress, batched hot admission (the sim's batched switch rounds).  Unlike the
    figure sweeps (which count committed txns and drop aborts, as the
    paper does), serving clients RETRY aborted txns — goodput stays
    ~= offered below saturation, and past it the retry load itself
    saturates the admit pool, so the knee is well-defined for abort-
    prone systems too (NoSwitch's contention aborts otherwise shave
    goodput at every load level and no 90%-of-offered point exists)."""
    return SystemConfig(kind=kind, max_batch=8, batch_window=5e-6,
                        nic_line_rate=NIC_10G,
                        switch_service_rate=SERVE_SWITCH_RATE,
                        drop_on_abort=False)


def run_open_loop_sim(profiles, system, rate, sim_time=SIM_TIME, seed=0,
                      workers=20, max_arrivals=None,
                      admit_queue_cap=SERVE_ADMIT_CAP):
    """One open-loop DES point: Poisson client sources at ``rate``/s
    (cluster-wide) instead of closed-loop workers; per-class admission
    rides the worker-slot pool, arrivals beyond ``admit_queue_cap``
    waiters are shed at the door."""
    cs = ClusterSim(profiles, N_NODES, workers, system, timing=Timing(),
                    seed=seed, sim_time=sim_time, warmup=WARMUP,
                    open_loop_rate=rate, max_arrivals=max_arrivals,
                    admit_queue_cap=admit_queue_cap)
    return cs.run()


def serve_sim_row(out):
    """Flatten one open-loop sim result into a ServeResult-shaped row
    (same keys as obs.load.serve_open_loop, so find_knee works on both)."""
    ol = out["open_loop"]
    lat = out["latency"].get("all", {})
    return dict(offered_rate=ol["offered_rate"],
                achieved_rate=ol["achieved_rate"],
                arrivals=ol["arrivals"], served=ol["served"],
                dropped=ol["dropped"],
                p50=lat.get("p50", 0.0), p99=lat.get("p99", 0.0),
                p999=lat.get("p999", 0.0), mean=lat.get("mean", 0.0),
                utilization=out["utilization"])
