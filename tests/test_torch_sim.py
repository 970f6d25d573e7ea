"""The port's timing simulator (``repro_torch.sim``) against the JAX
package's: the DES lock semantics, and ``ClusterSim`` result dicts on
the same workloads, each package profiling the txns over its own hot
index, identical key for key."""
import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.heat import HeatTracker as JHeatTracker  # noqa: E402
from repro.core.hotset import build_hot_index as j_build_hot_index  # noqa: E402,E501
from repro.core.packets import SwitchConfig as JSwitchConfig  # noqa: E402
from repro.sim import model as j_model  # noqa: E402
from repro.workloads import drift as j_drift  # noqa: E402
from repro.workloads import tpcc as j_tpcc  # noqa: E402
from repro.workloads import ycsb as j_ycsb  # noqa: E402
from repro_torch.core.heat import HeatTracker as THeatTracker  # noqa: E402
from repro_torch.core.hotset import build_hot_index  # noqa: E402
from repro_torch.core.packets import SwitchConfig  # noqa: E402
from repro_torch.sim import model as t_model  # noqa: E402
from repro_torch.sim.des import Sim, SimLock  # noqa: E402
from repro_torch.workloads import drift as t_drift  # noqa: E402
from repro_torch.workloads import tpcc as t_tpcc  # noqa: E402
from repro_torch.workloads import ycsb as t_ycsb  # noqa: E402

N_NODES = 4
SWITCH = dict(n_stages=16, regs_per_stage=512, max_instrs=16)
SIM_TIME = 0.003


def test_des_lock_no_wait():
    lk = SimLock("NO_WAIT")
    assert lk.try_acquire(1, "S")
    assert lk.try_acquire(2, "S")
    assert lk.try_acquire(3, "X") is False
    lk.release(1, Sim())
    lk.release(2, Sim())
    assert lk.try_acquire(3, "X")


def test_des_lock_wait_die():
    lk = SimLock("WAIT_DIE")
    assert lk.try_acquire(5, "X")
    assert lk.try_acquire(3, "X") is None     # older waits
    assert lk.try_acquire(9, "X") is False    # younger dies


@functools.lru_cache(maxsize=None)
def _profiles(workload):
    """(JAX profiles, port profiles): the same sample and txns on each
    package, profiled over that package's own hot index."""
    out = []
    for build, sw, model, wl in (
            (j_build_hot_index, JSwitchConfig(**SWITCH), j_model,
             {"ycsb": j_ycsb, "tpcc": j_tpcc}[workload]),
            (build_hot_index, SwitchConfig(**SWITCH), t_model,
             {"ycsb": t_ycsb, "tpcc": t_tpcc}[workload])):
        if workload == "ycsb":
            p = wl.YCSBParams(n_nodes=N_NODES, keys_per_node=5000,
                              hot_per_node=16, variant="A")
            top_k = 16 * N_NODES
        else:
            p = wl.TPCCParams(n_nodes=N_NODES, n_warehouses=4)
            top_k = 4 * (1 + 2 * wl.N_DISTRICTS + wl.HOT_ITEMS)
        sample = wl.generate(np.random.default_rng(0), 1200, p)
        hi = build(wl.traces(sample), top_k=top_k, switch=sw)
        txns = wl.generate(np.random.default_rng(1), 600, p)
        out.append([model.profile_txn(t, hi, t.home) for t in txns])
    jp, tp = out
    assert [dataclasses.astuple(a) for a in jp] == \
        [dataclasses.astuple(b) for b in tp]
    return jp, tp


SYSTEMS = {
    "p4db": dict(kind="p4db"),
    "noswitch": dict(kind="noswitch"),
    "batched": dict(kind="p4db", batch_window=5e-6, max_batch=8,
                    pipeline_depth=2, nic_line_rate=1.25e9),
    "wait_die_ea": dict(kind="p4db", protocol="WAIT_DIE", early_abort=True,
                        drop_on_abort=False),
    # the durability mirror (tests/test_durability.py:468-491): a switch
    # crash with warm-standby takeover, without and with the checkpoint
    # daemon, under the Timing knobs that price the takeover
    "failover": dict(kind="p4db", max_batch=8, crash_at=1.5e-3),
    "failover_ckpt": dict(kind="p4db", max_batch=8, crash_at=1.5e-3,
                          ckpt_interval=0.4e-3,
                          timing=dict(t_failover=200e-6,
                                      t_replay_send=1e-6)),
}


@pytest.mark.parametrize("system", list(SYSTEMS))
@pytest.mark.parametrize("workload", ["ycsb", "tpcc"])
def test_cluster_sim_matches_jax(workload, system):
    jp, tp = _profiles(workload)
    kw = dict(SYSTEMS[system])
    timing = kw.pop("timing", {})
    out = [model.ClusterSim(profs, N_NODES, 8, model.SystemConfig(**kw),
                            timing=model.Timing(**timing), seed=3,
                            sim_time=SIM_TIME, warmup=SIM_TIME / 5).run()
           for model, profs in ((j_model, jp), (t_model, tp))]
    assert out[0] == out[1]
    assert out[1]["throughput"] > 0
    assert ("early_abort" in out[1]) == (system == "wait_die_ea")
    assert ("failover" in out[1]) == system.startswith("failover")
    if system == "failover_ckpt":
        assert out[1]["ckpts_taken"] > 0


def test_dynamic_cluster_sim_matches_jax():
    """Dynamic mode: txns drawn from a drift generator at admission, a
    heat tracker and an epoch controller re-placing the hot set."""
    out = []
    for drift, build, sw, model, tracker in (
            (j_drift, j_build_hot_index, JSwitchConfig(**SWITCH), j_model,
             JHeatTracker),
            (t_drift, build_hot_index, SwitchConfig(**SWITCH), t_model,
             THeatTracker)):
        gen = drift.YCSBHotspotShift(n_nodes=N_NODES, keys_per_node=5000,
                                     hot_per_node=16, period=1e-3)
        hi = build(drift.traces(
            gen.sample_phase(np.random.default_rng(0), 0, 800)), 64, sw)
        cs = model.ClusterSim(
            [], N_NODES, 8, model.SystemConfig(kind="p4db",
                                               reconfig_interval=0.4e-3),
            timing=model.Timing(), seed=0, sim_time=SIM_TIME,
            warmup=SIM_TIME / 5, dynamic=gen, hot_index=hi, switch_cfg=sw,
            tracker=tracker(decay=0.1), reconfig_top_k=64)
        out.append(cs.run())
    assert out[0] == out[1]
    assert out[1]["reconfigs"] >= 1


@pytest.mark.parametrize("knobs", [
    dict(gate_t_reconfig=1.0),
    dict(gate_t_reconfig=1e-9),
    dict(partial_availability=True),
    dict(gate_t_reconfig=1e-9, partial_availability=True, crash_at=2e-3,
         ckpt_interval=0.4e-3)])
def test_dynamic_cluster_sim_durability_knobs_match_jax(knobs):
    """The migration gate and partial availability of the durability
    mirror (tests/test_durability.py:494-531) on a dynamic RotatingZipf
    run whose old hot keys keep tail traffic, under a long reconfiguration
    pause (2 ms), so that both act."""
    out = []
    for drift, build, sw, model, tracker in (
            (j_drift, j_build_hot_index, JSwitchConfig(**SWITCH), j_model,
             JHeatTracker),
            (t_drift, build_hot_index, SwitchConfig(**SWITCH), t_model,
             THeatTracker)):
        gen = drift.RotatingZipf(n_nodes=N_NODES, period=2e-3)
        hi = build(drift.traces(
            gen.sample_phase(np.random.default_rng(0), 0, 2000)), 200, sw)
        cs = model.ClusterSim(
            [], N_NODES, 20, model.SystemConfig(
                kind="p4db", reconfig_interval=0.4e-3, **knobs),
            timing=model.Timing(t_reconfig=2e-3), seed=0, sim_time=5e-3,
            warmup=0.25e-3, dynamic=gen, hot_index=hi, switch_cfg=sw,
            tracker=tracker(decay=0.1), reconfig_top_k=200)
        out.append(cs.run())
    assert out[0] == out[1]
    if knobs.get("gate_t_reconfig") == 1.0:
        assert out[1]["reconfigs"] == 0 and out[1]["reconfigs_gated"] > 0
    else:
        assert out[1]["reconfigs"] >= 1
    if knobs.get("partial_availability"):
        assert out[1]["partial_served"] > 0
