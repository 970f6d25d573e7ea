"""The port's cluster-example helpers (``repro_torch.bench.common``) against
the JAX side's ``benchmarks/common.py`` on the same seeds: the YCSB and
TPC-C profiles and placements, the closed-loop timing sim of each system,
the serving config, and the open-loop rows with their knee.  The slow
test runs ``examples/oltp_cluster.py`` and ``examples/oltp_cluster_torch.py``
and requires the same output, line for line."""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from benchmarks import common as J  # noqa: E402
from repro.obs import find_knee as j_find_knee  # noqa: E402
from repro.sim.model import SystemConfig as JSystemConfig  # noqa: E402
from repro_torch.bench import common as T  # noqa: E402
from repro_torch.obs import find_knee as t_find_knee  # noqa: E402
from repro_torch.sim.model import SystemConfig as TSystemConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N = 300
SIM_TIME = 2 * J.WARMUP          # below WARMUP the throughput reads 0
WORKERS = 2                      # per node (the example's 20 at --runslow)
RATES = (0.3e6, 0.8e6, 1.5e6)    # below, at and past the serving knee


@functools.lru_cache(maxsize=None)
def _profiles(workload):
    """((JAX profiles, JAX hot index), (port profiles, port hot index))."""
    if workload == "ycsb":
        return J.ycsb_profiles(variant="A", n=N), T.ycsb_profiles(
            variant="A", n=N)
    return (J.tpcc_profiles(warehouses=8, n=N),
            T.tpcc_profiles(warehouses=8, n=N))


def test_constants_match():
    for name in ("N_NODES", "SIM_TIME", "WARMUP", "NIC_10G",
                 "SERVE_SWITCH_RATE", "SERVE_ADMIT_CAP"):
        assert getattr(T, name) == getattr(J, name), name
    assert dataclasses.astuple(T.SWITCH) == dataclasses.astuple(J.SWITCH)


@pytest.mark.parametrize("workload", ["ycsb", "tpcc"])
def test_profiles_and_placement_match(workload):
    (jp, jhi), (tp, thi) = _profiles(workload)
    assert len(tp) == N
    assert [dataclasses.astuple(a) for a in jp] == \
        [dataclasses.astuple(b) for b in tp]
    assert jhi.placement.stats == thi.placement.stats
    assert jhi.placement.slot == thi.placement.slot


@pytest.mark.parametrize("kind", ["p4db", "noswitch", "lmswitch"])
def test_run_sim_matches(kind):
    (jp, _), (tp, _) = _profiles("ycsb")
    kw = dict(workers=WORKERS, sim_time=SIM_TIME)
    j = J.run_sim(jp, JSystemConfig(kind=kind), **kw)
    t = T.run_sim(tp, TSystemConfig(kind=kind), **kw)
    assert j == t
    assert t["throughput"] > 0


def test_run_sim_overrides_match():
    """The switch-admission overrides replace the system's knobs."""
    (jp, _), (tp, _) = _profiles("ycsb")
    kw = dict(workers=WORKERS, sim_time=SIM_TIME, batch_window=5e-6, max_batch=8,
              pipeline_depth=2, nic_line_rate=T.NIC_10G)
    j = J.run_sim(jp, JSystemConfig(kind="p4db"), **kw)
    t = T.run_sim(tp, TSystemConfig(kind="p4db"), **kw)
    assert j == t
    assert t["throughput"] > 0


@pytest.mark.parametrize("kind", ["p4db", "noswitch"])
def test_serve_system_matches(kind):
    j, t = J.serve_system(kind), T.serve_system(kind)
    assert [f.name for f in dataclasses.fields(j)] == \
        [f.name for f in dataclasses.fields(t)]
    for f in dataclasses.fields(j):
        assert getattr(j, f.name) == getattr(t, f.name), f.name


def test_open_loop_rows_and_knee_match():
    (jp, _), (tp, _) = _profiles("ycsb")
    rows = {"jax": [], "port": []}
    for rate in RATES:
        rows["jax"].append(J.serve_sim_row(J.run_open_loop_sim(
            jp, J.serve_system("p4db"), rate, sim_time=SIM_TIME,
            workers=WORKERS)))
        rows["port"].append(T.serve_sim_row(T.run_open_loop_sim(
            tp, T.serve_system("p4db"), rate, sim_time=SIM_TIME,
            workers=WORKERS)))
    assert rows["jax"] == rows["port"]
    assert all(r["achieved_rate"] > 0 for r in rows["port"])
    assert rows["port"][-1]["dropped"] > 0     # the last rate sheds
    knee = t_find_knee(rows["port"])
    assert knee == j_find_knee(rows["jax"])
    assert 0 < knee < RATES[-1]


@pytest.mark.slow
def test_examples_print_the_same_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, str(ROOT / "examples" / f)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for f in ("oltp_cluster.py", "oltp_cluster_torch.py")]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0]
    assert "speedup P4DB / No-Switch" in outs[1][0]
    assert "saturation knee" in outs[1][0]
