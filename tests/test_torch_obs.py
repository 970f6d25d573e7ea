"""The port's telemetry plane against the JAX package's: histogram buckets
and quantiles, ``Tracer`` sampling, the ``STAT_NAMES`` table, the
Prometheus text of the same cluster run through both packages (counter
and gauge families equal, histogram observation counts equal; the
wall-clock values of histograms are not compared), the strict parser's
rejections, and the ``--check`` CLI's exit codes."""
import copy
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import obs as j_obs  # noqa: E402
from repro.core.hotset import build_hot_index as j_build_hot_index  # noqa: E402,E501
from repro.core.packets import SwitchConfig as JSwitchConfig  # noqa: E402
from repro.db.dbms import Cluster as JCluster  # noqa: E402
from repro.obs import export as j_export  # noqa: E402
from repro.obs import registry as j_registry  # noqa: E402
from repro.workloads import ycsb  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402
from repro_torch.core.hotset import build_hot_index  # noqa: E402
from repro_torch.core.packets import SwitchConfig as TSwitchConfig  # noqa: E402,E501
from repro_torch.db.dbms import Cluster as TCluster  # noqa: E402
from repro_torch.obs import export as t_export  # noqa: E402
from repro_torch.obs import registry as t_registry  # noqa: E402
from test_torch_dbms import _port_txns  # noqa: E402

SW = dict(n_stages=16, regs_per_stage=512, max_instrs=16)
PAIRS = ((j_obs, j_registry, j_export), (t_obs, t_registry, t_export))


def test_histogram_buckets_and_quantiles_match_jax():
    rng = np.random.default_rng(7)
    vals = np.clip(rng.lognormal(np.log(1e-4), 1.5, 20_000), 2e-7, 5.0)
    out = []
    for _, reg, _ in PAIRS:
        h = reg.Histogram("lat")
        h.observe_many(vals)
        h.observe(0.0)
        h.observe(1e9)
        loop = reg.Histogram("loop")
        for v in vals[:500]:
            loop.observe(v)
        out.append((h.bounds.tolist(), h.counts.tolist(), h.count, h.sum,
                    [h.percentile(q) for q in (0.5, 0.9, 0.99, 0.999, 1.0)],
                    loop.counts.tolist(), reg.Histogram("e").percentile(0.5),
                    reg.log_bucket_bounds().tolist(), reg.PER_DECADE))
    assert out[0] == out[1]


def test_tracer_sampling_matches_jax():
    out = []
    for obs, _, _ in PAIRS:
        for cap, every in ((8, 3), (4, 1), (256, 7)):
            tr = obs.Tracer(clock=lambda: 0.0, capacity=cap,
                            sample_every=every)
            got = []
            for i in range(100):
                t = tr.start(f"txn:{i % 3}")
                got.append(t is not None)
                if t is not None:
                    with t.span("outer"):
                        with t.span("inner"):
                            pass
            out.append((got, tr.started,
                        [(t.label, t.names(), [s.depth for s in t.spans])
                         for t in tr.traces]))
    assert out[:3] == out[3:]


def test_stat_names_match_jax():
    assert j_obs.STAT_NAMES == t_obs.STAT_NAMES
    assert j_obs.FUNCTIONAL_SPANS == t_obs.FUNCTIONAL_SPANS
    assert j_obs.SIM_SPANS == t_obs.SIM_SPANS
    for key in list(t_obs.STAT_NAMES)[:8] + ["weird key!"]:
        assert j_obs.stat_metric(key) == t_obs.stat_metric(key)
    res = {"throughput": 2.5e6, "commits": {"hot": 10, "cold": 4},
           "aborts": {"cold": 2}, "lat_all": 1e-5, "switch_rounds": 9}
    assert j_obs.unify_sim_result(res) == t_obs.unify_sim_result(res)


def _families(text, parse):
    """Families of one exposition: counters and gauges whole, histograms
    by their ``_count`` samples (wall-clock values differ run to run)."""
    out = {}
    for name, fam in parse(text).items():
        samples = fam["samples"]
        if fam["type"] == "histogram":
            samples = [s for s in samples if s[0].endswith("_count")]
        out[name] = (fam["type"], sorted(
            (n, sorted(lbl.items()), v) for n, lbl, v in samples))
    return out


def test_cluster_export_matches_jax():
    """The same YCSB stream (async hot path, a crash and recovery, reads)
    through a JAX cluster and a port cluster: ``export_metrics`` text
    parses under both strict parsers, with equal counter and gauge
    families and equal histogram counts."""
    p = ycsb.YCSBParams(n_nodes=4, keys_per_node=1000, hot_per_node=16)
    traces = ycsb.traces(ycsb.generate(np.random.default_rng(0), 1500, p))
    txns = ycsb.generate(np.random.default_rng(3), 240, p)
    texts = []
    for Cluster, build, cfg, kw in (
            (JCluster, j_build_hot_index, JSwitchConfig(**SW), {}),
            (TCluster, build_hot_index, TSwitchConfig(**SW),
             dict(device="cpu"))):
        c = Cluster(4, cfg, build(traces, 64, cfg), async_hot=True,
                    checkpoint_interval=64, **kw)
        c.snapshot_offload()
        side = copy.deepcopy(txns) if Cluster is JCluster \
            else _port_txns(txns)
        for lo in range(0, 240, 60):
            c.run_batch(side[lo:lo + 60])
        c.drain()
        c.read_batch([k for t in side[:20] for k in t.keys()])
        c.crash_switch_and_recover()
        texts.append(c.export_metrics())
    fams = [_families(t, parse) for t in texts
            for parse in (j_export.parse_prometheus,
                          t_export.parse_prometheus)]
    assert fams[0] == fams[1] == fams[2] == fams[3]
    assert fams[3]["p4db_txns_committed_total"][1][0][2] > 0


def _toy(obs):
    reg = obs.MetricsRegistry(namespace="p4db")
    reg.counter("txns_committed_total", help="commits").inc(7)
    reg.gauge("inflight_batches").set(3)
    h = reg.histogram("txn_latency_seconds", help="lat", klass="hot")
    h.observe_many([1e-5, 2e-5, 3e-4, 0.5])
    reg.histogram("txn_latency_seconds", klass="cold").observe(2e-3)
    return reg


MANGLES = {
    "comment": lambda t: t.replace("# TYPE", "# TIPE", 1),
    "untyped": lambda t: "p4db_orphan_total 3\n" + t,
    "value": lambda t: t.replace(" 7", " seven"),
    "no_inf": lambda t: t.replace('le="+Inf"', 'le="0.001"'),
    "not_cumulative": lambda t: t.replace(" 4\n", " 1\n", 1),
    "labels": lambda t: t.replace('{klass="hot"', '{klass=hot', 1),
}


@pytest.mark.parametrize("mangle", list(MANGLES))
def test_prometheus_parser_rejects_like_jax(mangle):
    """Both packages render the same text, and both strict parsers reject
    the same corruption with the same message."""
    texts = [obs.to_prometheus(_toy(obs)) for obs, _, _ in PAIRS]
    assert texts[0] == texts[1]
    assert j_obs.to_json(_toy(j_obs)) == t_obs.to_json(_toy(t_obs))
    errs = []
    for _, _, export in PAIRS:
        with pytest.raises(ValueError) as exc:
            export.parse_prometheus(MANGLES[mangle](texts[1]))
        errs.append(str(exc.value))
    assert errs[0] == errs[1]


def test_export_check_cli_matches_jax(tmp_path, capsys):
    good = tmp_path / "scrape.prom"
    good.write_text(t_obs.to_prometheus(_toy(t_obs)))
    bad = tmp_path / "bad.prom"
    bad.write_text("not { a metric\n")
    for argv, code in ((["--check"], 0), (["--check", str(good)], 0),
                       (["--check", str(bad)], 1), ([], 2),
                       (["--demo"], 0), (["--demo", "--json"], 0)):
        got = []
        for _, _, export in PAIRS:
            got.append(export.main(argv))
            got.append(capsys.readouterr().out)
        assert got[0] == got[2] == code and got[1] == got[3]


def test_export_check_module_entry(tmp_path):
    """``python -m repro_torch.obs.export --check [FILE]`` as an operator
    runs it against a port cluster's scrape: exit 0, then 1 on a
    corrupted one."""
    c = TCluster(2, TSwitchConfig(**SW), None, use_switch=False,
                 device="cpu")
    from repro_torch.db.txn import Txn, key_of
    c.run(Txn("t", [(1, key_of(0, 1), 3)], 0))
    f = tmp_path / "scrape.prom"
    f.write_text(c.export_metrics())
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    cmd = [sys.executable, "-m", "repro_torch.obs.export", "--check", str(f)]
    ok = subprocess.run(cmd, env=env, capture_output=True, text=True,
                        timeout=120)
    assert ok.returncode == 0 and ok.stdout.startswith("OK"), ok.stderr
    f.write_text(f.read_text().replace("# TYPE", "# TIPE", 1))
    bad = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=120)
    assert bad.returncode == 1 and "FAIL" in bad.stderr
