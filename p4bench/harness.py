"""One run of a cell: set-up, the measured window, the check, the readings.

Everything a cell needs is found by name: the cell and its metrics in
``BENCHMARK.json``, its configuration in the file named there, its plain
reference in the file the configuration names, its traffic in
``traffic/<mix>.json`` with the generator that file names, a per-layer
metric's reader in ``metrics/<metric>.py`` and a kernel route's byte
count in ``roofline/<route>.py``.

The program under test is ``repro_torch`` (``src/`` of the checkout); it
is imported only inside the functions that drive it.
"""
from __future__ import annotations

import collections
import gc
import importlib
import json
import math
import resource
import sys
import time
from pathlib import Path

import numpy as np

from p4bench import host
from p4bench.reference import compare
from p4bench.traffic.stream import node_of

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
TID0 = 1 << 32            # txn i of a stream runs as tid TID0 + i
PROFILE_S = 1.0           # the traced run's profiler window
PROFILE_TRIES = 8


class TrafficExhausted(RuntimeError):
    pass


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json") -> dict:
    spec = json.loads(spec_path.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {spec_path.name}: "
                       f"{sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return dict(name=name, chips=w["chips"], config=config,
                traffic=traffic, end_to_end=mine(spec["end_to_end"]),
                per_layer=mine(spec["per_layer"]),
                run_seconds=spec["run_seconds"])


def reference(cell):
    """The module of the plain reference the configuration names (a file
    under the benchmark, ``p4bench/reference/serial.py`` say)."""
    path = Path(cell["config"]["reference"]).with_suffix("")
    return importlib.import_module(".".join(path.parts))


def generator(cell):
    return importlib.import_module(
        f"p4bench.traffic.{cell['traffic']['generator']}")


def params(cell) -> dict:
    return {**cell["config"]["deployment"], **cell["traffic"]["params"]}


def rng_of(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of ``seed``'s traffic (stream 0) or of its loaded
    data (stream 1)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def traffic_txns(cell, seconds: float, warmup_batches=None) -> int:
    """Transactions to generate: the warm-up's batches and as many as the
    window can take at the mix's highest rate, in whole batches."""
    t = cell["traffic"]
    b = t["batch"]
    if warmup_batches is None:
        warmup_batches = t["warmup_batches"]
    return b * (warmup_batches + math.ceil(t["max_txn_per_s"] * seconds / b))


def wrap(stream, Txn) -> list:
    """The stream as the program's transactions (txn i as tid TID0 + i)."""
    flat = list(zip(stream.op.tolist(), stream.key.tolist(),
                    stream.val.tolist()))
    start, home = stream.start.tolist(), stream.home.tolist()
    kind = [stream.kinds[k] for k in stream.kind.tolist()]
    return [Txn(kind[i], flat[start[i]:start[i + 1]], home[i], tid=TID0 + i)
            for i in range(stream.n)]


def hot_index(cell, build_hot_index, SwitchConfig):
    """The program's hot index, built by its own detection from a fixed
    sample of the deployment's traffic (a property of the deployment,
    the same for every seed)."""
    hs = cell["config"]["hot_index"]
    sample = generator(cell).generate(rng_of(hs["seed"]), hs["txns"],
                                      cell["config"]["deployment"])
    keys, ops = sample.key.tolist(), sample.op.tolist()
    start = sample.start.tolist()
    traces = [[(keys[j], ops[j]) for j in range(start[i], start[i + 1])]
              for i in range(sample.n)]
    return build_hot_index(traces, top_k=hs["top_k"],
                           switch=SwitchConfig(**cell["config"]["switch"]))


def initial(cell, seed: int):
    """(keys, values) of the tuples the deployment holds before its first
    transaction, from ``seed``."""
    return generator(cell).initial(rng_of(seed, 1),
                                   cell["config"]["deployment"])


def populate(cluster, keys, values):
    """Load the tuples in bulk: each into its node's store, and a key of
    the switch into its register too, as ``Cluster.load`` leaves them
    (without its log records: the loaded state is the base a WAL starts
    from)."""
    node = node_of(keys)
    for n, dbn in enumerate(cluster.nodes):
        m = node == n
        dbn.store.update(zip(keys[m].tolist(), values[m].tolist()))
    hot = np.array(sorted(cluster.hot_index.placement.slot), np.int64)
    if hot.size:
        regs = cluster.switch.read_all()
        flat = register_of(cluster, hot)
        regs.reshape(-1)[flat] = [cluster.nodes[node_of(k)].store.get(k, 0)
                                  for k in hot.tolist()]
        cluster.switch.load_registers(regs)


def register_of(cluster, keys):
    """Flat indices into ``switch.read_all()`` of switch keys."""
    sw, st, rg = cluster.hot_index.slots_np(keys)
    cfg = cluster.switch_cfg
    return ((sw.astype(np.int64) * cfg.n_stages + st) * cfg.regs_per_stage
            + rg)


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def rss_bytes() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class Run:
    """One run of ``cell`` on ``device`` with the traffic of ``seed``."""

    def __init__(self, cell, seed: int, seconds: float, device,
                 trace: bool = False, warmup_batches=None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.device, self.trace = device, trace
        t = cell["traffic"]
        self.batch = t["batch"]
        self.warmup = t["warmup_batches"] if warmup_batches is None \
            else warmup_batches
        self.setup_parts = {}
        self.cpus, self.look_at = [], 0.0   # the CPU run on, once a second
        self.first_txn = 0                  # the window's first txn

    def _part(self, name, t0):
        self.setup_parts[name] = time.perf_counter() - t0

    # ------------------------------------------------------------ set-up
    def setup(self, n_txns=None):
        t0 = time.perf_counter()
        from repro_torch.core.hotset import build_hot_index
        from repro_torch.core.packets import SwitchConfig
        from repro_torch.db import dbms
        from repro_torch.db.txn import Txn
        from repro_torch.kernels import build
        from repro_torch.obs.trace import Tracer
        self._part("program_modules", t0)

        # the traffic pool and the loaded tables are built with the
        # collector off and then frozen, so the window's collections do
        # not walk what a deployment holds from its start
        gc.disable()
        t0 = time.perf_counter()
        n = n_txns or traffic_txns(self.cell, self.seconds, self.warmup)
        self.stream = generator(self.cell).generate(rng_of(self.seed), n,
                                                    params(self.cell))
        self._part("traffic", t0)
        t0 = time.perf_counter()
        txns = wrap(self.stream, Txn)
        self.batches = [txns[i:i + self.batch]
                        for i in range(0, len(txns), self.batch)]
        self._part("txns", t0)
        t0 = time.perf_counter()
        self.initial = initial(self.cell, self.seed)
        self._part("data", t0)
        t0 = time.perf_counter()
        hi = hot_index(self.cell, build_hot_index, SwitchConfig)
        self._part("hot_index", t0)
        t0 = time.perf_counter()
        cfg = self.cell["config"]
        # the traced run keeps every batch's trace (the default ring
        # keeps the last 256)
        tracer = Tracer(capacity=len(self.batches) + 16) if self.trace \
            else None
        self.cluster = dbms.Cluster(cfg["deployment"]["n_nodes"],
                                    SwitchConfig(**cfg["switch"]), hi,
                                    device=self.device, tracer=tracer,
                                    **cfg["cluster"])
        self.probe = None
        if self.trace:
            from p4bench.probe import Probe
            self.probe = Probe(self.cluster, dbms, self._launch_tables())
        self._part("cluster", t0)
        t0 = time.perf_counter()
        populate(self.cluster, *self.initial)
        self._sync()
        self._part("load", t0)
        gc.freeze()
        gc.enable()
        self.lens, self.flat = [], []     # the answers, packed batch by batch
        self.open = collections.deque()   # answer lists not all filled yet
        self.next, self.marks = 0, []
        # the first batch loads the kernel libraries (building them on a
        # checkout's first run) and makes the first launches
        for part, n_batches in (("first_batch", min(1, self.warmup)),
                                ("warmup", self.warmup - 1)):
            t0 = time.perf_counter()
            for _ in range(min(n_batches, len(self.batches) - self.next)):
                self._one()
            self.cluster.drain()
            self._sync()
            self._part(part, t0)
        self._pack(final=True)
        self.built = dict(build.build_seconds)
        # every window starts from the same collector state, so its full
        # collections (which walk the growing in-memory WAL) fall at the
        # same points of the same work in every run
        t0 = time.perf_counter()
        gc.collect()
        self._part("collect", t0)
        if self.trace and self.device.type == "cuda":
            from p4bench import probe
            probe.prime()

    def _sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _launch_tables():
        """The program's kernel launch counters (``LAUNCHES`` of every
        loaded kernel module)."""
        return [m.LAUNCHES for name, m in list(sys.modules.items())
                if name.startswith("repro_torch.kernels.")
                and isinstance(getattr(m, "LAUNCHES", None), dict)]

    def _one(self):
        if self.next >= len(self.batches):
            raise TrafficExhausted(
                f"the window used all {len(self.batches)} batches of the "
                f"traffic: raise max_txn_per_s of the mix")
        t0 = time.perf_counter()
        out = self.cluster.run_batch(self.batches[self.next])
        self.next += 1
        answers = getattr(out, "_values", out)
        self.open.append(answers)
        self.marks.append(time.perf_counter())
        if self.probe is not None:
            self.probe.admitted(t0, answers)
        self._pack()

    def _pack(self, final=False):
        """Pack the answers of each batch whose answers are all in (every
        open batch's once the cluster has drained): a client reads them
        and lets them go."""
        while self.open and (final or None not in self.open[0]):
            lens, flat = compare.pack(self.open.popleft())
            self.lens.append(lens)
            self.flat.append(flat)

    def _drive(self, until: float):
        while (now := time.perf_counter()) < until:
            if now >= self.look_at:
                self.cpus.append(host.cpu_now())
                self.look_at = now + 1.0
            self._one()

    # ------------------------------------------------------------ window
    def window(self) -> dict:
        c = self.cluster
        first = self.next
        stats0 = dict(c.stats)
        d0 = c.switch.dispatch_count
        if self.trace:
            c.tracer.clear()
            self.probe.reset()
        self.marks, passes = [], []
        started = [0.0]

        def collector(phase, info):
            if phase == "start":
                started[0] = time.perf_counter()
            else:
                passes.append((started[0], time.perf_counter() - started[0],
                               info["generation"]))
        gc.callbacks.append(collector)
        self.cpus, self.look_at = [], 0.0
        before = self._host()
        try:
            t0 = time.perf_counter()
            end = t0 + self.seconds
            self.profile, self.profiler_s = None, 0.0
            if self.trace and self.device.type == "cuda":
                self._drive(t0 + 0.3 * self.seconds)
                self._profiled(end)
            self._drive(end)
            c.drain()
            self._sync()
            window_s = time.perf_counter() - t0
        finally:
            gc.callbacks.remove(collector)
        self.host = dict(cpus=self.cpus, start=before, end=self._host())
        self._pack(final=True)
        self.first_txn = sum(len(b) for b in self.batches[:first])
        self.txns = sum(len(b) for b in self.batches[first:self.next])
        stats = dict(c.stats)
        self.counters = dict(
            dispatches=c.switch.dispatch_count - d0,
            switch_txns=sum(stats.get(k, 0) - stats0.get(k, 0)
                            for k in ("hot", "warm")))
        bins = int(math.ceil(window_s))
        per_s = np.bincount((np.array(self.marks) - t0).astype(int),
                            minlength=bins)
        self.per_second = (per_s[:bins] * self.batch).tolist()
        self.collector = collector_summary(passes, t0, bins)
        # the traced run's spans and rest leave out the profiler's own
        # set-up, teardown and reading, which run between its spins
        return dict(window_s=window_s, txns=self.txns,
                    traced_s=window_s - self.profiler_s)

    def _host(self) -> dict:
        """The host's readings at one end of the window."""
        node = local = None
        if self.device.type == "cuda":
            import torch
            node, local = host.card_cpus(host.bus_id_of(
                torch.cuda.get_device_properties(self.device)))
        return dict(card_node=node, card_cpus=local,
                    affinity=host.affinity(), mhz=host.mhz(local),
                    usage=host.usage(), loadavg=host.loadavg(),
                    steal=host.steal())

    def _profiled(self, end: float):
        from p4bench import probe
        for _ in range(PROFILE_TRIES):
            until = min(time.perf_counter() + PROFILE_S, end)
            if until - time.perf_counter() < 0.5 * PROFILE_S:
                return
            self.probe.records = []
            t0 = time.perf_counter()
            rows, wall = probe.window(lambda: self._drive(until))
            self.profiler_s += time.perf_counter() - t0 - wall
            records, self.probe.records = self.probe.records, None
            if rows is None:
                log("p4bench: the profiler lost a window (no spins)")
                continue
            kernels = sum(c for _, k, c in rows if routes_of(k, records))
            launched = sum(len(r["routes"]) for r in records)
            if kernels != launched:
                log(f"p4bench: the profiler saw {kernels} of {launched} "
                    f"launches of a window")
                continue
            self.profile = dict(rows=rows, wall_s=wall, records=records,
                                busy_s=sum(t for t, _, _ in rows) * 1e-6)
            return

    # ------------------------------------------------------------ check
    def outputs(self) -> dict:
        """What the program served and holds, as plain host values."""
        c = self.cluster
        held = {}
        for node in c.nodes:
            held.update(node.store)
        keys = np.array(sorted(c.hot_index.placement.slot), np.int64)
        stray = 0
        if keys.size:
            for k in keys.tolist():
                held.pop(k, None)
            regs = c.switch.read_all().reshape(-1)
            flat = register_of(c, keys)
            held.update(zip(keys.tolist(), regs[flat].tolist()))
            rest = np.ones(regs.size, bool)
            rest[flat] = False
            stray = int(np.count_nonzero(regs[rest]))
        return dict(lens=np.concatenate(self.lens),
                    flat=np.concatenate(self.flat), held=held, stray=stray,
                    wals=[list(n.wal) for n in c.nodes],
                    commits=c.stats.get("commits", 0), switch_keys=keys)

    def check(self, got: dict) -> dict:
        """The numbers compared, for every txn of the warm-up and window;
        ``failed`` is left for the result line."""
        stream = self.stream.prefix(got["lens"].size)
        keys, values = self.initial
        ref = reference(self.cell).execute(
            stream, dict(zip(keys.tolist(), values.tolist())),
            switch_keys=got["switch_keys"])
        self.failed = compare.unanswered(ref, got["lens"], self.first_txn)
        return dict(
            results_bad=compare.results_bad(stream, ref, got["lens"],
                                            got["flat"]),
            values_bad=compare.values_bad(ref, got["held"], got["stray"]),
            wal_bad=compare.wal_bad(stream, ref, got["wals"], TID0),
            commits_gap=compare.commits_gap(ref, got["commits"]))

    # ------------------------------------------------------------ readings
    def evidence(self, w: dict) -> dict:
        p = self.probe
        spans, calls = dict(p.spans), dict(p.calls)
        prog, n = p.program_spans()
        for name in ("classify", "drain"):
            spans[name], calls[name] = prog.get(name, 0.0), n.get(name, 0)
        return dict(txns=w["txns"], window_s=w["traced_s"],
                    batch_s=p.batch_s, spans=spans, calls=calls,
                    counters=self.counters, profile=self.profile,
                    device_kind=_device_kind(self.device))


def collector_summary(passes, t0: float, bins: int) -> dict:
    """The collector's passes in a window: count and seconds of the full
    (generation 2) ones and of all, and its seconds in each second."""
    full = [d for _, d, g in passes if g == 2]
    per_s = [0.0] * bins
    for t, d, _ in passes:
        per_s[min(max(int(t - t0), 0), bins - 1)] += d
    return dict(full=len(full), full_s=sum(full), full_max_s=max(full,
                default=0.0), all=len(passes),
                all_s=sum(d for _, d, _ in passes), per_second=per_s)


def measure(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, parts=None, **run_kw):
    """One whole run after the look for a card: set-up (timed from
    ``t_start``, its earlier parts in ``parts``), window, the check and
    the readings.  Returns the result line (a dict, ``checks`` last) and
    a line on the run's set-up and window."""
    run = Run(cell, seed, seconds, device, trace=trace, **run_kw)
    run.setup_parts.update(parts or {})
    run.setup()
    setup_s = time.perf_counter() - t_start
    w = run.window()
    peak = 0
    if device.type == "cuda":
        import torch
        peak = torch.cuda.max_memory_allocated(device)
    gc.disable()                # the check allocates; nothing is timed
    try:
        got = run.outputs()
        ev = run.evidence(w) if trace else dict(w)
        ev["setup_s"] = setup_s
        run.cluster = run.probe = None       # free the program's state
        t0 = time.perf_counter()
        numbers = run.check(got)
        check_s = time.perf_counter() - t0
    finally:
        gc.unfreeze()
        gc.enable()
    correct, rows = compare.judge(numbers)

    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        v = read_metric(m["name"], ev)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": correct, "attempted": w["txns"],
           "failed": run.failed,
           "metrics": metrics,
           "device": {"platform": "gpu", "kind": _device_kind(device),
                      "count": cell["chips"], "memory_peak_bytes": int(peak)}}
    if trace:
        p = ev["profile"]
        if p is not None:
            out["device"].update(busy_s=p["busy_s"], window_s=p["wall_s"])
        # what the host did, each second counted once: the warm path's
        # own time is its span less the builds and dispatches inside it
        sp = ev["spans"]
        spent = {k: sp.get(k, 0.0) for k in ("classify", "packet_build",
                                             "dispatch", "drain")}
        spent["warm_self"] = sp.get("warm", 0.0) - sp.get("warm_inner", 0.0)
        spent["rest"] = ev["window_s"] - sum(spent.values())
        out["breakdown"] = {
            "device_ops": [[k, t * 1e-6] for t, k, _ in
                           (p["rows"][:10] if p else [])],
            "idle_gaps": sorted(([f"host {k}", v] for k, v in spent.items()),
                                key=lambda kv: -kv[1])[:10]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    info = ("setup " + ", ".join(f"{k} {v:.3f} s"
                                 for k, v in run.setup_parts.items())
            + f"; window {w['window_s']:.3f} s, {w['txns']} txns; check "
            f"{check_s:.3f} s; host maxrss {rss_bytes()} B; WAL records "
            f"{sum(len(x) for x in got['wals'])}; kernels built "
            f"{run.built}; txns a second of the window {run.per_second}; "
            + "collector {full} full passes {full_s:.3f} s (longest "
            "{full_max_s:.3f} s), {all} passes {all_s:.3f} s".format(
                **run.collector)
            + f"; collector s a second "
            f"{[round(x, 3) for x in run.collector['per_second']]}")
    if trace:
        info += f"; batches in the traced window {len(ev['batch_s'])}"
    return out, info + "; " + host_summary(run.host)


def host_summary(h: dict) -> str:
    """The host's readings of a window, for the run's line."""
    a, b = h["start"], h["end"]
    used = {k: round(b["usage"][k] - a["usage"][k], 3) for k in a["usage"]}
    return (f"host cpus in the window {h['cpus']}; affinity "
            f"{a['affinity']}; card numa node {a['card_node']} local cpus "
            f"{a['card_cpus']}; MHz at start "
            f"{[round(v) for v in a['mhz'].values()]} at end "
            f"{[round(v) for v in b['mhz'].values()]}; in the window cpu "
            f"{used['user_s']} s user {used['system_s']} s system, "
            f"{used['faults']} page faults, context switches "
            f"{used['voluntary']} voluntary {used['involuntary']} "
            f"involuntary; steal ticks {_less(b['steal'], a['steal'])}; "
            f"loadavg at start {a['loadavg']} at end {b['loadavg']}")


def _less(b, a):
    return None if a is None or b is None else b - a


def _device_kind(device):
    if device.type != "cuda":
        return None
    import torch
    return torch.cuda.get_device_name(device)


def routes_of(kernel_name: str, records) -> bool:
    """Whether a device row is a kernel of a route the dispatches took."""
    routes = {r.split(".")[0] for rec in records for r in rec["routes"]}
    return any(f"{r}_kernel" in kernel_name for r in routes)


def read_metric(name: str, ev: dict):
    """A metric's reading by its reader ``metrics/<name>.py``; None where
    it finds nothing to read."""
    return importlib.import_module(f"p4bench.metrics.{name}").read(ev)


def roofline_bytes(route: str, rec: dict) -> int:
    return importlib.import_module(f"p4bench.roofline.{route}").bytes_of(rec)


def peak(kind: str, what: str):
    table = json.loads((BENCH / "roofline" / "peaks.json").read_text())
    return table.get(kind, {}).get(what)
