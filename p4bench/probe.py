"""The traced run's instruments, all set up from the harness around the
program's calls (no program file is touched):

* spans: ``packet_build`` around every ``build_packets`` the cluster
  calls, ``dispatch`` around every ``execute_batch`` of its engine,
  ``warm`` around every ``_run_warm`` (``warm_inner``: the packet builds
  and dispatches inside it); the program's own tracer gives ``classify``
  and ``drain``;
* each batch's latency, from admission until its answers are on the
  host (on the async path: when its last group drains);
* a profiler window (``torch.profiler``) over a steady part of the run,
  opened and closed by a spin kernel, with the packets of the dispatches
  made inside it, for the kernels' rooflines.

The profiler loses windows on the H100 as a process ages unless CUPTI is
torn down after each window (``TEARDOWN_CUPTI=1``, set by ``run.py``
before torch loads), and even then drops about every other window and at
times a window's first events: a window whose two spins or whose launch
count do not show is taken again.
"""
from __future__ import annotations

import collections
import time

import torch

SPIN_CYCLES = 1000


class Probe:
    def __init__(self, cluster, dbms, launch_tables):
        self.cluster = cluster
        self.launch_tables = launch_tables
        self.spans = collections.defaultdict(float)
        self.calls = collections.Counter()
        self.batch_s = []
        self._open = {}               # id(answers) -> admission time
        self.records = None           # dispatches of the profiled window
        clock = time.perf_counter
        self._in_warm = False

        def timed(name, fn):
            def call(*a, **kw):
                t = clock()
                try:
                    return fn(*a, **kw)
                finally:
                    d = clock() - t
                    self.spans[name] += d
                    self.calls[name] += 1
                    if self._in_warm and name != "warm":
                        self.spans["warm_inner"] += d
            return call

        def warm(fn):
            run_warm = timed("warm", fn)

            def call(*a, **kw):
                self._in_warm = True
                try:
                    return run_warm(*a, **kw)
                finally:
                    self._in_warm = False
            return call

        dbms.build_packets = timed("packet_build", dbms.build_packets)
        execute = timed("dispatch", cluster.switch.execute_batch)

        def execute_batch(pkts, meta=None, *a, **kw):
            if self.records is None:
                return execute(pkts, meta, *a, **kw)
            before = self._launches()
            out = execute(pkts, meta, *a, **kw)
            after = self._launches()
            self.records.append(dict(
                routes=[k for k in after if after[k] != before.get(k, 0)],
                op=pkts["op"], stage=pkts["stage"], reg=pkts["reg"],
                regs_per_stage=cluster.switch_cfg.regs_per_stage,
                answers=len(meta["gather_idx"])))
            return out

        cluster.switch.execute_batch = execute_batch
        cluster._run_warm = warm(cluster._run_warm)
        drain_group = cluster._drain_group

        def _drain_group(pb, pending, meta, results, tr=None):
            drain_group(pb, pending, meta, results, tr)
            t0 = self._open.get(id(results))
            if t0 is not None and None not in results:
                self.batch_s.append(clock() - t0)
                del self._open[id(results)]

        cluster._drain_group = _drain_group

    def reset(self):
        """Forget what the warm-up recorded."""
        self.spans.clear()
        self.calls.clear()
        self.batch_s.clear()
        self._open.clear()

    def _launches(self):
        out = {}
        for table in self.launch_tables:
            out.update(table)
        return out

    def admitted(self, t0, answers):
        """A batch admitted at ``t0`` returned ``answers`` (a list)."""
        if None in answers:
            self._open[id(answers)] = t0
        else:
            self.batch_s.append(time.perf_counter() - t0)

    def program_spans(self):
        """Seconds by span name of the program's own tracer."""
        out = collections.defaultdict(float)
        n = collections.Counter()
        for tr in self.cluster.tracer.traces:
            for s in tr.spans:
                out[s.name] += s.duration
                n[s.name] += 1
        return out, n


def device_rows(prof):
    """[(device us, name, count)] by kernel or copy name."""
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")) != "DeviceType.CUDA":
            continue                 # host ops repeat their kernels' time
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((t, e.key, e.count))
    return sorted(rows, reverse=True)


def window(fn):
    """(rows, wall s) of one profiler window around ``fn()`` bracketed by
    spin kernels whose rows are dropped; rows None when the profiler did
    not see both spins."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    spins = sum(c for _, k, c in rows if "spin_kernel" in k)
    return ([r for r in rows if "spin_kernel" not in r[1]]
            if spins == 2 else None), wall


def prime(tries: int = 3):
    """Empty windows until the profiler loses one (the window after a lost
    one is kept)."""
    torch.cuda.synchronize()
    for _ in range(tries):
        if window(lambda: None)[0] is None:
            return
