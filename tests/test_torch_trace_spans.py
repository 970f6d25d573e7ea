"""The port cluster's own spans, held on the CPU: a hot group's
``packet-build`` (the build actually run), ``wal-send``, ``dispatch``,
``drain`` and ``scatter``; a warm attempt's ``warm`` with ``cold-exec``,
``switch-sub`` and ``commit`` inside it; and each dispatch's ``device``
span, from the timing events ``Tracer.device_events`` asks for, on the
tracer's clock through one anchor per card.

There are no events on the CPU, so the device bookkeeping runs over
stand-ins (``CudaApi``): a stand-in stream keeps its events in record
order, an event completes when it or a later event of its stream is
waited on (a stream the caller's own, the sync engine's, completes each
event as it is recorded), and an event's time is the tracer's clock at
its record plus a card clock's offset.  Nothing here imports the JAX
package."""
import contextlib
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.hotset import build_hot_index  # noqa: E402
from repro_torch.core.packets import WRITE, SwitchConfig  # noqa: E402
from repro_torch.db import dbms  # noqa: E402
from repro_torch.db.dbms import Cluster  # noqa: E402
from repro_torch.db.txn import Txn  # noqa: E402
from repro_torch.obs import FUNCTIONAL_SPANS, PORT_SPANS  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.workloads import smallbank, tpcc, ycsb  # noqa: E402

CFG = SwitchConfig(n_stages=16, regs_per_stage=512, max_instrs=16)
CARD_OFFSET = 5000.0          # the stand-in card clock, ahead of the host's
HOT = ("packet-build", "wal-send", "dispatch", "drain", "scatter")
WARM = ("cold-exec", "switch-sub", "commit")


# ---------------------------------------------------------------- stand-ins

class Clock:
    """A host clock that moves one tick a reading."""

    def __init__(self):
        self._n = itertools.count(1)

    def __call__(self):
        return float(next(self._n))


class StandInStream:
    def __init__(self, eager=False):
        self.eager = eager
        self.recorded = []
        self.waited = []

    def wait_event(self, event):
        self.waited.append(event)


class StandInEvent:
    """An event on a stand-in stream; ``t`` its card time when timing."""

    def __init__(self, clock, timing):
        self.clock, self.timing = clock, timing
        self.done, self.stream, self.t = True, None, None

    def record(self, stream):
        self.stream, self.done = stream, stream.eager
        stream.recorded.append(self)
        if self.timing:
            self.t = self.clock() + CARD_OFFSET

    def query(self):
        return self.done

    def synchronize(self):
        rec = self.stream.recorded
        for ev in rec[:rec.index(self) + 1]:
            ev.done = True

    def elapsed_time(self, other):
        assert self.timing and other.timing and self.done and other.done
        return (other.t - self.t) * 1e3


def _api(clock, made):
    current = StandInStream(eager=True)

    def stream(device):
        made.append(StandInStream())
        return made[-1]

    return dispatch.CudaApi(
        stream=stream, event=lambda: StandInEvent(clock, False),
        scope=lambda s: contextlib.nullcontext(),
        current=lambda d: current, pin=False,
        timer=lambda: StandInEvent(clock, True))


@pytest.fixture
def card(monkeypatch):
    """Every engine built in the test takes its queue over stand-ins (the
    stream queue when async, the inline queue on an eager current
    stream); returns the clock the tracer must share."""
    clock, made = Clock(), []
    api = _api(clock, made)

    def make_queue(device, async_dispatch, depth):
        if async_dispatch:
            return dispatch.StreamQueue(device, depth, api)
        return dispatch.InlineQueue(device, depth, api)

    monkeypatch.setattr(teng, "make_queue", make_queue)
    return clock


# ---------------------------------------------------------------- workloads

def _ycsb(n=6 * 64):
    p = ycsb.YCSBParams(n_nodes=4, keys_per_node=1000, hot_per_node=16,
                        p_hot_txn=1.0)
    sample = ycsb.generate(np.random.default_rng(0), 1500, p)
    hi = build_hot_index(ycsb.traces(sample), 64, CFG)
    return hi, ycsb.generate(np.random.default_rng(1), n, p), 64


def _tpcc(n=3 * 32):
    p = tpcc.TPCCParams(n_nodes=4, n_warehouses=8)
    sample = tpcc.generate(np.random.default_rng(0), 800, p)
    hi = build_hot_index(tpcc.traces(sample), 250, CFG)
    return hi, tpcc.generate(np.random.default_rng(1), n, p), 32


WORK = {"ycsb_async": (_ycsb, dict(async_hot=True, max_inflight=2)),
        "tpcc_sync": (_tpcc, {})}


def _cluster(hi, tracer=None, **kw):
    kw.setdefault("telemetry", True)
    return Cluster(4, CFG, hi, device="cpu", tracer=tracer, **kw)


def _run(c, txns, batch):
    out = []
    for lo in range(0, len(txns), batch):
        out.extend(c.run_batch([Txn(t.kind, list(t.ops), t.home, tid=t.tid)
                                for t in txns[lo:lo + batch]]))
    c.drain()
    return [list(r) for r in out]


def _state(c, results):
    return (results, c.switch.read_all().tolist(), c.switch.next_gid,
            dict(c.stats),
            [[(r.kind, r.tid, r.payload, r.hash) for r in n.wal]
             for n in c.nodes])


def _spans(c):
    return [s for tr in c.tracer.traces for s in tr.spans]


def _inside(inner, outer, slack=0.0):
    return outer.t0 - slack <= inner.t0 and inner.t1 <= outer.t1 + slack


def _log_times(c):
    """[(record kind, clock)] of every WAL record the nodes log from now."""
    got = []
    for n in c.nodes:
        def log(kind, tid, _log=n.log, **payload):
            got.append((kind, c.tracer.clock()))
            return _log(kind, tid, **payload)
        n.log = log
    return got


def _held(times, spans, kind, name):
    """Whether every ``kind`` record was logged inside a ``name`` span."""
    inside = [(s.t0, s.t1) for s in spans if s.name == name]
    at = [t for k, t in times if k == kind]
    return bool(at) and all(any(a <= t <= b for a, b in inside) for t in at)


# ------------------------------------------------------------ the host spans

def test_hot_groups_have_one_span_of_each_part(monkeypatch):
    """Per dispatched group one ``packet-build`` holding the build that
    ran (and nothing else builds), one ``wal-send`` holding its send
    records, one ``dispatch``, ``drain`` and ``scatter``; every name is
    the JAX package's or the port's own."""
    hi, txns, batch = _ycsb()
    builds = []
    build = dbms.build_packets

    def timed_build(*a, **kw):
        t0 = c.tracer.clock()
        out = build(*a, **kw)
        builds.append((t0, c.tracer.clock()))
        return out

    monkeypatch.setattr(dbms, "build_packets", timed_build)
    c = _cluster(hi, **WORK["ycsb_async"][1])
    d0 = c.switch.dispatch_count
    logged = _log_times(c)
    _run(c, txns, batch)
    groups = c.switch.dispatch_count - d0
    assert groups == len(txns) // batch and c.stats["hot"] == len(txns)
    for tr in c.tracer.traces:
        names = tr.names()
        assert names[0] == "classify"
        assert [n for n in names if n != "classify"] == list(HOT), names
    spans = _spans(c)
    assert {s.name for s in spans} <= set(FUNCTIONAL_SPANS) | set(PORT_SPANS)
    pb = [s for s in spans if s.name == "packet-build"]
    assert len(pb) == len(builds) == groups
    for s, (t0, t1) in zip(pb, builds):
        assert s.t0 <= t0 and t1 <= s.t1
    assert _held(logged, spans, "switch_send", "wal-send")
    assert _held(logged, spans, "switch_result", "scatter")
    assert len(logged) == 2 * len(txns)
    assert all(s.depth == 0 for s in spans)


def test_split_group_builds_once_a_sub_group(monkeypatch):
    """SmallBank's hot txns, whose groups split at unsafe ADDP txns: the
    whole group's build and each sub-group's are a ``packet-build`` each,
    and each sub-group's dispatch one ``wal-send``, ``drain`` and
    ``scatter``."""
    p = smallbank.SmallBankParams(n_nodes=2, accounts_per_node=50,
                                  hot_per_node=4)
    sample = smallbank.generate(np.random.default_rng(0), 2000, p)
    c = Cluster(2, CFG, build_hot_index(smallbank.traces(sample), 16, CFG),
                device="cpu")
    for k in smallbank.hot_keys(p):
        c.load(k, 100)
    txns = [t for t in smallbank.generate(np.random.default_rng(1), 480, p)
            if c.classify(t) == "hot"]
    calls = []
    build = dbms.build_packets
    monkeypatch.setattr(dbms, "build_packets",
                        lambda *a, **kw: calls.append(1) or build(*a, **kw))
    c.tracer.clear()
    d0 = c.switch.dispatch_count
    _run(c, txns, 64)
    spans = _spans(c)
    n = {name: sum(s.name == name for s in spans) for name in HOT}
    assert n["packet-build"] == len(calls) > c.switch.dispatch_count - d0
    assert n["wal-send"] == n["scatter"] == n["drain"] == n["dispatch"]


def test_warm_attempt_holds_its_three_parts():
    """Per warm attempt one ``warm`` at depth 0 with ``cold-exec``,
    ``switch-sub`` and ``commit`` at depth 1 inside it, in that order;
    the warm path records no ``packet-build``, ``dispatch`` or ``drain``
    (its switch sub-txn runs untraced), on the batch and per-txn paths."""
    hi, txns, batch = _tpcc()
    c = _cluster(hi)
    logged = _log_times(c)
    _run(c, txns, batch)
    spans = _spans(c)
    for kind, name in (("write", "cold-exec"), ("switch_send", "switch-sub"),
                       ("switch_result", "switch-sub"), ("commit", "commit")):
        assert _held(logged, spans, kind, name), kind
    assert c.stats["warm"] == len(txns) and c.stats["hot"] == 0
    for tr in c.tracer.traces:
        assert tr.names() == ["classify"] + ["warm", *WARM] * batch
    per_txn = _cluster(hi)
    for t in txns[:8]:
        per_txn.run(Txn(t.kind, list(t.ops), t.home, tid=t.tid))
    for c in (c, per_txn):
        spans = _spans(c)
        warm = [i for i, s in enumerate(spans) if s.name == "warm"]
        assert len(warm) == c.stats["warm"]
        for i in warm:
            parts = spans[i + 1:i + 4]
            assert [s.name for s in parts] == list(WARM)
            assert spans[i].depth == 0 and all(s.depth == 1 for s in parts)
            assert all(_inside(s, spans[i]) for s in parts)
            assert parts[0].t1 <= parts[1].t0 and parts[1].t1 <= parts[2].t0
        assert not {"packet-build", "dispatch", "drain"} & \
            {s.name for s in spans}


@pytest.mark.parametrize("work", sorted(WORK))
def test_spans_leave_the_state_as_it_was(card, work):
    """Results, registers, GIDs, stats and WALs are byte-identical with
    telemetry on, off, and with device events on."""
    make, kw = WORK[work]
    hi, txns, batch = make()
    got = []
    for telemetry, events in ((True, False), (False, False), (True, True)):
        tracer = None
        if telemetry:
            tracer = Tracer(clock=card)
            tracer.device_events = events
        c = _cluster(hi, tracer=tracer, telemetry=telemetry, **kw)
        got.append(_state(c, _run(c, txns, batch)))
        if events:
            assert tracer.settle() == 0
            assert sum(s.name == "device" for s in _spans(c)) == \
                c.switch.dispatch_count
    assert got[0] == got[1] == got[2]


# ----------------------------------------------------------- the device spans

def test_anchor_converts_card_time_to_the_tracer_clock():
    clock = Clock()
    cur = StandInStream(eager=True)

    def stamp():
        ev = StandInEvent(clock, True)
        ev.record(cur)
        return ev

    tracer = Tracer(clock=clock)
    assert tracer.anchor("cpu", lambda: None) is False
    assert tracer.anchor("card", stamp) is True
    # first event at card time 1 + offset, read on the host at 2; the
    # second at 3 + offset, read at 4: the tie misses by nothing
    assert tracer.anchor_skew_s == {"card": 0.0}
    assert tracer.anchor("card", stamp) is True          # once a window
    tr = tracer.start("batch:1")
    with tr.span("drain") as took:
        pair = (stamp(), stamp())     # recorded at 6 and 7: read 1 later
    tracer.took(tr, took, "card", pair)
    with tr.span("scatter"):
        pass
    assert tr.names() == ["drain", "device", "scatter"]
    dev = tr.spans[1]
    assert dev.t1 is None                              # open until a settle
    assert tracer.settle() == 0
    assert (dev.t0, dev.t1, dev.depth) == (pytest.approx(7.0),
                                           pytest.approx(8.0), 0)
    tracer.clear()
    assert tracer.anchor_skew_s == {} and not tracer._anchors


def test_pair_not_complete_is_parked_not_dropped():
    """A pair whose end has not completed at a ``settle`` leaves its
    ``device`` span open, without a wait on the card, for a later settle
    to close; its place right after its own span is kept meanwhile."""
    clock = Clock()
    stream = StandInStream()

    def stamp():
        ev = StandInEvent(clock, True)
        ev.record(stream)
        return ev

    tracer = Tracer(clock=clock)
    tracer.anchor("card", stamp)
    tr = tracer.start("batch:2")
    with tr.span("drain") as first:
        late = (stamp(), stamp())
    tracer.took(tr, first, "card", late)
    assert tracer.settle() == 1
    assert tr.names() == ["drain", "device"] and tr.spans[1].t1 is None
    with tr.span("drain") as second:
        on_time = (stamp(), stamp())
    on_time[1].synchronize()          # the later wait completes both
    tracer.took(tr, second, "card", on_time)
    assert tracer.settle() == 0
    assert tr.names() == ["drain", "device", "drain", "device"]
    assert tr.spans[1].t0 < tr.spans[1].t1 < tr.spans[3].t0
    assert tracer.settle() == 0       # a closed span is read once


def test_async_groups_place_device_spans_after_their_drain(card):
    """The stream path: each group's ``device`` span right after the
    ``drain`` that took its results, a WRITE-only group's too (no device
    rows: its drain waits for nothing, and its end completes once a later
    group's results are waited for); no pair is dropped, and the card's
    clock is tied once a window."""
    hi, txns, batch = _ycsb(4 * 64)
    tracer = Tracer(clock=card)
    tracer.device_events = True
    c = _cluster(hi, tracer=tracer, async_hot=True, max_inflight=2)
    keys = sorted(hi.placement.slot)[:8]
    writes = [Txn("w", [(WRITE, k, 7 + i) for k in keys], 0,
                  tid=10 ** 6 + i) for i in range(batch)]
    _run(c, txns[:2 * batch] + writes + txns[2 * batch:], batch)
    assert tracer.settle() == 0
    assert len(tracer._anchors) == 1 and tracer.anchor_skew_s
    groups = c.switch.dispatch_count
    spans = _spans(c)
    dev = [i for i, s in enumerate(spans) if s.name == "device"]
    assert len(dev) == groups == 5
    for i in dev:
        assert spans[i - 1].name == "drain"
        assert spans[i].t1 <= spans[i - 1].t1 + 1
    assert [s.name for s in c.tracer.traces[2].spans][-3:] == \
        ["drain", "device", "scatter"]


def test_sync_device_spans_lie_inside_their_switch_sub(card):
    hi, txns, batch = _tpcc(2 * 32)
    tracer = Tracer(clock=card)
    tracer.device_events = True
    c = _cluster(hi, tracer=tracer)
    _run(c, txns, batch)
    assert tracer.settle() == 0
    spans = _spans(c)
    subs = [i for i, s in enumerate(spans) if s.name == "switch-sub"]
    assert len(subs) == c.switch.dispatch_count == len(txns)
    skew = abs(tracer.anchor_skew_s[c.switch.device])
    for i in subs:
        dev = spans[i + 1]
        assert dev.name == "device" and dev.depth == 1
        assert _inside(dev, spans[i], skew + 1)
        assert spans[i + 2].name == "commit"


def test_device_events_off_records_nothing(card):
    """Off (the default), no event is made and no span differs."""
    hi, txns, batch = _tpcc(32)
    tracer = Tracer(clock=card)
    c = _cluster(hi, tracer=tracer)
    stamps = []
    monkey = c.switch._queue.stamp
    c.switch._queue.stamp = lambda: stamps.append(1) or monkey()
    _run(c, txns, batch)
    assert not stamps and not tracer._anchors
    assert "device" not in {s.name for s in _spans(c)}

