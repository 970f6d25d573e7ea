"""Async dispatch on CUDA streams and events (``core/dispatch.py``) held on
the CPU.

There is no card here, so the stream queue runs with stand-in streams and
events (``CudaApi``): a stand-in event reports done only once something
waited on it, as if the device ran nothing until the host asked.  Its
tensors are CPU tensors, so every dispatch computes for real and the
whole async path, stream queue included, is held against the JAX
package.  The thread queue (the async path of ``device="cpu"``) is held
against the JAX package's sync cluster on SmallBank, whose loads the
reference's own async tests race on."""
import contextlib
import itertools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.db.dbms import Cluster as JCluster  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.packets import (WRITE, SwitchConfig,  # noqa: E402
                                      build_packets)
from repro_torch.db.dbms import Cluster as TCluster  # noqa: E402
from repro_torch.db.txn import Txn as TTxn  # noqa: E402
import test_torch_dbms as TD  # noqa: E402
import test_torch_durability as TDU  # noqa: E402
import test_torch_reads as TR  # noqa: E402

CFG = SwitchConfig(n_stages=4, regs_per_stage=32, max_instrs=8)


class StandInEvent:
    """A CUDA event of a device that runs nothing until the host waits:
    ``query()`` is False from ``record()`` until ``synchronize()``."""

    def __init__(self):
        self.done = True
        self.stream = None

    def record(self, stream=None):
        self.done, self.stream = False, stream

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


class StandInStream:
    def __init__(self, device, handle):
        self.device, self.cuda_stream = device, handle
        self.waited = []

    def wait_event(self, event):
        self.waited.append(event)


def _api(events, streams):
    handles = itertools.count(0x7000)

    def stream(device):
        streams.append(StandInStream(device, next(handles)))
        return streams[-1]

    def event():
        events.append(StandInEvent())
        return events[-1]

    return dispatch.CudaApi(stream=stream, event=event,
                            scope=lambda s: contextlib.nullcontext(),
                            current=lambda d: ("current", str(d)),
                            pin=False)


@pytest.fixture
def streams(monkeypatch):
    """Every async engine built in the test takes a stream queue over
    stand-ins, whatever its device; returns (events, streams) made."""
    events, made = [], []
    api = _api(events, made)

    def make_queue(device, async_dispatch, depth):
        if not async_dispatch:
            return dispatch.InlineQueue(device, depth)
        return dispatch.StreamQueue(device, depth, api)

    monkeypatch.setattr(teng, "make_queue", make_queue)
    return events, made


def _dispatch_threads():
    return {t.ident for t in threading.enumerate()
            if t.name.startswith("switch-dispatch")}


# ------------------------------------------------ parity with the JAX package

def _wal_by_tid(c):
    """Each node's WAL records, its switch_result records set apart and
    ordered by tid: an async cluster logs a hot group's results at its
    drain, which may come later in the log than a sync cluster's; nothing
    else moves."""
    return [([(e.kind, e.tid, e.payload) for e in n.wal
              if e.kind != "switch_result"],
             sorted(((e.tid, e.payload) for e in n.wal
                     if e.kind == "switch_result"), key=lambda r: r[0]))
            for n in c.nodes]


@pytest.mark.parametrize("queue", ["thread", "stream"])
@pytest.mark.parametrize("mode", ["pallas", "auto"])
def test_smallbank_async_matches_jax_sync(mode, queue, request):
    """SmallBank (CADD; ADDP in auto mode) on an async port cluster
    against the JAX package's sync cluster: results, registers, GIDs,
    stats, WAL records, and the state after recovery and failover."""
    if queue == "stream":
        request.getfixturevalue("streams")
    traces, top_k, txns, loads, n_nodes = TD._smallbank(
        no_addp=(mode == "pallas"), top_k=8 if mode == "auto" else 16)
    jhi, thi = TD._indexes(traces, top_k)
    jc = JCluster(n_nodes, TD.SW, jhi, switch_mode=mode, standby=True)
    tc = TCluster(n_nodes, TD.TSW, thi, switch_mode=mode, standby=True,
                  async_hot=True, max_inflight=2, device="cpu")
    assert isinstance(tc.switch._queue, dispatch.StreamQueue
                      if queue == "stream" else dispatch.ThreadQueue)
    for k, v in loads:
        jc.load(k, v)
        jc.switch.read_all()    # the reference load race (test_torch_dbms)
        tc.load(k, v)
    for c in (jc, tc):
        c.snapshot_offload()
    ttxns = TD._port_txns(txns)
    out_j, out_t = [], []
    for i in range(0, len(txns), 50):
        out_j += jc.run_batch(txns[i:i + 50])
        out_t.append(tc.run_batch(ttxns[i:i + 50]))
    TD._same_results(out_j, [r for out in out_t for r in out])
    assert jc.stats["hot"] > 0 and (mode == "pallas" or jc.stats["warm"])
    for step in ("run", "recovered", "failed over"):
        np.testing.assert_array_equal(jc.switch.read_all(),
                                      tc.switch.read_all())
        assert jc.switch.next_gid == tc.switch.next_gid
        assert dict(jc.stats) == dict(tc.stats)
        assert _wal_by_tid(jc) == _wal_by_tid(tc), step
        for c in (jc, tc):
            if step == "run":
                c.crash_switch_and_recover()
            elif step == "recovered":
                c.fail_over()


def test_ycsb_on_streams_matches_jax_async(streams):
    """The stream queue's async path against the JAX async cluster
    (tests/test_torch_dbms.py's harness): WAL records land at the same
    drains, so they are equal one for one, hash chain too."""
    TD._assert_equivalent(TD._ycsb(), "pallas", async_hot=True)
    assert streams[1], "no stream was made"


@pytest.mark.parametrize("n_switches", [1, 2])
@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_reads_and_scans_on_streams_match_jax(n_switches, mode, streams):
    """Reads and scans queued behind undrained writes on the plane's
    stream see every earlier write (tests/test_torch_reads.py's mixed
    stream, async)."""
    jc, tc, hot, cold = TR._twins(n_switches, True, mode)
    TR._stream(jc, tc, hot, cold, allow_cadd=(mode == "auto"))
    assert len(streams[1]) == n_switches


@pytest.mark.parametrize("point", ["mid_group_dispatch", "undrained_async"])
def test_async_crash_points_on_streams_match_jax(point, streams):
    """The async crash points with the port's groups on the stream queue
    (tests/test_torch_durability.py's case): dispatched work may still
    be queued when the crash fires; the same sends replay as known and
    unknown, into registers equal to the JAX package's."""
    TDU.test_crash_point_recovers_like_jax(point, True)
    assert streams[1], "no stream was made"


# ------------------------------------------------- the stream queue's books

def _write_packets(keys, value):
    """One WRITE-only B = 1 packet per key on a single-switch placement."""
    from repro_torch.core.hotset import HotIndex
    from repro_torch.core.layout import Placement
    hi = HotIndex(Placement(slot={k: (0, k % CFG.n_stages,
                                      k // CFG.n_stages) for k in keys}))
    return [build_packets([TTxn("w", [(WRITE, k, value + k)], 0)], hi, CFG)
            for k in keys]


def _guarded(stager):
    """Wrap ``stager`` so every slot it hands out is checked: each event
    recorded after a copy out of that slot must have completed (been
    waited on: the stand-ins complete nothing by themselves) before the
    slot is written again.  Returns the number of rewrites seen."""
    after_copy, rewrites = {}, [0]
    take, guard = stager._take, stager.guard

    def checked_take(shape):
        slot = take(shape)
        seen = after_copy.get(id(slot), [])
        assert all(e.done for e in seen), "slot rewritten before its copy"
        rewrites[0] += bool(seen)
        return slot

    def recorded_guard(event):
        assert event.stream is not None, "a guard event was not recorded"
        for slot in stager._copied:
            after_copy.setdefault(id(slot), []).append(event)
        guard(event)

    stager._take, stager.guard = checked_take, recorded_guard
    return rewrites


def test_staging_slot_waits_for_its_copy_event(streams):
    """A WRITE-only burst three times the pool deep, deferred and never
    drained: every slot rewrite waits for the event recorded after the
    copy that read the slot, and the registers come out right."""
    events, _ = streams
    eng = teng.SwitchEngine(CFG, stager_pool=4, async_dispatch=True,
                            device="cpu")
    ref = teng.SwitchEngine(CFG, device="cpu")
    rewrites = _guarded(eng._stager)
    keys = list(range(3 * eng._stager.pool))
    handles = [eng.execute_batch(p, m, mode="pallas", defer=True)
               for p, m in _write_packets(keys, 100)]
    for p, m in _write_packets(keys, 100):
        ref.execute_batch(p, m, mode="pallas")
    pool = eng._stager.pool
    assert rewrites[0] == len(keys) - pool
    # a slot's guard is the done event of the dispatch that copied from
    # it: the host waited on the dispatches whose slots came round again,
    # and on no later one
    assert all(h._fut.done() for h in handles[:-pool])
    assert not any(h._fut.done() for h in handles[-pool:])
    assert len(events) == len(keys) + 1         # done events, and a fence
    np.testing.assert_array_equal(eng.read_all(), ref.read_all())


def test_load_burst_waits_only_on_slots(streams):
    """``Cluster.load`` is a WRITE-only dispatch with no device result
    rows: its ``results_np`` waits for nothing, so in a burst of loads
    three times the pool deep the slot events are the only guard, and
    every load lands (the reference's ``load()`` race, closed)."""
    thi = TR._indexes([TR.key_of(0, i) for i in range(24)], 1)[1]
    tc = TCluster(TR.N_NODES, TR._cfgs(1)[1], thi, async_hot=True,
                  max_inflight=2, device="cpu")
    ref = TCluster(TR.N_NODES, TR._cfgs(1)[1], thi, device="cpu")
    q = tc.switch._queue
    rewrites = _guarded(q.stager)
    loads = [(k, 7 * i + 1) for i, k in enumerate(sorted(
        thi.placement.slot))][:3 * q.stager.pool]
    for k, v in loads:
        tc.load(k, v)
        ref.load(k, v)
    assert rewrites[0] == len(loads) - q.stager.pool
    assert q._pending and not q._pending[-1].done   # nobody waited
    np.testing.assert_array_equal(tc.switch.read_all(), ref.switch.read_all())
    assert TD._wal(tc) == TD._wal(ref)


def test_join_waits_on_every_event(streams):
    """``join()`` (read_all, snapshot) waits on every done event queued,
    writes and reads alike, not only the last."""
    # a ring deeper than the writes: no slot waits on a dispatch
    eng = teng.SwitchEngine(CFG, stager_pool=8, async_dispatch=True,
                            device="cpu")
    keys = list(range(6))
    handles = [eng.execute_batch(p, m, mode="auto", defer=True)
               for p, m in _write_packets(keys, 10)]
    rp = teng.ReadPacket(switch=np.zeros(3, np.int32),
                         stage=np.array([0, 1, 2], np.int32),
                         reg=np.array([0, 0, 0], np.int32))
    handles.append(eng.execute_reads(rp, defer=True))
    dones = [h._fut.event for h in handles]
    assert not any(e.done for e in dones)
    regs = eng.read_all()
    assert all(e.done for e in dones) and not eng._queue._pending
    assert list(handles[-1].values_np()) == [10, 11, 12]
    assert all(regs[k % 4, k // 4] == 10 + k for k in keys)


def test_launch_error_raises_at_launch_like_sync(streams, monkeypatch):
    """A dispatch that fails at launch raises in ``execute_batch`` on the
    caller's thread, records no done event, and leaves dispatch_count
    and next_gid where the sync engine leaves them; the engine goes on."""
    engines = {"sync": teng.SwitchEngine(CFG, device="cpu"),
               "stream": teng.SwitchEngine(CFG, async_dispatch=True,
                                           device="cpu")}
    (p0, m0), (p1, m1) = _write_packets([1, 2], 5)
    run_fused = teng._run_fused

    def fail(*args):
        raise RuntimeError("launch failed")

    for eng in engines.values():
        eng.execute_batch(p0, m0, mode="pallas", defer=True)
        monkeypatch.setattr(teng, "_run_fused", fail)
        with pytest.raises(RuntimeError, match="launch failed"):
            eng.execute_batch(p1, m1, mode="pallas", defer=True)
        monkeypatch.setattr(teng, "_run_fused", run_fused)
    sync, stream = engines["sync"], engines["stream"]
    assert len(stream._queue._pending) == 1
    assert (stream.dispatch_count, stream.next_gid) == \
        (sync.dispatch_count, sync.next_gid) == (2, 2)
    for eng in engines.values():
        eng.execute_batch(p1, m1, mode="pallas", defer=True)
    np.testing.assert_array_equal(stream.read_all(), sync.read_all())


@pytest.fixture
def fake_card(monkeypatch):
    """A CUDA device on the CPU: fake tensors on ``cuda:0``, the stream
    queue's CUDA calls as stand-ins (tests/test_torch_launch_device.py's
    device stand-ins)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    events, made = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    api = _api(events, made)
    monkeypatch.setattr(dispatch, "cuda_api", lambda: api)
    with FakeTensorMode(allow_non_fake_inputs=True):
        yield made


def test_card_engine_takes_the_stream_queue(fake_card):
    """On a CUDA device an async engine takes the stream queue and starts
    no thread; its new register file is fenced into its stream; the sync
    engine stays inline; planes sharing one card get a stream each."""
    before = _dispatch_threads()
    eng = teng.SwitchEngine(CFG, async_dispatch=True, device="cuda:0")
    assert isinstance(eng._queue, dispatch.StreamQueue)
    assert isinstance(eng._stager, dispatch.PinnedStager)
    assert eng._queue.stream is fake_card[0]
    assert fake_card[0].device == torch.device("cuda", 0)
    assert len(fake_card[0].waited) == 1          # after init_registers
    eng.load_registers(np.ones((CFG.n_stages, CFG.regs_per_stage)))
    assert len(fake_card[0].waited) == 2
    sync = teng.SwitchEngine(CFG, device="cuda:0")
    assert type(sync._queue) is dispatch.InlineQueue
    for n in (2, 4):
        made = len(fake_card)
        sharded = teng.ShardedSwitchEngine(
            SwitchConfig(n_stages=4, regs_per_stage=32, max_instrs=8,
                         n_switches=n), async_dispatch=True,
            device="cuda:0")
        handles = [pl._queue.stream.cuda_stream for pl in sharded.planes]
        assert len(set(handles)) == n == len(fake_card) - made
        assert all(pl.registers.device == torch.device("cuda", 0)
                   for pl in sharded.planes)
    assert _dispatch_threads() <= before


def test_card_engine_raises_without_a_stream(fake_card, monkeypatch):
    """If the stream cannot be made the engine raises: no fallback to the
    thread (or the CPU)."""
    def no_stream():
        api = _api([], [])

        def stream(device):
            raise RuntimeError("no stream")
        return dispatch.CudaApi(stream, api.event, api.scope, api.current,
                                pin=False)

    monkeypatch.setattr(dispatch, "cuda_api", no_stream)
    before = _dispatch_threads()
    with pytest.raises(RuntimeError, match="no stream"):
        teng.SwitchEngine(CFG, async_dispatch=True, device="cuda:0")
    assert _dispatch_threads() <= before


def test_cpu_async_engine_keeps_the_thread():
    """``device="cpu"`` keeps the reference's dispatch thread."""
    eng = teng.SwitchEngine(CFG, async_dispatch=True, device="cpu")
    assert type(eng._queue) is dispatch.ThreadQueue
    (p, m), = _write_packets([3], 1)
    eng.execute_batch(p, m, mode="pallas", defer=True)
    assert eng.read_all()[3, 0] == 4
