"""Where a switch engine's device calls run, and how its staging memory
is guarded (the port's counterpart of the dispatch thread in
``repro/core/engine.py:438-476``).

Every queue has one interface: ``submit(job, defer) -> (outputs,
handle)``, exactly one of them not None, where ``handle.result()`` waits
for the job and returns its outputs; ``join()`` waits for every job
submitted; ``put(x)`` copies a host int32 array to the engine's device
inside a job; ``host(*ts)`` starts a deferred job's device -> host
copies (a job the caller reads at once reads after its handle).

  InlineQueue  — the sync engine's: a job runs at once on the caller's
                 thread and current stream; its outputs come back.
  ThreadQueue  — the reference's single-worker thread with futures, kept
                 for ``device="cpu"``, where the tests hold it to the JAX
                 package.  One worker is FIFO, so the switch's admission
                 order holds.
  StreamQueue  — every async engine on a CUDA device: a job runs on the
                 caller's thread under the engine's own CUDA stream (a
                 launch returns at once; no thread, no hand-off), and an
                 event recorded after it is the handle.  Stream order is
                 FIFO, so a read or scan sees every earlier write without
                 a drain.  Staging is pinned (``PinnedStager``), each
                 staging slot guarded by the done event of the job that
                 copied from it; a deferred job's device -> host copies
                 land in pinned memory on the same stream, before that
                 event.

``make_queue`` picks one; on CUDA an async engine gets the stream queue
or an error, never the thread.  ``CudaApi`` holds the CUDA calls the
stream queue makes, so a CPU test can drive its bookkeeping with
stand-ins.

``stamp()`` records a timing event on the stream a queue's jobs run on
(the caller's current stream inline, the queue's own on a stream) and
returns it; None where there are no events (the CPU, the thread).  A
timed dispatch stamps before and at the end of its job.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.core.packets import N_PLANES, PacketStager


class InlineQueue:
    """The sync engine's queue: ``submit`` runs the job now."""

    def __init__(self, device: torch.device, depth: int,
                 api: CudaApi = None):
        self.device = device
        self.stager = PacketStager(pool=depth)
        if api is None and device.type == "cuda":
            api = cuda_api()
        self._api = api

    def submit(self, job, defer: bool):
        return job(), None

    def stamp(self):
        """A timing event recorded on the caller's current stream."""
        if self._api is None or self._api.timer is None:
            return None
        ev = self._api.timer()
        ev.record(self._api.current(self.device))
        return ev

    def join(self):
        pass

    def put(self, x: np.ndarray) -> torch.Tensor:
        # copy=True: the staging buffer is recycled, so the device tensor
        # must never alias host memory (on the CPU, .to() alone would)
        return torch.from_numpy(x).to(self.device, copy=True)

    @staticmethod
    def host(*ts: torch.Tensor):
        """The tensors themselves: their drain copies them (``.cpu()``)."""
        return ts

    def fence(self):
        """Nothing to order: jobs run on the caller's current stream."""


class ThreadQueue(InlineQueue):
    """The reference's single-worker dispatch thread with futures."""

    def __init__(self, device: torch.device, depth: int):
        super().__init__(device, depth)
        self._pool = None
        self._last = None
        self._deferred = collections.deque()   # submitted, not yet joined

    def submit(self, job, defer: bool):
        """Run ``job`` on the dispatch thread.  ``defer`` returns its
        future; otherwise the call blocks for its outputs.

        Backpressure: a staging buffer may only be recycled after the
        job reading it has executed, so outstanding deferred jobs are
        bounded to the stager pool depth — the oldest is joined before a
        submit that would overflow it."""
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="switch-dispatch")
        fut = self._pool.submit(job)
        self._last = fut
        if defer:
            self._deferred.append(fut)
            while len(self._deferred) > self.stager.pool - 2:
                self._deferred.popleft().result()
            return None, fut
        out = fut.result()      # FIFO worker: every earlier job is done
        self._deferred.clear()
        return out, None

    def join(self):
        """EVERY outstanding future is joined, so a failed dispatch
        re-raises here."""
        while self._deferred:
            self._deferred.popleft().result()
        if self._last is not None:
            fut, self._last = self._last, None
            fut.result()


@dataclass(frozen=True)
class CudaApi:
    """The CUDA calls of the stream queue and its stager."""
    stream: Callable[[torch.device], Any]     # a new stream on a device
    event: Callable[[], Any]                  # a new event
    scope: Callable[[Any], Any]               # makes a stream current
    current: Callable[[torch.device], Any]    # a device's current stream
    pin: bool = True                          # pinned host buffers
    timer: Callable[[], Any] = None           # a new event that keeps time


class OnStream:
    """A reusable context that makes ``stream`` its device's current
    stream, and puts back that device's stream and the current device
    on exit: ``torch.cuda.stream``'s effect in four C calls, for the
    one stream a queue owns."""

    def __init__(self, stream):
        self._ids = dict(stream_id=stream.stream_id,
                         device_index=stream.device_index,
                         device_type=stream.device_type)
        self._prev = self._dev = None

    def __enter__(self):
        self._dev = torch._C._cuda_getDevice()
        sid, dev, kind = torch._C._cuda_getCurrentStream(
            self._ids["device_index"])
        self._prev = dict(stream_id=sid, device_index=dev, device_type=kind)
        torch._C._cuda_setStream(**self._ids)

    def __exit__(self, *exc):
        torch._C._cuda_setStream(**self._prev)
        if self._dev != self._ids["device_index"]:
            torch._C._cuda_setDevice(self._dev)


_STREAMS: Dict[tuple, Any] = {}


def current_stream(device: torch.device):
    """``torch.cuda.current_stream(device)``, its ``Stream`` made once a
    stream: ``current_stream`` makes one a call (~10 us of host time on
    the H100's host, twice a timed sync dispatch)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = torch._C._cuda_getCurrentStream(index)
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return stream


def cuda_api() -> CudaApi:
    return CudaApi(stream=lambda d: torch.cuda.Stream(device=d),
                   event=torch.cuda.Event, scope=OnStream,
                   current=current_stream,
                   timer=lambda: torch.cuda.Event(enable_timing=True))


class _Slot:
    __slots__ = ("host", "view", "event")

    def __init__(self, shape, pin: bool):
        self.host = torch.empty(shape, dtype=torch.int32, pin_memory=pin)
        self.view = self.host.numpy()
        self.event = None       # recorded after the copy that reads it


class PinnedStager:
    """``PacketStager``'s API (``stage(p, idx, Bp, Mp) -> buf``) over
    pinned host memory, for the stream queue.

    Slots are recycled round-robin per shape, ``pool`` deep.  ``put``
    queues a non-blocking copy of a slot to the device on the current
    stream (the job's); ``guard(event)``, called by the queue with the
    event it records after the job, hands that event to every slot
    copied since; ``stage`` waits on a slot's event before it rewrites
    the slot.  So no slot is rewritten before the copy reading it has
    run, however many dispatches nobody waits for (a burst of WRITE-only
    loads, say), and no copy is ever synchronous."""

    def __init__(self, pool: int, device: torch.device, pin: bool = True):
        self.pool = max(int(pool), 2)
        self.device = device
        self.pin = pin
        self._rings: Dict[tuple, list] = {}
        self._next: Dict[tuple, int] = {}
        self._of: Dict[int, _Slot] = {}       # id(slot.view) -> slot
        self._copied = []                     # slots copied, not guarded

    def _take(self, shape) -> _Slot:
        key = tuple(shape)
        ring = self._rings.setdefault(key, [])
        i = self._next.get(key, 0)
        if len(ring) <= i:
            ring.append(_Slot(shape, self.pin))
            self._of[id(ring[i].view)] = ring[i]
        self._next[key] = (i + 1) % self.pool
        slot = ring[i]
        if slot.event is not None:     # its last copy must have run
            slot.event.synchronize()
            slot.event = None
        return slot

    def stage(self, p: Dict[str, np.ndarray], idx: np.ndarray,
              Bp: int, Mp: int) -> np.ndarray:
        """``PacketStager.stage`` into a pinned slot (its numpy view)."""
        B, K = np.asarray(p["op"]).shape
        buf = self._take((N_PLANES, Bp, K)).view
        for plane, f in enumerate(("op", "stage", "reg", "operand")):
            buf[plane, :B] = p[f]
            buf[plane, B:] = 0                    # pad rows are NOPs
        flat = buf[4].reshape(-1)
        flat[:len(idx)] = idx
        flat[len(idx):Mp] = 0                     # pad gathers hit slot 0
        return buf

    def put(self, x: np.ndarray) -> torch.Tensor:
        """``x`` on the device: a staged slot as it is, any other int32
        array through a slot of its shape first."""
        slot = self._of.get(id(x))
        if slot is None or slot.view is not x:
            slot = self._take(x.shape)
            slot.view[...] = x
        out = torch.empty(slot.host.shape, dtype=torch.int32,
                          device=self.device)
        out.copy_(slot.host, non_blocking=True)
        self._copied.append(slot)
        return out

    def guard(self, event):
        """``event``, recorded after every copy since the last guard,
        guards those copies' slots."""
        for slot in self._copied:
            slot.event = event
        self._copied.clear()


class _Done:
    """A stream job's outputs behind the event recorded after it: the
    stream queue's handle (a future's ``result`` / ``done``)."""

    __slots__ = ("event", "out")

    def __init__(self, event, out):
        self.event, self.out = event, out

    def result(self):
        self.event.synchronize()
        return self.out

    def done(self) -> bool:
        return self.event.query()


class StreamQueue:
    """An async engine's queue on a CUDA device: one stream of its own."""

    def __init__(self, device: torch.device, depth: int,
                 api: CudaApi = None):
        self.device = device
        self._api = api or cuda_api()
        self.stream = self._api.stream(device)
        self._scope = self._api.scope(self.stream)
        self.stager = PinnedStager(depth, device, self._api.pin)
        self._pending = collections.deque()    # done events, FIFO

    def submit(self, job, defer: bool):
        """Run ``job`` now under the stream and record its done event,
        which also guards the staging slots the job copied from.  The
        outputs are the handle's whether or not ``defer`` is set: a
        launch returns at once, and the host waits only where it reads.
        A job that raises (a launch error) raises here, at launch; its
        event then only guards its slots."""
        with self._scope:
            try:
                out = job()
            finally:
                done = self._api.event()
                done.record(self.stream)
                self.stager.guard(done)
        self._pending.append(done)
        if len(self._pending) > self.stager.pool:
            while len(self._pending) > 1 and self._pending[0].query():
                self._pending.popleft()
        return None, _Done(done, out)

    def join(self):
        """Wait on every outstanding done event; a device fault raises
        here."""
        while self._pending:
            self._pending[0].synchronize()
            self._pending.popleft()

    def put(self, x: np.ndarray) -> torch.Tensor:
        return self.stager.put(x)

    def stamp(self):
        """A timing event recorded on the queue's stream."""
        if self._api.timer is None:
            return None
        ev = self._api.timer()
        ev.record(self.stream)
        return ev

    def host(self, *ts: torch.Tensor):
        """Pinned host copies of ``ts``, queued on the current stream (the
        job's): readable once the job's done event has completed."""
        out = tuple(torch.empty(t.shape, dtype=t.dtype,
                                pin_memory=self._api.pin) for t in ts)
        for h, t in zip(out, ts):
            h.copy_(t, non_blocking=True)
        return out

    def fence(self):
        """Order the stream after the caller's current stream, where a
        new register file was just made."""
        ev = self._api.event()
        ev.record(self._api.current(self.device))
        self.stream.wait_event(ev)


def make_queue(device: torch.device, async_dispatch: bool, depth: int):
    """The sync engine's inline queue; an async engine's stream queue on a
    CUDA device (it raises if the stream cannot be made: never the
    thread), and the dispatch thread on the CPU."""
    if not async_dispatch:
        return InlineQueue(device, depth)
    if device.type == "cuda":
        return StreamQueue(device, depth)
    return ThreadQueue(device, depth)
