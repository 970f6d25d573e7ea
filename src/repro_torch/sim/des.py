"""Minimal discrete-event simulation core: generator coroutines + an event
heap.  Coroutines yield commands:

  ("delay", seconds)
  ("lock", SimLock, mode, ts)    -> resumes with True (granted) / False
                                    (denied; NO_WAIT or WAIT_DIE died)
  ("acquire", Resource)          -> resumes when a slot is free
  ("release", Resource)
  ("join", Batcher, item)        -> resumes when the item's batch has been
                                    serviced (gather/barrier)

Lock ownership is keyed by transaction timestamp (ts), so the model layer
can release locks synchronously without generator identity."""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple


class SimLock:
    """2PL lock with NO_WAIT or WAIT_DIE semantics, owners keyed by ts."""

    __slots__ = ("owners", "waiters", "policy")

    def __init__(self, policy: str = "NO_WAIT"):
        self.owners: Dict[int, str] = {}            # ts -> mode
        self.waiters: List[Tuple[object, str, int]] = []
        self.policy = policy

    def _mode(self) -> Optional[str]:
        if not self.owners:
            return None
        return "X" if "X" in self.owners.values() else "S"

    def try_acquire(self, ts: int, mode: str) -> Optional[bool]:
        """True granted, False denied, None -> wait."""
        if ts in self.owners:
            if mode == "X" and self.owners[ts] == "S" and len(self.owners) > 1:
                return False                         # upgrade conflict
            self.owners[ts] = "X" if "X" in (mode, self.owners[ts]) else "S"
            return True
        cur = self._mode()
        if cur is None or (cur == "S" and mode == "S"):
            self.owners[ts] = mode
            return True
        if self.policy == "NO_WAIT":
            return False
        return None if ts < min(self.owners) else False   # WAIT_DIE

    def release(self, ts: int, sim: "Sim"):
        self.owners.pop(ts, None)
        while self.waiters and not self.owners:
            gen, mode, wts = self.waiters[0]
            r = self.try_acquire(wts, mode)
            if r:
                self.waiters.pop(0)
                sim._resume(gen, True)
                if mode == "X":
                    break
            else:
                break


class Resource:
    """FIFO counted resource (e.g. switch pipeline locks)."""

    __slots__ = ("capacity", "used", "queue")

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.used = 0
        self.queue: List[object] = []


class Batcher:
    """Gather/barrier primitive: member coroutines yield
    ``("join", batcher, item)`` and are resumed together — in FIFO join
    order — once their batch has been serviced.

    The forming batch closes when ``max_batch`` members have joined, or
    ``window`` seconds after its FIRST member joined, whichever comes
    first.  ``window <= 0`` means greedy batching — no artificial gather
    delay: a join while a service slot is free dispatches immediately, and
    joins arriving while every slot is occupied accumulate and dispatch
    together the moment a slot frees up.  Closed batches are serviced in
    FIFO close order with up to ``depth`` batches in service concurrently
    (the pipelined discipline: the dispatcher assembles round k+1 while
    round k is still in flight).  ``depth=1`` — the default — serializes
    service exactly like the pre-pipelined Batcher, event for event.
    ``service(items)`` runs as its own coroutine (it may yield any Sim
    command), and when it returns, every member of that batch resumes
    with the service's return value.  With ``depth > 1`` a shorter round
    may overtake a longer in-flight one; members of one batch still
    resume together, in join order.  Backpressure is composed externally
    (e.g. a counted ``Resource`` bounding members in flight)."""

    __slots__ = ("sim", "service", "window", "max_batch", "depth",
                 "forming", "closed", "in_service", "_epoch")

    def __init__(self, sim: "Sim", service, window: float, max_batch: int,
                 depth: int = 1):
        self.sim = sim
        self.service = service
        self.window = window
        self.max_batch = max(1, int(max_batch))
        self.depth = max(1, int(depth))
        self.forming: List[Tuple[object, object]] = []   # [(gen, item)]
        self.closed: List[List[Tuple[object, object]]] = []
        self.in_service = 0      # batches currently in flight (<= depth)
        self._epoch = 0          # invalidates window timers of closed batches

    def join(self, gen, item):
        self.forming.append((gen, item))
        if len(self.forming) >= self.max_batch or \
                (self.window <= 0 and self.in_service < self.depth):
            self._close()
        elif len(self.forming) == 1 and self.window > 0:
            self.sim.spawn(self._timer(self._epoch))

    def _timer(self, epoch):
        yield ("delay", self.window)
        if epoch == self._epoch and self.forming:
            self._close()

    def _close(self):
        batch, self.forming = self.forming, []
        self._epoch += 1
        self.closed.append(batch)
        self._pump()

    def _pump(self):
        while self.in_service < self.depth and self.closed:
            self.in_service += 1
            self.sim.spawn(self._serve(self.closed.pop(0)))

    def _serve(self, batch):
        result = yield from self.service([item for _, item in batch])
        for gen, _ in batch:                 # FIFO: heap seq preserves order
            self.sim._resume(gen, result)
        self.in_service -= 1
        if self.window <= 0 and self.forming and not self.closed:
            self._close()                    # greedy: take what accumulated
        else:
            self._pump()


class Sim:
    def __init__(self):
        self.now = 0.0
        self._heap: List[Tuple[float, int, object, object]] = []
        self._seq = 0

    def spawn(self, gen, delay=0.0):
        self._push(delay, gen, None)

    def _push(self, delay, gen, value):
        heapq.heappush(self._heap, (self.now + delay, self._seq, gen, value))
        self._seq += 1

    def _resume(self, gen, value):
        self._push(0.0, gen, value)

    def run(self, until: float):
        while self._heap and self._heap[0][0] <= until:
            t, _, gen, value = heapq.heappop(self._heap)
            self.now = t
            self._step(gen, value)
        self.now = until

    def _step(self, gen, value):
        try:
            cmd = gen.send(value)
        except StopIteration:
            return
        kind = cmd[0]
        if kind == "delay":
            self._push(cmd[1], gen, None)
        elif kind == "lock":
            _, lock, mode, ts = cmd
            r = lock.try_acquire(ts, mode)
            if r is None:
                lock.waiters.append((gen, mode, ts))
            else:
                self._resume(gen, r)
        elif kind == "acquire":
            res = cmd[1]
            if res.used < res.capacity:
                res.used += 1
                self._resume(gen, True)
            else:
                res.queue.append(gen)
        elif kind == "release":
            res = cmd[1]
            if res.queue:
                # slot handoff: the freed slot passes straight to the head
                # waiter, so `used` stays constant (and <= capacity)
                g = res.queue.pop(0)
                self._resume(g, True)
            else:
                res.used -= 1
            self._resume(gen, None)
        elif kind == "join":
            _, batcher, item = cmd
            batcher.join(gen, item)
        else:
            raise ValueError(cmd)
