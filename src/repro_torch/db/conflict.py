"""Contention-resilience layer: network-assisted early aborts + retry
discipline for the cold/warm 2PC path (PR 10).

Hot txns on the switch are abort-free (paper §5); the cold path still
discovers conflicts only at lock acquisition, after paying full round
trips.  Following Jepsen et al. ("Optimistic Aborts for Geo-distributed
Transactions", PAPERS.md), the network itself can see overlapping
read/write intent sets mid-flight and multicast aborts early.  This
module holds the whole layer:

``ConflictDetector``
    The "switch" observing in-flight cold/warm intent sets, registered
    at 2PC begin (``Cluster._run_with_retries`` / ``ContentionArena``).
    ``admit`` detects overlaps and names the loser, protocol-aware:
    under NO_WAIT any overlap kills the new registrant; under WAIT_DIE
    a *younger* registrant dies while an *older* one wounds the younger
    in-flight txn — the early-abort multicast reaches it mid-flight
    (possibly mid-2PC-prepare), so it releases its locks and retries
    before completing its doomed round trips.

``RetryPolicy``
    Seeded-deterministic exponential backoff with jitter and a per-txn
    deadline, replacing the bare ``for _ in range(max_retries)`` loop.
    Backoff is *virtual* on the functional layer (the arena converts it
    to ticks; the sequential cluster only uses the attempt budget) so
    runs stay reproducible.

``GAVE_UP``
    Falsy singleton distinguishing "exhausted its retries" from the
    ``None`` an undrained async slot holds in ``run_batch`` results.

``ContentionArena``
    Deterministic interleaved stepper that gives the functional cluster
    what its sequential ``run``/``run_batch`` loops cannot: genuinely
    concurrent cold/warm attempts contending on the 2PL lock tables,
    op-by-op in virtual ticks.  This is where early aborts, wounds,
    wasted-work accounting and tail latency are *measured* functionally;
    the DES (repro.sim) prices the same mechanism in seconds.

Early-aborted attempts that already logged ``write`` records (wound
landed mid-2PC-prepare) append an ``early_abort`` WAL record; node
recovery (``DBNode.recover_local``) cancels the attempt's prior write
records so an early-aborted attempt is provably never replayed — even
when a later attempt of the same tid commits.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from heapq import heappop, heappush
from typing import Dict, FrozenSet, Iterator, List, Optional, Tuple

from repro_torch.core.packets import ADD, ADDP, CADD, READ, WRITE
from repro_torch.db.txn import node_of

NO_WAIT, WAIT_DIE = "NO_WAIT", "WAIT_DIE"


class EarlyAbort(Exception):
    """An in-flight conflict resolved against this txn by the detector
    (before/instead of a lock-level ``Abort``)."""


class _GaveUp:
    """Falsy singleton: a txn that exhausted its retry budget.  Distinct
    from ``None`` (an undrained async result slot) so ``run_batch``
    callers can tell "dropped" from "not yet materialized"."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __bool__(self):
        return False

    def __repr__(self):
        return "GAVE_UP"

    def __reduce__(self):                      # pickle/deepcopy-safe
        return (_GaveUp, ())


GAVE_UP = _GaveUp()


# ------------------------------------------------------------ detector ----
@dataclass(frozen=True)
class Intent:
    """One in-flight txn's declared read/write key sets (2PC begin)."""
    tid: int
    ts: int
    reads: FrozenSet[int]
    writes: FrozenSet[int]

    def conflicts(self, other: "Intent") -> bool:
        return bool(self.writes & other.writes
                    or self.writes & other.reads
                    or self.reads & other.writes)


class ConflictDetector:
    """In-network view of in-flight cold/warm intent sets.

    ``admit`` registers a new intent and resolves overlaps the way the
    cold path's 2PL flavor would — but *before* the loser pays its round
    trips:

    * ``NO_WAIT``: any overlap → the new registrant loses (requester
      dies, matching the lock table's instant-abort rule);
    * ``WAIT_DIE``: a registrant younger than a conflicting in-flight
      intent dies; an older registrant is admitted and the younger
      in-flight txn is *wounded* — returned to the caller, which
      multicasts the early abort to it mid-flight.  (Retries keep their
      original timestamp, so a starving txn ages into priority — the
      classic no-livelock argument.)

    The caller may veto a wound (``woundable``: the victim already
    reached its commit decision) — the registrant then dies instead,
    exactly as if the conflict had surfaced at the lock table.
    """

    def __init__(self, protocol: str = NO_WAIT):
        self.protocol = protocol
        self.inflight: Dict[int, Intent] = {}
        self.stats = collections.Counter()

    def admit(self, tid: int, ts: int, reads, writes,
              woundable=None) -> Tuple[bool, List[Intent]]:
        """Register ``tid``'s intent.  Returns ``(admitted, wounded)``:
        ``admitted=False`` → the registrant is early-aborted (it was NOT
        registered); ``wounded`` lists in-flight intents the caller must
        abort mid-flight (already unregistered here)."""
        new = Intent(tid, ts, frozenset(reads), frozenset(writes))
        wounded: List[Intent] = []
        for other in list(self.inflight.values()):
            if not new.conflicts(other):
                continue
            self.stats["conflicts"] += 1
            if self.protocol == WAIT_DIE and new.ts < other.ts \
                    and (woundable is None or woundable(other)):
                # older registrant wounds the younger in-flight txn
                self.stats["wounds"] += 1
                del self.inflight[other.tid]
                wounded.append(other)
                continue
            self.stats["early_aborts"] += 1
            return False, wounded
        self.inflight[tid] = new
        return True, wounded

    def release(self, tid: int):
        """Unregister at commit/abort (the 2PC end of the window)."""
        self.inflight.pop(tid, None)

    def clear(self):
        self.inflight.clear()


# -------------------------------------------------------- retry policy ----
@dataclass(frozen=True)
class RetryPolicy:
    """Deterministic retry discipline for the cold/warm path.

    Exponential backoff ``base * multiplier**(k-1)`` (capped at ``cap``)
    with seeded multiplicative jitter in ``[1-jitter, 1+jitter]``; the
    jitter draw is a pure function of ``(seed, tid, attempt)`` so every
    run of the same workload schedules identically.  ``deadline`` bounds
    the *cumulative* virtual backoff a txn may accrue — a per-txn
    deadline, the knob an SLO actually sets — and ``max_retries`` bounds
    the attempt count.  Units are virtual (arena ticks / sim seconds /
    whatever the caller charges); the sequential cluster never sleeps.

    Protocol-awareness (``for_protocol``): WAIT_DIE retries keep their
    original timestamp and age into priority, so they back off gently
    (they cannot livelock); NO_WAIT losers carry no priority and rely on
    aggressive, decorrelated backoff to break symmetric retry storms.
    """
    max_retries: int = 10
    base: float = 1.0
    multiplier: float = 2.0
    cap: float = 64.0
    jitter: float = 0.5
    deadline: Optional[float] = None
    seed: int = 0

    @classmethod
    def for_protocol(cls, protocol: str, **kw) -> "RetryPolicy":
        if protocol == WAIT_DIE:
            kw.setdefault("multiplier", 1.5)
            kw.setdefault("jitter", 0.25)
        return cls(**kw)

    def _u(self, tid: int, attempt: int) -> float:
        # deterministic uniform in [0, 1): int/tuple hashing does not
        # depend on PYTHONHASHSEED (only str/bytes do)
        h = hash((self.seed, int(tid), int(attempt))) & 0xFFFFFFFF
        return h / 2.0**32

    def backoff(self, tid: int, attempt: int) -> float:
        """Virtual wait before retry ``attempt`` (attempt 2 is the first
        retry); always >= 0."""
        raw = min(self.cap, self.base * self.multiplier ** max(attempt - 2,
                                                               0))
        return raw * (1.0 - self.jitter + 2.0 * self.jitter
                      * self._u(tid, attempt))

    def schedule(self, tid: int) -> Iterator[Tuple[int, float]]:
        """Yield ``(attempt, wait_before)`` pairs: attempt 1 immediately,
        each retry after its backoff, stopping at ``max_retries`` or when
        cumulative backoff would blow the ``deadline``."""
        elapsed = 0.0
        for attempt in range(1, self.max_retries + 1):
            wait = 0.0 if attempt == 1 else self.backoff(tid, attempt)
            elapsed += wait
            if self.deadline is not None and attempt > 1 \
                    and elapsed > self.deadline:
                return
            yield attempt, wait


# ---------------------------------------------------------- arena ---------
@dataclass
class _Fiber:
    """One txn's execution state inside the arena."""
    idx: int
    txn: object
    kind: str = "cold"
    ts: int = 0
    attempt: int = 0
    t_admit: int = 0
    ops_done: int = 0
    wounded: bool = False
    woundable: bool = True
    logged_nodes: list = field(default_factory=list)
    result: object = None
    done: bool = False


@dataclass
class ArenaResult:
    """Outcome of one ``ContentionArena.run``: per-txn results in
    admission order (``GAVE_UP`` where the retry budget ran out), commit
    latencies in ticks, and the contention accounting the benchmark
    reports."""
    results: list
    latencies: List[int]               # commit latency per committed txn
    retries: Dict[int, int]            # tid -> attempts used
    committed: set                     # tids that committed
    gave_up: set                       # tids that exhausted retries
    wasted_ops: int = 0                # ops run by eventually-aborted attempts
    early_aborts: int = 0
    wounds: int = 0
    aborts: int = 0
    conflicts: int = 0
    ticks: int = 0

    def percentile(self, q: float) -> float:
        if not self.latencies:
            return 0.0
        lat = sorted(self.latencies)
        rank = min(len(lat) - 1, max(0, int(q * len(lat))))
        return float(lat[rank])


class ContentionArena:
    """Deterministic interleaved executor for cold/warm storms.

    The sequential ``Cluster`` admits one txn at a time, so separately
    admitted txns never actually contend; the arena drives many txn
    *fibers* against the same cluster one op per virtual tick, in a
    deterministic wake-ordered rotation — real 2PL conflicts, real
    wait/die decisions, real early aborts, with every run a pure
    function of (txns, policy, early_abort, cluster state).

    Per attempt a fiber: (1) registers its cold-part intent with the
    detector (early-abort on) — losing there costs ZERO executed ops;
    (2) EXECUTE: one (lock + compute) per tick, NO_WAIT aborting on any
    conflict, WAIT_DIE waiting while older / dying while younger;
    (3) PREPARE: one participant's ``write`` records logged per tick —
    the window where a wound lands mid-2PC-prepare and the ``early_abort``
    WAL record becomes load-bearing; (4) COMMIT: the point of no return
    (no longer woundable) — warm fibers dispatch their switch sub-txn,
    stores apply, ``commit`` records log, locks release.  Aborted
    attempts add their executed ops to the wasted-work account and
    reschedule after the policy's backoff (WAIT_DIE keeps the first
    attempt's timestamp so elders eventually win).

    Storm workloads are ADD-based read-modify-writes, so any legal
    serialization reaches the same final state — which is what lets the
    differential tests pin early-abort on vs off to identical committed
    state while only the abort/retry/wasted accounting differs.
    """

    def __init__(self, cluster, policy: Optional[RetryPolicy] = None,
                 early_abort: Optional[bool] = None):
        if cluster.async_hot:
            raise ValueError("ContentionArena needs a synchronous cluster "
                             "(async hot groups would reorder ticks)")
        self.c = cluster
        self.protocol = cluster.nodes[0].protocol
        on = cluster.early_abort if early_abort is None else early_abort
        self.detector = ConflictDetector(self.protocol) if on else None
        self.policy = policy or cluster.retry_policy \
            or RetryPolicy.for_protocol(self.protocol)
        self.now = 0
        self._seq = 0
        self._fibers: Dict[int, _Fiber] = {}     # tid -> fiber

    # ------------------------------------------------------------ driver --
    def run(self, txns, workers: Optional[int] = None) -> ArenaResult:
        """Drive ``txns`` to completion.  ``workers`` bounds concurrency
        closed-loop (a finishing fiber admits the next pending txn), the
        way a real worker pool does; ``None`` admits everything at tick
        0 — the maximum-contention configuration."""
        c = self.c
        res = ArenaResult(results=[None] * len(txns), latencies=[],
                          retries={}, committed=set(), gave_up=set())
        heap = []
        window = len(txns) if workers is None else min(workers, len(txns))
        pending = iter(list(enumerate(txns))[window:])
        for i, txn in enumerate(txns[:window]):
            fb = _Fiber(i, txn)
            self._fibers[txn.tid] = fb
            self._push(heap, 0, self._drive(fb, res))
        try:
            while heap:
                wake, _, g = heappop(heap)
                self.now = max(self.now + 1, wake)
                try:
                    delay = next(g)
                except StopIteration:
                    nxt = next(pending, None)
                    if nxt is not None:
                        i, txn = nxt
                        fb = _Fiber(i, txn)
                        self._fibers[txn.tid] = fb
                        self._push(heap, self.now + 1, self._drive(fb, res))
                    continue
                self._push(heap, self.now + max(int(delay), 1), g)
        except BaseException:
            # a simulated crash (or any error) must not leak arena locks:
            # every in-flight fiber's locks release, mirroring clients
            # dying with the connection
            self._release_survivors()
            raise
        res.ticks = self.now
        if self.detector is not None:
            res.early_aborts = self.detector.stats["early_aborts"]
            res.wounds = self.detector.stats["wounds"]
            res.conflicts = self.detector.stats["conflicts"]
        return res

    def _push(self, heap, wake, gen):
        self._seq += 1
        heappush(heap, (wake, self._seq, gen))

    def _release_survivors(self):
        for fb in self._fibers.values():
            if not fb.done:
                for n in self.c.nodes:
                    n.release_all(fb.txn.tid)
                if self.detector is not None:
                    self.detector.release(fb.txn.tid)

    # ------------------------------------------------------------- fiber --
    def _drive(self, fb: _Fiber, res: ArenaResult):
        c = self.c
        txn = fb.txn
        fb.kind = c.classify(txn)
        fb.t_admit = self.now
        if fb.kind == "hot":
            # abort-free switch txn: one dispatch, one tick — hot txns
            # never contend on the lock tables (the paper's point)
            c.stats["hot"] += 1
            fb.result = c._run_hot(txn)
            res.results[fb.idx] = fb.result
            res.committed.add(txn.tid)
            res.latencies.append(self.now - fb.t_admit + 1)
            res.retries[txn.tid] = 1
            fb.done = True
            yield 1
            return
        for attempt, wait in self.policy.schedule(txn.tid):
            if wait:
                yield max(int(round(wait)), 1)
            fb.attempt = attempt
            # WAIT_DIE keeps the FIRST attempt's timestamp (ages into
            # priority, no livelock); NO_WAIT draws fresh (no priority)
            if self.protocol != WAIT_DIE or fb.ts == 0:
                c._ts += 1
                fb.ts = c._ts
            fb.wounded = False
            fb.woundable = True
            ok = yield from self._attempt(fb, res)
            if ok:
                res.results[fb.idx] = fb.result
                res.committed.add(txn.tid)
                res.latencies.append(self.now - fb.t_admit)
                res.retries[txn.tid] = attempt
                self._observe_retries(fb.kind, attempt)
                fb.done = True
                return
        c.stats["gave_up"] += 1
        fb.result = GAVE_UP
        res.results[fb.idx] = GAVE_UP
        res.gave_up.add(txn.tid)
        res.retries[txn.tid] = fb.attempt
        self._observe_retries(fb.kind, fb.attempt)
        fb.done = True

    def _observe_retries(self, kind: str, attempts: int):
        c = self.c
        if c.metrics is not None:
            from repro_torch.obs.names import H_RETRIES
            c.metrics.histogram(
                H_RETRIES, help="attempts per finished txn", lo=1.0,
                hi=1024.0, klass=kind).observe(attempts)

    def _split(self, fb: _Fiber):
        """(cold ops with txn-op index, hot sub-txn or None)."""
        c, txn = self.c, fb.txn
        if fb.kind == "warm":
            hot_keys = {k for k in txn.keys() if c.hot_index.is_hot(k)}
        else:
            hot_keys = set()
        cold = [(i, op) for i, op in enumerate(txn.ops)
                if op[1] not in hot_keys]
        hot = [(i, op) for i, op in enumerate(txn.ops) if op[1] in hot_keys]
        return cold, hot

    def _attempt(self, fb: _Fiber, res: ArenaResult):
        from repro_torch.db.dbms import Abort     # circular at module import
        c = self.c
        txn = fb.txn
        det = self.detector
        c.stats[fb.kind] += 1
        cold_ops, hot_ops = self._split(fb)
        # ---- 2PC begin: register the intent set with the "switch" ----
        if det is not None:
            reads = {k for (_, (o, k, _)) in cold_ops if o == READ}
            writes = {k for (_, (o, k, _)) in cold_ops if o != READ}
            admitted, wounded = det.admit(
                txn.tid, fb.ts, reads, writes,
                woundable=lambda it: self._fibers[it.tid].woundable)
            for it in wounded:
                self._fibers[it.tid].wounded = True
            if not admitted:
                # early abort at begin: the doomed round trips (and their
                # wasted ops) never happen — one notify tick and retry
                c.stats["early_aborts"] += 1
                c.stats["aborts"] += 1
                res.aborts += 1
                self._log_early_abort(fb, [])
                yield 1
                return False
        fb.ops_done = 0
        fb.logged_nodes = []
        results = [0] * len(txn.ops)
        values: Dict[int, int] = {}
        abort_reason = None
        # -------------------------- EXECUTE: one op per tick ----------
        for i, (o, k, v) in cold_ops:
            while True:
                if fb.wounded:
                    yield from self._abort_cleanup(fb, res, notify=True)
                    return False
                n = c.nodes[node_of(k)]
                mode = "S" if o == READ else "X"
                try:
                    n.acquire(txn.tid, fb.ts, k, mode)
                    break
                except Abort:
                    if self.protocol == WAIT_DIE \
                            and self._older_than_owners(fb, n, k):
                        yield 1            # older waits, polls next tick
                        continue
                    abort_reason = "lock"
                    break
            if abort_reason:
                break
            cur = values.get(k, c.nodes[node_of(k)].store[k])
            if o == READ:
                results[i] = cur
            elif o == WRITE:
                values[k] = v
                results[i] = v
            elif o == ADD:
                values[k] = cur + v
                results[i] = values[k]
            elif o == ADDP:
                values[k] = cur + results[v]
                results[i] = values[k]
            elif o == CADD:
                if cur + v < 0:
                    abort_reason = "constraint"
                    break
                values[k] = cur + v
                results[i] = values[k]
            fb.ops_done += 1
            yield 1
        if abort_reason:
            yield from self._abort_cleanup(fb, res, notify=False)
            return False
        # ------------- PREPARE: log redo per participant, one/tick ----
        by_node: Dict[int, list] = {}
        for k, nv in values.items():
            by_node.setdefault(node_of(k), []).append((k, nv))
        for nid in sorted(by_node):
            if fb.wounded:
                # the early-abort multicast landed mid-2PC-prepare: some
                # participants already logged this attempt's write
                # records — the early_abort record cancels them
                yield from self._abort_cleanup(fb, res, notify=True)
                return False
            n = c.nodes[nid]
            c._fault("mid_2pc_prepare", tid=txn.tid, node=nid)
            for k, nv in by_node[nid]:
                n.log("write", txn.tid, key=k, old=n.store[k], new=nv)
            fb.logged_nodes.append(nid)
            yield 1
        # ------------------ COMMIT: the point of no return ------------
        fb.woundable = False
        if fb.kind == "warm" and hot_ops:
            hot_txn = type(txn)(txn.kind, [op for _, op in hot_ops],
                                txn.home, tid=txn.tid)
            hot_res = c._run_hot(hot_txn)
            for (i, _), r in zip(hot_ops, hot_res):
                results[i] = r
            yield 1
        for k, nv in values.items():
            c.nodes[node_of(k)].store[k] = nv
        participants = {node_of(k) for (_, (o, k, _)) in cold_ops}
        for p in sorted(participants):
            c.nodes[p].log("commit", txn.tid)
            c.nodes[p].release_all(txn.tid)
        if det is not None:
            det.release(txn.tid)
        c.stats["commits"] += 1
        if len(participants) > 1:
            c.stats["distributed"] += 1
        fb.result = results
        yield 1
        return True

    def _older_than_owners(self, fb: _Fiber, node, key) -> bool:
        """WAIT_DIE wait rule: wait iff older than every conflicting
        owner (deadlock-free: waits-for edges only point at younger
        txns, so no cycle can close)."""
        cur = node.locks.get(key)
        if cur is None:
            return True                        # freed meanwhile: retry
        _, owners = cur
        for tid in owners:
            if tid == fb.txn.tid:
                continue
            other = self._fibers.get(tid)
            if other is None or other.ts <= fb.ts:
                return False
        return True

    def _abort_cleanup(self, fb: _Fiber, res: ArenaResult, notify: bool):
        """Release locks, account wasted work, log the ``early_abort``
        record on every node that holds this attempt's write records
        (and the home node — the abort notification)."""
        c = self.c
        c.stats["aborts"] += 1
        res.aborts += 1
        c.stats["wasted_ops"] += fb.ops_done
        res.wasted_ops += fb.ops_done
        if notify:
            c.stats["early_aborts"] += 1
            self._log_early_abort(fb, fb.logged_nodes)
        for n in c.nodes:
            n.release_all(fb.txn.tid)
        if self.detector is not None:
            self.detector.release(fb.txn.tid)
        yield 1

    def _log_early_abort(self, fb: _Fiber, logged_nodes):
        """The early-abort multicast, made durable: every participant
        holding this attempt's ``write`` records logs ``early_abort`` so
        recovery cancels them (never replays the aborted attempt); the
        home node logs it regardless (the client-visible notification)."""
        c = self.c
        for nid in sorted(set(logged_nodes) | {fb.txn.home}):
            c.nodes[nid].log("early_abort", fb.txn.tid, attempt=fb.attempt)
