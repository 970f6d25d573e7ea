"""Shared-nothing host DBMS with the switch as an additional node (paper §6).

PyTorch port of ``repro/db/dbms.py``: the same cluster on the port's
``SwitchEngine`` (``ShardedSwitchEngine`` for ``n_switches > 1``), whose
register files live on ``Cluster(device=...)`` (``None`` -> ``cuda``,
which must exist).

Functional (value-level) execution used by tests, examples and recovery
benchmarks; contention timing lives in repro.sim.  Pieces:

  * per-node in-memory store + 2PL lock table (NO_WAIT / WAIT_DIE),
  * 2PC for distributed cold parts,
  * hot / cold / warm classification through the replicated hot index
    (vectorized over whole admission batches when no controller can
    swap the placement mid-batch),
  * per-txn hot path (``run``): one switch dispatch per hot txn, and the
    BATCHED hot path (``run_batch``): consecutive hot txns are grouped
    into ONE vectorized ``SwitchEngine.execute_batch`` dispatch —
    observationally identical to the per-txn loop (results, registers,
    GIDs, WAL recovery; proven in tests/test_batch.py), with groups
    split at multipass-ADDP ("unsafe") txns so safe runs stay on the
    vectorized engines (``_flush_hot_group``); the timing-sim analogue
    of this admission discipline (batched + pipelined switch rounds)
    lives in repro.sim.model,
  * ASYNC hot path (``async_hot=True``): dispatched groups stay on
    device as ``PendingBatch`` handles (bounded by ``max_inflight``),
    overlapping group k's execution with group k+1's packet build;
    client results and WAL ``switch_result`` entries fill lazily at
    ``drain()`` — invoked at every consistency point (warm txn,
    recovery, offload snapshot, migration) and byte-identical to the
    synchronous path (tests/test_hotpath.py),
  * warm protocol: cold sub-txn made abort-proof (locks acquired, constraints
    checked) BEFORE the switch sub-txn is sent; switch sub-txns count as
    committed on send (they cannot abort),
  * WAL per node: switch txns log intended ops before send, results + GID
    after the response; recovery rebuilds node state and — on switch failure
    — reconstructs switch registers from all logs, ordering by GID and
    gap-filling in-flight txns via read/write-set dependencies (paper §A.3).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.engine import (ShardedSwitchEngine, SwitchEngine,
                                     resolve_device)
from repro_torch.core.hotset import HotIndex
from repro_torch.core.packets import (ADD, ADDP, CADD, NOP, READ, WRITE,
                                SwitchConfig, addp_unsafe_rows,
                                build_packets, build_read_packets)
from repro_torch.db.conflict import (GAVE_UP, ConflictDetector, EarlyAbort,
                               RetryPolicy)
from repro_torch.db.faults import (Brownout, FaultPlan, SimulatedCrash,
                             SwitchUnavailable)
from repro_torch.db.txn import Txn, node_of
from repro_torch.db.wal import (DEFAULT_SEGMENT_SIZE, CheckpointStore,
                          SegmentedWAL)
from repro_torch.obs.names import (G_INFLIGHT, G_SHARD_DISPATCHES, G_WAL_RECORDS,
                             H_BATCH_SERVICE, H_DRAIN, H_READ_BATCH,
                             H_RETRIES, H_TXN_LATENCY, stat_metric)
from repro_torch.obs.registry import MetricsRegistry, StatsCounter
from repro_torch.obs.trace import Tracer

NO_WAIT, WAIT_DIE = "NO_WAIT", "WAIT_DIE"


def _span(tr, name):
    """Trace span or no-op: call sites stay branch-free when tracing is
    off or this txn wasn't sampled."""
    return tr.span(name) if tr is not None else contextlib.nullcontext()

# base tid for Cluster.load() fixture writes — disjoint from client txns
# and from migration tids (which use 1 << 40, see repro.db.migrate).  The
# counter is PER CLUSTER (not module-global) so two independently built
# clusters fed the same workload produce byte-identical WALs
_LOAD_TID_BASE = 1 << 41


class Abort(Exception):
    pass


@dataclass
class LogEntry:
    kind: str   # begin|write|switch_send|switch_result|commit|abort|
                # early_abort|ckpt
    tid: int
    payload: dict = field(default_factory=dict)


class DBNode:
    def __init__(self, node_id: int, protocol: str = NO_WAIT,
                 wal_mode: str = "segmented",
                 wal_segment_size: int = DEFAULT_SEGMENT_SIZE):
        self.id = node_id
        self.store: Dict[int, int] = collections.defaultdict(int)
        self.locks: Dict[int, Tuple[str, set]] = {}     # key -> (mode, owners)
        self.protocol = protocol
        # "segmented" (default): hash-chained SegmentedWAL with the same
        # list-like surface; "list": the legacy in-memory list, kept as the
        # identity-pin reference (tests assert byte-identical behavior)
        if wal_mode == "segmented":
            self.wal = SegmentedWAL(segment_size=wal_segment_size)
        elif wal_mode == "list":
            self.wal: List[LogEntry] = []
        else:
            raise ValueError(f"unknown wal_mode {wal_mode!r}")
        self.ts = 0
        self.hot_index = None     # replicated copy, swapped by migrations

    # ---------------------------------------------------------- locking --
    def acquire(self, tid: int, ts: int, key: int, mode: str):
        cur = self.locks.get(key)
        if cur is None:
            self.locks[key] = (mode, {tid})
            return
        cmode, owners = cur
        if tid in owners:
            if mode == "X" and cmode == "S" and len(owners) == 1:
                self.locks[key] = ("X", owners)
            elif mode == "X" and cmode == "S":
                raise Abort(f"upgrade conflict on {key}")
            return
        if cmode == "S" and mode == "S":
            owners.add(tid)
            return
        # conflict: NO_WAIT aborts instantly; WAIT_DIE aborts younger
        # requesters (the functional layer has no real waiting — a txn that
        # *would* wait is retried by the caller, matching the sim's model)
        raise Abort(f"lock conflict on {key}")

    def release_all(self, tid: int):
        for key in list(self.locks):
            mode, owners = self.locks[key]
            owners.discard(tid)
            if not owners:
                del self.locks[key]

    # -------------------------------------------------------------- wal --
    def log(self, kind, tid, **payload):
        # tests legitimately replace node.wal with a filtered plain list
        # (simulating lost records) — keep accepting both representations
        if isinstance(self.wal, SegmentedWAL):
            self.wal.append(kind, tid, payload)
        else:
            self.wal.append(LogEntry(kind, tid, payload))

    def crash(self):
        """Lose volatile state; keep the WAL (stable storage)."""
        self.store = collections.defaultdict(int)
        self.locks = {}

    def recover_local(self):
        committed = {e.tid for e in self.wal if e.kind == "commit"}
        # switch sub-txns count as committed once sent (paper §6.1)
        committed |= {e.tid for e in self.wal if e.kind == "switch_send"}
        surviving = []
        for e in self.wal:
            if e.kind == "write":
                surviving.append(e)
            elif e.kind == "early_abort":
                # the early-abort multicast cancels every write record
                # the aborted attempt logged (a wound can land mid-2PC-
                # prepare, after redo records hit the log): even when a
                # LATER attempt of the same tid commits, recovery must
                # never replay the aborted attempt's writes.  With no
                # early_abort records this walk replays exactly the
                # original committed-writes-in-log-order sequence.
                surviving = [w for w in surviving if w.tid != e.tid]
        for e in surviving:
            if e.tid in committed:
                self.store[e.payload["key"]] = e.payload["new"]


class LazyResults:
    """List-like view over one ``run_batch`` call's results — the client
    half of the lazy result plane.  The underlying list is filled in by
    ``Cluster.drain()``; reading any entry (indexing, iteration,
    comparison) drains the cluster's outstanding hot groups first, so a
    caller can fire many async batches back-to-back and only pay the
    device sync when a result is actually consumed."""

    __slots__ = ("_cluster", "_values")

    def __init__(self, cluster: "Cluster", values: list):
        self._cluster = cluster
        self._values = values

    def _force(self) -> list:
        self._cluster.drain()
        return self._values

    def __len__(self):
        return len(self._values)

    def __getitem__(self, i):
        return self._force()[i]

    def __iter__(self):
        return iter(self._force())

    def __eq__(self, other):
        if isinstance(other, LazyResults):
            other = other._force()
        return self._force() == other

    def __repr__(self):
        return repr(self._force())


class Cluster:
    """Functional P4DB cluster: nodes + switch + hot index.

    ``async_hot=True`` turns on the asynchronous device-resident hot
    path: ``run_batch`` dispatches each hot group to the switch engine
    and keeps building/dispatching subsequent groups while earlier ones
    are still in flight on device (bounded by ``max_inflight`` — 2 =
    double-buffered).  Hot txns are abort-free commit-on-send, so WAL
    ``switch_send`` entries (and commit stats) are logged at dispatch;
    ``switch_result`` entries and client results are filled lazily by
    ``drain()``, which runs at every consistency point: a warm txn
    touching a hot key, ``crash_switch_and_recover``,
    ``snapshot_offload``, and epoch migration.  With ``async_hot=False``
    (the default) every group materializes before the next one builds —
    the synchronous reference path the async mode is pinned
    byte-identical against (tests/test_hotpath.py)."""

    def __init__(self, n_nodes: int, switch_cfg: SwitchConfig,
                 hot_index: Optional[HotIndex] = None,
                 protocol: str = NO_WAIT, use_switch: bool = True,
                 switch_mode: str = "auto", async_hot: bool = False,
                 max_inflight: int = 2, wal_mode: str = "segmented",
                 wal_segment_size: int = DEFAULT_SEGMENT_SIZE,
                 checkpoint_interval: int = 0, standby: bool = False,
                 fault_plan: Optional[FaultPlan] = None,
                 telemetry: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 early_abort: bool = False,
                 retry_policy: Optional[RetryPolicy] = None,
                 device=None):
        self.nodes = [DBNode(i, protocol, wal_mode=wal_mode,
                             wal_segment_size=wal_segment_size)
                      for i in range(n_nodes)]
        self.switch_cfg = switch_cfg
        self.device = resolve_device(device)
        self.async_hot = async_hot
        self.max_inflight = max(int(max_inflight), 1)
        self.switch = self._fresh_engine()
        self.hot_index = hot_index          # setter replicates to nodes
        self.use_switch = use_switch and hot_index is not None
        self.switch_mode = switch_mode
        self._ts = 0
        # telemetry plane (repro.obs): on by default, pinned zero-cost —
        # the registry/tracer never touch engine state, RNG or WALs, so
        # results/registers/logs are byte-identical with telemetry off
        # (tests/test_serve.py pin row 10).  ``stats`` stays a
        # collections.Counter (subclass) either way: every legacy key keeps
        # working, writes additionally mirror into canonical registry
        # counters (repro.obs.names.STAT_NAMES).
        if telemetry:
            self.metrics = registry if registry is not None \
                else MetricsRegistry()
            self.tracer = tracer if tracer is not None else Tracer()
            self.stats: collections.Counter = StatsCounter(self.metrics,
                                                           stat_metric)
        else:
            self.metrics = None
            self.tracer = None
            self.stats = collections.Counter()
        self._inflight: List[tuple] = []    # FIFO of undrained hot groups
        # adaptive hot-set management (repro.core.heat / repro.db.migrate):
        # both stay None unless an EpochController attaches — every hot/cold
        # path below is byte-identical to a plain cluster in that case
        self.tracker = None
        self.controller = None
        self._load_tid = itertools.count(_LOAD_TID_BASE)
        # durability: diff-only checkpoints + (optional) interval trigger,
        # warm standby, armed fault plan.  checkpoint_interval = N > 0
        # takes a checkpoint every N switch sends; 0 = only explicit
        # checkpoints (snapshot_offload, migration boundaries)
        self.ckpts = CheckpointStore()
        self.checkpoint_interval = int(checkpoint_interval)
        self.fault_plan = fault_plan
        self._sends_since_ckpt = 0
        self._switch_down = False
        self._mid_migration_evicted: set = set()
        self._standby = self._fresh_engine() if standby else None
        # contention-resilience plane (repro.db.conflict): the detector
        # observes cold/warm intent sets at 2PC begin and early-aborts
        # losers.  Default-off; on the strictly sequential run/run_batch
        # paths it is registered but can never see an overlap, so results
        # stay byte-identical (pinned by the differential tests) — the
        # interleaved plane (ContentionArena) is where it fires.
        self.early_abort = bool(early_abort)
        self.detector = ConflictDetector(protocol) if early_abort else None
        self.retry_policy = retry_policy
        # switch brown-out (db.faults.Brownout: slow/lossy, not dead) —
        # hot admissions demote to the cold path against home-store-
        # authoritative values, bounded by the demotion budget
        self._brownout = False
        self._brownout_cap: Optional[int] = None
        self._brownout_served = 0
        self._brownout_evicted: set = set()
        self._brownout_tid = itertools.count(1 << 42)

    # ------------------------------------------------------------ setup --
    def _fresh_engine(self):
        """One source of truth for engine construction (initial setup AND
        post-crash recovery): the staging-buffer pool must outlast the
        in-flight window (+1 for the group being staged, +1 slack for the
        warm synchronous path).  A multi-switch config gets the sharded
        register plane; single-switch configs keep the plain engine (the
        byte-identity reference the sharded N=1 path is pinned against).
        Every engine lives on the cluster's device."""
        cls = ShardedSwitchEngine if self.switch_cfg.n_switches > 1 \
            else SwitchEngine
        return cls(self.switch_cfg,
                   stager_pool=self.max_inflight + 2,
                   async_dispatch=self.async_hot,
                   device=self.device)

    @property
    def hot_index(self):
        return self._hot_index

    @hot_index.setter
    def hot_index(self, hi):
        """One assignment swaps the coordinator copy AND every node's
        replica — classification (which reads the home node's replica)
        and packet building (which reads the coordinator copy) can never
        observe different placements, no matter who re-places."""
        self._hot_index = hi
        for n in self.nodes:
            n.hot_index = hi

    def load(self, key: int, value: int):
        """Seed one tuple's committed value (initial population, test
        fixtures) as a REAL logged write, not a bare register poke: the
        home node logs write+commit, and a hot key additionally routes
        through a switch dispatch with send/result WAL entries — so
        recovery replay, the checkpoint chain and the warm standby all
        observe the load.  (A direct ``registers.at[].set`` left the
        standby blind: load-then-``fail_over()`` recovered the stale
        pre-load value.)"""
        self.drain()      # register write: settle in-flight work first
        tid = next(self._load_tid)
        node = self.nodes[node_of(key)]
        node.log("write", tid, key=key, old=node.store[key], new=value)
        node.store[key] = value
        node.log("commit", tid)
        if self.use_switch and self.hot_index.is_hot(key):
            txn = Txn("load", [(WRITE, key, value)], node_of(key), tid=tid)
            pkt, meta = build_packets([txn], self.hot_index, self.switch_cfg)
            node.log("switch_send", tid, ops=list(txn.ops))
            pb = self.switch.execute_batch(pkt, meta, mode=self.switch_mode)
            node.log("switch_result", tid, gid=int(pb.gids[0]),
                     results=pb.results_np()[0, :1].tolist())
            self._note_sends(1)

    def classify(self, txn: Txn) -> str:
        if not self.use_switch:
            return "cold"
        trace = [(k, o) for o, k, _ in txn.ops]
        # the home node's REPLICA of the index does the classification
        # (paper §6.1: each node's partition manager holds a copy) — this
        # is what makes the migration's per-node swap load-bearing
        hi = self.nodes[txn.home].hot_index
        kind = hi.classify(trace)
        if kind != "cold" and self._brownout:
            # brown-out: the switch is degraded, not dead — register
            # values were evicted to their home stores (authoritative),
            # so hot admissions DEMOTE to the cold path and keep
            # committing, bounded by the demotion budget; past it the
            # cluster sheds load instead of queueing without bound
            # (mirrors PR 6's partial-availability semantics)
            if self._brownout_cap is not None \
                    and self._brownout_served >= self._brownout_cap:
                raise SwitchUnavailable(
                    f"brown-out demotion budget "
                    f"({self._brownout_cap}) exhausted: txn {txn.tid} "
                    f"shed (exit_brownout() to restore hot service)")
            self._brownout_served += 1
            self.stats["demoted_brownout"] += 1
            return "cold"
        if kind != "cold" and self._switch_down:
            # partial availability: a crash mid-migration leaves evicted
            # keys authoritative in their home-node stores — txns touching
            # ONLY those hot keys demote to the cold path and keep
            # committing; anything needing a live register must wait for
            # recovery/failover
            hot_keys = [k for k, _ in trace if hi.is_hot(k)]
            if hot_keys and all(k in self._mid_migration_evicted
                                for k in hot_keys):
                return "cold"
            raise SwitchUnavailable(
                f"switch down: txn {txn.tid} needs live registers "
                f"(recover_switch() or fail_over() first)")
        return kind

    def _classify_batch(self, txns: List[Txn]) -> List[str]:
        """Vectorized hot/warm/cold classification for a whole admission
        batch: one ``searchsorted`` over every accessed key instead of
        per-key dict probes.  Only valid when no controller is attached —
        the placement then cannot change mid-batch, and every node's
        replica is the same index object the setter fanned out."""
        B = len(txns)
        if not self.use_switch:
            return ["cold"] * B
        if self._switch_down or self._brownout:
            # availability-aware slow path (raises SwitchUnavailable for
            # txns that need live registers, demotes evicted-only and
            # brown-out txns under the budget)
            return [self.classify(t) for t in txns]
        n_ops = np.fromiter((len(t.ops) for t in txns), np.int64, B)
        keys = np.concatenate([t.ops_np for t in txns])[:, 1] if B \
            else np.zeros(0, np.int64)
        hot = self.hot_index.hot_mask_np(keys)
        rows = np.repeat(np.arange(B), n_ops)
        hits = np.bincount(rows, hot, minlength=B)
        all_hot = hits == n_ops          # vacuously hot for 0-op txns,
        any_hot = hits > 0               # matching HotIndex.classify
        return ["hot" if a else "warm" if w else "cold"
                for a, w in zip(all_hot, any_hot)]

    # ---------------------------------------------- adaptive hot-set mgmt --
    def _observe(self, txn: Txn):
        """Feed the heat tracker (when attached); returns True when the
        epoch controller is due — the caller drains in-flight hot groups
        and then calls ``controller.reconfigure()``."""
        if self.tracker is not None:
            self.tracker.observe_trace([(k, o) for o, k, _ in txn.ops])
        return self.controller is not None and self.controller.note()

    # -------------------------------------------------------- execution --
    def run(self, txn: Txn, max_retries: int = 10):
        t0 = time.perf_counter() if self.metrics is not None else 0.0
        tr = self.tracer.start(f"txn:{txn.kind}") \
            if self.tracer is not None else None
        if self._inflight:
            self.drain()                    # per-txn path: always drained
        if self._observe(txn):
            self.controller.reconfigure()
        with _span(tr, "classify"):
            kind = self.classify(txn)
        if kind == "hot":                 # switch txns are abort-free (§5)
            # "hot" counts ADMISSIONS, exactly once per hot txn — here on
            # the per-txn path, in run_batch on the batch path; never both
            # for one txn (run_batch never calls run).  _run_hot must NOT
            # bump it: warm txns call _run_hot for their switch sub-txn,
            # which is not a hot admission.  Audited + pinned in
            # tests/test_dbms.py::test_hot_counter_semantics.
            self.stats["hot"] += 1
            out = self._run_hot(txn, tr=tr)
        else:
            out = self._run_with_retries(txn, kind, max_retries)
        if self.metrics is not None:
            self.metrics.histogram(
                H_TXN_LATENCY, help="admission-to-result txn latency",
                klass=kind).observe(time.perf_counter() - t0)
        return out

    def _validate_mode(self, flags: dict):
        """Reject an explicit switch_mode the packets cannot run under
        BEFORE any switch_send is logged — a send entry counts as committed
        in recovery, so it must never precede a refused dispatch."""
        if self.switch_mode != "auto":
            SwitchEngine._resolve_mode(self.switch_mode, flags["has_cadd"],
                                       flags["has_addp"],
                                       flags["addp_unsafe"])

    # hot: switch-only, abort-free, no coordination (paper §5)
    def _run_hot(self, txn: Txn, tr=None):
        home = self.nodes[txn.home]
        with _span(tr, "packet-build"):
            pkt, meta = build_packets([txn], self.hot_index, self.switch_cfg)
        self._validate_mode(meta)
        home.log("switch_send", txn.tid, ops=list(txn.ops))
        with _span(tr, "dispatch"):
            pb = self.switch.execute_batch(pkt, meta, mode=self.switch_mode)
        with _span(tr, "drain"):
            res = pb.results_np()
        home.log("switch_result", txn.tid, gid=int(pb.gids[0]),
                 results=res[0, :len(txn.ops)].tolist())
        self.stats["commits"] += 1
        if pkt["is_multipass"][0]:
            self.stats["multipass"] += 1
        order = meta["order"]
        out = [0] * len(txn.ops)
        for slot in range(len(txn.ops)):
            out[order[0, slot]] = int(res[0, slot])
        self._note_sends(1)
        return out

    # ------------------------------------------------- batched execution --
    def run_batch(self, txns: List[Txn], max_retries: int = 10):
        """Execute a batch of transactions with the grouped switch hot path.

        Semantics are identical to ``[self.run(t) for t in txns]``: txns
        are processed in admission order, and since the switch serializes a
        packet batch in batch order (paper §5.1), executing a *run* of
        consecutive hot txns as one ``execute_batch`` dispatch commits them
        in exactly the order the per-txn loop would — same results, same
        register state, same GIDs.  The pending hot group is flushed before
        any warm txn (whose switch sub-txn must see prior hot effects and
        claim the next GID); cold txns touch no hot key, so they commute
        with the buffered group and run inline.  WAL entries are batched:
        all ``switch_send`` records for a group are logged before the one
        dispatch, all ``switch_result`` records after it.  Note this
        widens the in-flight window recovery can observe: a crash between
        the send loop and the result loop leaves the whole group as
        unknown-GID entries, which ``crash_switch_and_recover`` replays in
        an arbitrary order — legal, because no client received a result
        for any of them, so any serialization of in-flight txns is
        recoverable (paper §A.3); but unlike the per-txn loop the replayed
        registers may then differ from the pre-crash state.

        One divergence: under an *explicit* ``switch_mode``, a group is
        validated (and rejected) as a unit before any send is logged,
        whereas the per-txn loop would commit the compatible prefix before
        raising on the first incompatible txn.  ``auto`` mode never
        rejects, so the equivalence contract is unconditional there.

        Returns the per-txn result lists in admission order.  A txn that
        exhausted its retries holds the falsy ``GAVE_UP`` sentinel —
        distinct from ``None``, which on the async path marks a hot slot
        whose group has not yet been drained."""
        t0 = time.perf_counter() if self.metrics is not None else 0.0
        tr = self.tracer.start(f"batch:{len(txns)}") \
            if self.tracer is not None else None
        results: List[Optional[list]] = [None] * len(txns)
        pending: List[Tuple[int, Txn]] = []
        # without a controller the placement is frozen for the whole batch
        # -> classify every txn with one vectorized index lookup up front
        with _span(tr, "classify"):
            kinds = self._classify_batch(txns) if self.controller is None \
                else None
        for i, txn in enumerate(txns):
            if self._observe(txn):
                # drain in-flight hot groups BEFORE the migration touches
                # the registers or swaps the index (protocol step 1);
                # migrate() itself drains the async result plane
                self._flush_hot_group(pending, results, tr=tr)
                self.controller.reconfigure()
            kind = kinds[i] if kinds is not None else self.classify(txn)
            if kind == "hot":
                # batch-path twin of the run() admission count: once per
                # hot txn at admission (see the run() comment + the pin in
                # tests/test_dbms.py::test_hot_counter_semantics)
                self.stats["hot"] += 1
                pending.append((i, txn))
                continue
            if kind == "warm":
                # a warm txn touches hot keys: dispatch the buffered group
                # AND sync every outstanding handle (consistency point)
                self._flush_hot_group(pending, results, tr=tr)
                self.drain()
            results[i] = self._run_with_retries(txn, kind, max_retries)
        self._flush_hot_group(pending, results, tr=tr)
        if self.metrics is not None:
            # admission -> dispatch for the async path (results still lazy
            # on device); admission -> materialized for the sync path
            self.metrics.histogram(
                H_BATCH_SERVICE, help="run_batch service time").observe(
                    time.perf_counter() - t0)
        if self.async_hot:
            return LazyResults(self, results)
        return results

    def _run_with_retries(self, txn: Txn, kind: str, max_retries: int):
        """Cold/warm execution under the retry policy.  Attempts are
        budgeted by ``self.retry_policy`` — or, when none is set, a
        default ``RetryPolicy(max_retries=max_retries)`` whose schedule
        is attempt-for-attempt the legacy bare loop (backoff is virtual;
        the sequential cluster never sleeps).  Exhaustion returns the
        falsy ``GAVE_UP`` sentinel (NOT ``None`` — ``None`` is an
        undrained async slot) after one ``gave_up`` bump.  Per-class
        attempt counts land in the ``txn_retries`` histogram; ops burnt
        by eventually-aborted attempts in ``stats["wasted_ops"]``."""
        fn = self._run_cold if kind == "cold" else self._run_warm
        policy = self.retry_policy if self.retry_policy is not None \
            else RetryPolicy(max_retries=max_retries)
        det = self.detector
        attempts = 0
        for attempt, _wait in policy.schedule(txn.tid):
            attempts = attempt
            self.stats[kind] += 1
            if det is not None:
                # 2PC begin: declare the cold-part intent set to the
                # "switch".  The sequential paths run one txn at a time,
                # so no overlap can exist here (results stay pinned
                # byte-identical with the knob off); overlaps — and
                # early aborts — happen on the interleaved plane
                # (repro.db.conflict.ContentionArena).
                reads, writes = self._intent_sets(txn, kind)
                admitted, _ = det.admit(txn.tid, txn.tid, reads, writes)
                if not admitted:
                    self.stats["early_aborts"] += 1
                    self.stats["aborts"] += 1
                    self.nodes[txn.home].log("early_abort", txn.tid,
                                             attempt=attempt)
                    continue
            try:
                out = fn(txn)
                if det is not None:
                    det.release(txn.tid)
                self._observe_retries(kind, attempts)
                return out
            except (Abort, EarlyAbort):
                self.stats["aborts"] += 1
                for n in self.nodes:
                    n.release_all(txn.tid)
                if det is not None:
                    det.release(txn.tid)
            except Exception:
                # non-Abort failures (e.g. a rejected explicit switch_mode)
                # must not leak this txn's locks while propagating
                for n in self.nodes:
                    n.release_all(txn.tid)
                if det is not None:
                    det.release(txn.tid)
                raise
        self.stats["gave_up"] += 1
        self._observe_retries(kind, attempts)
        return GAVE_UP

    def _intent_sets(self, txn: Txn, kind: str):
        """Cold-part read/write key sets declared to the conflict
        detector at 2PC begin.  Warm txns declare only their cold part:
        the switch sub-txn is abort-free and never takes locks."""
        reads, writes = set(), set()
        for o, k, _ in txn.ops:
            if kind == "warm" and self.hot_index.is_hot(k):
                continue
            (reads if o == READ else writes).add(k)
        return reads, writes

    def _observe_retries(self, kind: str, attempts: int):
        """Per-class retry-count histogram (obs registry): how many
        attempts each finished (committed or gave-up) txn used."""
        if self.metrics is not None and attempts:
            self.metrics.histogram(
                H_RETRIES, help="attempts per finished txn", lo=1.0,
                hi=1024.0, klass=kind).observe(attempts)

    def _flush_hot_group(self, pending: List[Tuple[int, Txn]],
                         results: List[Optional[list]], tr=None):
        """Commit all buffered hot txns in as few switch dispatches as the
        engine allows.  Under ``auto`` mode a single multipass-ADDP
        ("unsafe") txn would demote the whole group to the serial engine
        (``_resolve_mode``); instead the group is split at unsafe txns —
        contiguous safe runs stay on the vectorized path, unsafe runs take
        the serial path — with sub-groups dispatched in admission order,
        so results, register state and GIDs are unchanged.  Explicit modes
        keep the single-dispatch, validate-as-a-unit contract."""
        if not pending:
            return
        pkts, meta = build_packets([t for _, t in pending], self.hot_index,
                                   self.switch_cfg)
        if self.switch_mode == "auto" and meta["addp_unsafe"] \
                and len(pending) > 1:
            unsafe = addp_unsafe_rows(pkts)
            lo = 0
            for hi in range(1, len(pending) + 1):
                if hi == len(pending) or unsafe[hi] != unsafe[lo]:
                    self._dispatch_hot_group(pending[lo:hi], results, tr=tr)
                    lo = hi
        else:
            self._dispatch_hot_group(pending, results, prebuilt=(pkts, meta),
                                     tr=tr)
        pending.clear()

    def _dispatch_hot_group(self, pending: List[Tuple[int, Txn]],
                            results: List[Optional[list]], prebuilt=None,
                            tr=None):
        """Commit one contiguous run of hot txns in ONE switch dispatch.

        Hot txns are abort-free commit-on-send (PR 2), so ``switch_send``
        WAL entries and commit/multipass stats are final at dispatch.
        The synchronous path then materializes results inline (the PR 1
        reference behavior); the async path parks the ``PendingBatch``
        handle on the in-flight queue — ``switch_result`` entries and
        client results are filled by ``drain()`` — and immediately
        returns to admission, overlapping the NEXT group's packet build
        with this group's device execution."""
        group = [t for _, t in pending]
        with _span(tr, "packet-build"):
            pkts, meta = prebuilt or build_packets(group, self.hot_index,
                                                   self.switch_cfg)
        self._validate_mode(meta)
        for t in group:
            # list(t.ops): ops tuples are immutable, no need to repack
            self.nodes[t.home].log("switch_send", t.tid, ops=list(t.ops))
        # Fig-9 window: sends are logged (committed-on-send) but the device
        # has not executed — a crash here leaves the whole group as
        # unknown-GID entries that recovery must replay
        self._fault("mid_group_dispatch", tids=[t.tid for t in group])
        with _span(tr, "dispatch"):
            if self.async_hot:
                pb = self.switch.execute_batch(pkts, meta,
                                               mode=self.switch_mode,
                                               defer=True)
            else:
                # 3-arg call kept for monkeypatch/spy compatibility
                pb = self.switch.execute_batch(pkts, meta,
                                               mode=self.switch_mode)
        multipass = int(np.count_nonzero(pkts["is_multipass"][:len(group)]))
        self.stats["commits"] += len(group)
        if multipass:
            self.stats["multipass"] += multipass
        if not self.async_hot:
            self._drain_group(pb, list(pending), meta, results, tr)
            # crash AFTER the group fully drained: the armed plan may tear
            # the unsynced tail off a node's open WAL segment
            self._fault("torn_tail", tids=[t.tid for t in group])
            self._note_sends(len(group))
            return
        self._inflight.append((pb, list(pending), meta, results, tr))
        if self.metrics is not None:
            self.metrics.gauge(G_INFLIGHT,
                               help="undrained async hot groups").set(
                                   len(self._inflight))
        # crash with undrained handles parked: device work may have run but
        # no response reached any host — result records are lost
        self._fault("undrained_async", inflight=len(self._inflight))
        while len(self._inflight) > self.max_inflight:
            self._drain_group(*self._inflight.pop(0))
        self._fault("torn_tail", tids=[t.tid for t in group])
        self._note_sends(len(group))

    # ---------------------------------------------- lazy result plane --
    def drain(self):
        """Barrier: materialize every outstanding hot group, in dispatch
        order — fills client results and WAL ``switch_result`` entries.
        A no-op on the synchronous path (nothing is ever outstanding)."""
        if not self._inflight:
            return
        t0 = time.perf_counter() if self.metrics is not None else 0.0
        while self._inflight:
            self._drain_group(*self._inflight.pop(0))
        if self.metrics is not None:
            self.metrics.gauge(G_INFLIGHT).set(0)
            self.metrics.histogram(
                H_DRAIN, help="drain barrier duration").observe(
                    time.perf_counter() - t0)

    def _drain_group(self, pb, pending: List[Tuple[int, Txn]], meta,
                     results: List[Optional[list]], tr=None):
        """Materialize one group's result plane (compact D2H transfer)
        and scatter it back to clients + WALs, vectorized: one
        ``put_along_axis`` un-permutes all packet slots to txn op order
        instead of a per-op Python loop."""
        with _span(tr, "drain"):
            res = pb.results_np()                   # [B, K] host plane
        B, K = res.shape
        order = meta["order"]
        n_ops = meta["n_ops"]
        valid = np.arange(K)[None, :] < np.asarray(n_ops)[:, None]
        # pad slots scatter into a sacrificial extra column
        outs = np.zeros((B, K + 1), res.dtype)
        np.put_along_axis(outs, np.where(valid, order, K), res, axis=1)
        for b, (i, t) in enumerate(pending):
            n = len(t.ops)
            self.nodes[t.home].log("switch_result", t.tid,
                                   gid=int(pb.gids[b]),
                                   results=res[b, :n].tolist())
            results[i] = outs[b, :n].tolist()

    def _to_packet(self, txn: Txn):
        """Build the switch packet for ONE txn: ``build_packets`` at B=1,
        so the per-txn and batched paths share a single source of
        ordering/multipass truth and can never drift.  Returns
        (pkt, perm) where perm maps packet slots back to txn op
        indices."""
        pkt, meta = build_packets([txn], self.hot_index, self.switch_cfg)
        return pkt, [int(s) for s in meta["order"][0, :len(txn.ops)]]

    # cold: 2PL on nodes (+2PC when distributed)
    def _run_cold(self, txn: Txn):
        self._ts += 1
        results = self._exec_on_nodes(txn, ts=self._ts)
        participants = {node_of(k) for k in txn.keys()}
        # 2PC: prepare is implicit (locks held + constraints checked);
        # every participant votes commit, then commits + releases
        for p in participants:
            self.nodes[p].log("commit", txn.tid)
            self.nodes[p].release_all(txn.tid)
        self.stats["commits"] += 1
        if len(participants) > 1:
            self.stats["distributed"] += 1
        return results

    def _exec_on_nodes(self, txn: Txn, ts: int, keys_subset=None):
        """Acquire locks then apply ops; raises Abort on conflict or
        constraint violation (before any write is applied we stage them)."""
        results = [0] * len(txn.ops)
        staged: List[Tuple[int, int, int]] = []        # (node, key, newval)
        values: Dict[int, int] = {}
        executed = 0
        try:
            for i, (o, k, v) in enumerate(txn.ops):
                if keys_subset is not None and k not in keys_subset:
                    continue
                n = self.nodes[node_of(k)]
                mode = "S" if o == READ else "X"
                n.acquire(txn.tid, ts, k, mode)
                cur = values.get(k, n.store[k])
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
                        raise Abort(f"constraint on {k}")
                    values[k] = cur + v
                    results[i] = values[k]
                executed += 1
        except Abort:
            # wasted-work accounting: ops this doomed attempt executed
            # before discovering the conflict/constraint
            self.stats["wasted_ops"] += executed
            raise
        # crash point between prepare (locks held, redo staged) and the
        # apply+log step — the lock-leak property test's worst window
        self._fault("mid_2pc_prepare", tid=txn.tid)
        for k, nv in values.items():
            n = self.nodes[node_of(k)]
            n.log("write", txn.tid, key=k, old=n.store[k], new=nv)
            n.store[k] = nv
        return results

    # warm: cold part made abort-proof first, then the switch sub-txn
    # (paper §6.2, Fig 8/10)
    def _run_warm(self, txn: Txn):
        self._ts += 1
        hot_keys = {k for k in txn.keys() if self.hot_index.is_hot(k)}
        cold_ops = [(i, (o, k, v)) for i, (o, k, v) in enumerate(txn.ops)
                    if k not in hot_keys]
        hot_ops = [(i, (o, k, v)) for i, (o, k, v) in enumerate(txn.ops)
                   if k in hot_keys]
        # ADDP across the hot/cold boundary would need the cold tuple
        # offloaded too (paper §6.2); workloads avoid it by construction.
        cold_txn = Txn(txn.kind, [op for _, op in cold_ops], txn.home,
                       tid=txn.tid)
        hot_txn = Txn(txn.kind, [op for _, op in hot_ops], txn.home,
                      tid=txn.tid)
        # an explicit switch_mode that rejects the hot sub-txn must fail
        # BEFORE the cold part takes locks and applies/logs its writes
        if self.switch_mode != "auto":
            _, meta = build_packets([hot_txn], self.hot_index,
                                    self.switch_cfg)
            self._validate_mode(meta)
        cold_res = self._exec_on_nodes(cold_txn, ts=self._ts)
        # cold part can no longer abort -> send switch sub-txn
        hot_res = self._run_hot(hot_txn)
        # commit cold part everywhere (2PC decision broadcast)
        for p in {node_of(k) for k in cold_txn.keys()}:
            self.nodes[p].log("commit", txn.tid)
            self.nodes[p].release_all(txn.tid)
        results = [0] * len(txn.ops)
        for (i, _), r in zip(cold_ops, cold_res):
            results[i] = r
        for (i, _), r in zip(hot_ops, hot_res):
            results[i] = r
        return results

    # ----------------------------------------------- faults & durability --
    def _fault(self, point: str, **ctx):
        """Instrumented crash point: fires the armed ``FaultPlan`` (if any),
        applying crash side effects and raising ``SimulatedCrash``.  A
        crash loses everything volatile on the switch side: the register
        file and every undrained response (clients keep ``None``); node
        WALs and stores survive."""
        fp = self.fault_plan
        if fp is None or not fp.should_fire(point):
            return
        fp.on_crash(self, point, ctx)
        self._inflight.clear()          # responses never reached the hosts
        self._switch_down = True
        raise SimulatedCrash(point, ctx)

    def _note_sends(self, n: int):
        """Count switch sends toward the checkpoint interval; take a
        diff-only checkpoint when due (a consistency point — drains)."""
        self._sends_since_ckpt += n
        if self.checkpoint_interval \
                and self._sends_since_ckpt >= self.checkpoint_interval:
            self.checkpoint(reason="interval")

    def checkpoint(self, reason: str = "explicit") -> dict:
        """Consistency point: drain the async result plane, record a
        diff-only register checkpoint, log a ``ckpt`` marker on every node
        (the recovery boundary — replay starts after the newest marker),
        and refresh the warm standby from the checkpointed state."""
        self.drain()
        entry = self.ckpts.checkpoint(self.switch.read_all())
        for n in self.nodes:
            n.log("ckpt", entry["id"], reason=reason,
                  n_changed=entry["n_changed"])
        self._sends_since_ckpt = 0
        self.stats["checkpoints"] += 1
        if self._standby is not None:
            # the standby tails the checkpoint stream: after this it holds
            # the checkpointed registers, so takeover replays only sends
            # logged after this marker (bounded recovery)
            self._standby.restore((self.ckpts.state(), 0))
        return entry

    def snapshot_offload(self):
        """Legacy API (initial offload snapshot) — now the first/next
        checkpoint in the incremental chain."""
        self.checkpoint(reason="offload")

    # -------------------------------------------------------- brown-out --
    def enter_brownout(self, plan=None):
        """Enter the switch *brown-out* fault mode (``db.faults.Brownout``:
        slow/lossy — degraded, not dead).  The register plane is drained
        and every switch-resident value is evicted to its home store as a
        real WAL-logged write (the migration evict step's discipline), so
        home stores become authoritative: hot/warm admissions DEMOTE to
        the cold path (``classify``) and reads/scans fall back to the
        stores — the cluster keeps committing through the brown-out
        instead of failing.  Demotions are bounded by the plan's
        ``demote_cap``; past the budget admissions are shed with
        ``SwitchUnavailable`` (bounded queueing, never unbounded).
        ``plan`` may be a ``Brownout``, a bare int cap, or None
        (unbounded demotion)."""
        if self._brownout:
            return
        if plan is None:
            plan = Brownout()
        elif isinstance(plan, int):
            plan = Brownout(demote_cap=plan)
        self.drain()
        hot_keys = sorted(self.hot_index.placement.slot) \
            if self.use_switch else []
        vals = self.read_batch(hot_keys) if hot_keys else []
        for k, v in zip(hot_keys, vals):
            n = self.nodes[node_of(k)]
            t = next(self._brownout_tid)
            n.log("write", t, key=k, old=n.store[k], new=v)
            n.store[k] = v
            n.log("commit", t)
        self._brownout = True
        self._brownout_cap = plan.demote_cap
        self._brownout_served = 0
        self._brownout_evicted = set(hot_keys)
        self.stats["brownouts"] += 1

    def exit_brownout(self):
        """Leave brown-out: write every evicted key's home-store value
        (including cold-path updates made during the window) back into
        its register through real logged switch dispatches — replay, the
        checkpoint chain and the warm standby all observe the reload —
        and restore hot service.  Registers come back byte-identical to
        a cluster that served the same txns without the brown-out."""
        if not self._brownout:
            return
        self._brownout = False              # reads may hit the switch again
        keys = sorted(self._brownout_evicted)
        self._brownout_evicted = set()
        group = [Txn("brownout_reload",
                     [(WRITE, k, self.nodes[node_of(k)].store[k])],
                     node_of(k), tid=next(self._brownout_tid))
                 for k in keys]
        if not group:
            return
        pkts, meta = build_packets(group, self.hot_index, self.switch_cfg)
        for t in group:
            self.nodes[t.home].log("switch_send", t.tid, ops=list(t.ops))
        pb = self.switch.execute_batch(pkts, meta, mode=self.switch_mode)
        res = pb.results_np()
        for b, t in enumerate(group):
            self.nodes[t.home].log("switch_result", t.tid,
                                   gid=int(pb.gids[b]),
                                   results=res[b, :1].tolist())
        self._note_sends(len(group))

    def verify_wals(self) -> list:
        """Run the hash-chain integrity walk over every node's WAL
        (no-op entries for nodes in legacy list mode)."""
        out = []
        for n in self.nodes:
            if isinstance(n.wal, SegmentedWAL):
                out.append(dict(node=n.id, **n.wal.verify()))
            else:
                out.append(dict(node=n.id, ok=True, records=len(n.wal),
                                segments=0, sealed=0))
        return out

    # --------------------------------------------------------- telemetry --
    def export_metrics(self, fmt: str = "prometheus"):
        """Refresh point-in-time gauges (engine dispatch counters incl.
        per-shard counts, per-node WAL depth, in-flight window) and render
        the registry — ``fmt="prometheus"`` text exposition, ``"json"``
        snapshot dict.  Read-only with respect to engine state: safe to
        scrape mid-run."""
        if self.metrics is None:
            raise RuntimeError("cluster built with telemetry=False")
        from repro_torch.obs.export import to_prometheus
        g = self.metrics.gauge
        planes = getattr(self.switch, "planes", None) or [self.switch]
        for i, p in enumerate(planes):
            g(G_SHARD_DISPATCHES, help="switch dispatches per shard",
              shard=str(i)).set(p.dispatch_count)
        g("switch_dispatches", help="total switch write dispatches").set(
            sum(p.dispatch_count for p in planes))
        g("switch_read_dispatches", help="total switch read gathers").set(
            sum(getattr(p, "read_dispatch_count", 0) for p in planes))
        for n in self.nodes:
            g(G_WAL_RECORDS, help="WAL records per node",
              node=str(n.id)).set(len(n.wal))
        g(G_INFLIGHT, help="undrained async hot groups").set(
            len(self._inflight))
        if fmt == "json":
            return self.metrics.snapshot()
        return to_prometheus(self.metrics)

    def read(self, key: int) -> int:
        """Availability-aware point read of one tuple's committed value.
        Hot keys read the live register (draining first — a consistency
        point); while the switch is down, keys evicted by an interrupted
        migration stay readable from their authoritative home-node store
        (partial availability), every other hot key raises
        ``SwitchUnavailable``.  Cold keys always read the home store."""
        if self.use_switch and self.hot_index.is_hot(key):
            if self._brownout:
                # brown-out: home stores are authoritative (evicted)
                return self.nodes[node_of(key)].store[key]
            if self._switch_down:
                if key in self._mid_migration_evicted:
                    return self.nodes[node_of(key)].store[key]
                raise SwitchUnavailable(
                    f"hot key {key} lives on the crashed switch")
            self.drain()
            # resolve through the placement-VERSIONED vectorized lookup
            # (slots_np), same as the write path's packet builder — the raw
            # dict walk could serve a slot cached before an in-place
            # re-placement (the stale-slot class pinned in test_layout.py)
            sw, st, rg = self.hot_index.slots_np(np.asarray([key], np.int64))
            return self.switch.read_value((int(sw[0]), int(st[0]),
                                           int(rg[0])))
        return self.nodes[node_of(key)].store[key]

    def read_batch(self, keys) -> List[int]:
        """The switch-served read tier (paper §4.3: READ-only hot txns are
        answered by the data plane): one vectorized hot/cold split, hot
        keys gathered straight from the resident device registers in a
        single dispatch — no WAL entry, no GID, no locks, no pipeline
        recirculation (reads are non-durable by construction) — cold keys
        from their authoritative home-node stores.

        Coherent without draining: on an async cluster the gather is
        submitted to the same FIFO dispatch thread as every in-flight
        write group, so it observes all of them while their result planes
        stay lazily device-resident.  While the switch is down, keys
        evicted by the interrupted migration fall back to their home
        stores; any other hot key raises ``SwitchUnavailable``."""
        t0 = time.perf_counter() if self.metrics is not None else 0.0
        keys = np.asarray(list(keys), np.int64)
        out = np.zeros(len(keys), np.int64)
        hot = self.hot_index.hot_mask_np(keys) if self.use_switch \
            else np.zeros(len(keys), bool)
        if self._brownout:
            hot[:] = False              # brown-out: stores authoritative
        if self._switch_down and hot.any():
            bad = [int(k) for k in keys[hot]
                   if k not in self._mid_migration_evicted]
            if bad:
                raise SwitchUnavailable(
                    f"hot keys {bad[:4]} live on the crashed switch")
            hot[:] = False              # evicted: home stores are
        hot_pos = np.flatnonzero(hot)   # authoritative (partial avail.)
        if len(hot_pos):
            rp = build_read_packets(keys[hot_pos], self.hot_index,
                                    self.switch_cfg)
            pr = self.switch.execute_reads(rp, mode=self._read_mode())
            out[hot_pos] = pr.values_np()
            self.stats["switch_reads"] += len(hot_pos)
        for i in np.flatnonzero(~hot):
            out[i] = self.nodes[node_of(int(keys[i]))].store[int(keys[i])]
            self.stats["store_reads"] += 1
        if self.metrics is not None:
            self.metrics.histogram(
                H_READ_BATCH, help="read_batch wall time").observe(
                    time.perf_counter() - t0)
        return [int(v) for v in out]

    def _read_mode(self) -> str:
        # READ gathers have no CADD/multipass constraints: any engine mode
        # can serve them.  "pallas" keeps the faithful-execution kernels
        # in the loop; every other mode uses the AOT-cached jit gather.
        return "pallas" if self.switch_mode == "pallas" else "auto"

    def scan(self, lo: int, hi: int, keys=None, limit: Optional[int] = None):
        """Range-predicate scan with switch-side pruning: filter value in
        ``[lo, hi]`` over the hot tier (``keys=None`` scans the whole
        switch-resident working set; an explicit key list may mix hot and
        cold).  Hot keys are filtered ON DEVICE by the scan-prune kernel —
        only surviving rows (≤ cap, power-of-two padded) ship to the host,
        never the full register file; cold keys filter host-side at their
        home stores.  ``limit`` keeps the ``limit`` largest matches (ties
        toward the smaller key, the device top-k rule).  Returns
        ``[(key, value)]`` sorted by key.  Same availability contract as
        ``read_batch``."""
        if keys is None:
            keys = sorted(self.hot_index.placement.slot.keys()) \
                if self.use_switch else []
        keys = np.asarray(list(keys), np.int64)
        hot = self.hot_index.hot_mask_np(keys) if self.use_switch \
            else np.zeros(len(keys), bool)
        if self._brownout:
            hot[:] = False              # brown-out: stores authoritative
        if self._switch_down and hot.any():
            bad = [int(k) for k in keys[hot]
                   if k not in self._mid_migration_evicted]
            if bad:
                raise SwitchUnavailable(
                    f"hot keys {bad[:4]} live on the crashed switch")
            hot[:] = False
        # hot side: keys sorted ascending so device stream position order
        # == key order (makes the top-k tie rule "smaller key wins")
        hk = np.sort(keys[hot])
        matches: List[Tuple[int, int]] = []
        if len(hk):
            rp = build_read_packets(hk, self.hot_index, self.switch_cfg)
            M = len(hk)
            if limit is not None:
                k = min(limit, M)
                vals, pos, count = self.switch.execute_scan(
                    rp, lo, hi, k=k)
                t = min(count, k)
                self.stats["scan_rows_shipped"] += k
            else:
                cap = min(M, max(16, (limit or 0)))
                vals, pos, agg = self.switch.execute_scan(
                    rp, lo, hi, cap=cap)
                self.stats["scan_rows_shipped"] += cap
                if int(agg[0]) > cap:       # truncated: rescan at the
                    cap = min(int(agg[0]), M)   # exact survivor count
                    vals, pos, agg = self.switch.execute_scan(
                        rp, lo, hi, cap=cap)
                    self.stats["scan_rows_shipped"] += cap
                t = min(int(agg[0]), cap)
            matches += [(int(hk[pos[i]]), int(vals[i])) for i in range(t)]
            self.stats["scans_switch"] += 1
        for k_ in keys[~hot]:
            v = self.nodes[node_of(int(k_))].store[int(k_)]
            if lo <= v <= hi:
                matches.append((int(k_), v))
        if limit is not None and len(matches) > limit:
            # global top-``limit`` by (-value, key): identical rule to the
            # device top-k, applied across the hot/cold merge
            matches.sort(key=lambda kv: (-kv[1], kv[0]))
            matches = matches[:limit]
        return sorted(matches)

    # -------------------------------------------------------- recovery --
    def _post_ckpt_sends(self):
        """Collect the switch sends to replay: for each node, only entries
        after its newest ``ckpt`` marker (everything earlier is captured
        by the checkpoint chain).  Returns (known, unknown) lists of send
        entries — known ordered by logged GID, in-flight unknowns by tid
        (deterministic; any order is legal for unresulted txns, paper
        §A.3, and tid order matches admission order)."""
        entries = []              # (gid_or_None, tid, send_entry)
        for n in self.nodes:
            wal = n.wal
            recs = list(wal)
            for i in range(len(recs) - 1, -1, -1):
                if recs[i].kind == "ckpt":
                    recs = recs[i + 1:]
                    break
            sends = {e.tid: e for e in recs if e.kind == "switch_send"}
            res = {e.tid: e for e in recs if e.kind == "switch_result"}
            for tid, se in sends.items():
                re = res.get(tid)
                gid = re.payload["gid"] if re else None
                entries.append((gid, tid, se))
        known = sorted([e for e in entries if e[0] is not None],
                       key=lambda e: e[0])
        unknown = sorted([e for e in entries if e[0] is None],
                         key=lambda e: e[1])
        return known, unknown

    def _replay_into(self, engine, reset_registers: bool = True):
        """Deterministic replay of the post-checkpoint log suffix into
        ``engine``: seed the registers from the reconstructed checkpoint
        chain (base + diffs — the honest recovery path), then re-execute
        known-GID sends in GID order and in-flight unknowns in tid order.
        Same log ⇒ byte-identical registers (property-tested)."""
        known, unknown = self._post_ckpt_sends()
        if reset_registers:
            base = self.ckpts.reconstruct()
            if base is not None:
                engine.load_registers(base)
        for _, _, se in known + unknown:
            t = Txn("replay", [tuple(o) for o in se.payload["ops"]], 0)
            pkt, meta = build_packets([t], self.hot_index, self.switch_cfg)
            engine.execute_batch(pkt, meta).results_np()
        return len(known), len(unknown)

    def crash_switch(self, lose_inflight: bool = True):
        """Kill the switch without recovering: the register file and (with
        ``lose_inflight``) every undrained response are gone; hot traffic
        raises ``SwitchUnavailable`` until ``recover_switch()`` or
        ``fail_over()``."""
        if lose_inflight:
            self._inflight.clear()
        else:
            self.drain()
        self._switch_down = True

    def recover_switch(self):
        """Rebuild switch registers from the nodes' WALs (paper §6.1/A.3).

        Checkpoints are the recovery boundary: each ``ckpt`` marker (taken
        at ``snapshot_offload``, every migration, and every
        ``checkpoint_interval`` sends) caps how much log must be replayed
        — only sends after a node's newest marker are re-executed, their
        packets built under the placement that is still current.  With no
        checkpoints this is the original full-WAL replay.  In-flight
        unknowns (no result record) replay after all known-GID sends,
        ordered by read/write-set dependencies against the replayed state
        (Fig 9) — commutative ADD streams make tid order sufficient
        here."""
        engine = self._fresh_engine()
        known, unknown = self._replay_into(engine)
        self.switch = engine
        self._switch_down = False
        self._mid_migration_evicted = set()
        self.stats["recoveries"] += 1
        return known, unknown

    def crash_switch_and_recover(self):
        """Legacy one-shot crash + rebuild.  Async hot path: outstanding
        handles are drained first — the in-flight window is a
        host-visibility artifact, not lost state (the device already
        executed the dispatches in order), so recovery sees the same
        fully-resulted WAL the synchronous path would have written."""
        if not self._switch_down:
            self.drain()
        return self.recover_switch()

    def fail_over(self):
        """Promote the warm standby.  The standby already holds the last
        checkpoint's registers (refreshed at every ``checkpoint``), so
        takeover replays ONLY the post-checkpoint sends — recovery work is
        bounded by the checkpoint interval, not the log length.  Returns
        (known, unknown) replay counts; the bounded-recovery pin asserts
        known + unknown == sends since the last checkpoint."""
        if self._standby is None:
            raise RuntimeError("no warm standby configured "
                               "(Cluster(standby=True))")
        if not self._switch_down:
            self.crash_switch()
        # double-fault window: the standby itself can die during takeover
        # (armed "mid_failover" plan loses it) — the switch stays down and
        # recover_switch() is the cold WAL+checkpoint fallback
        self._fault("mid_failover")
        engine = self._standby
        # host-known GID high-water mark: new txns after takeover must get
        # fresh GIDs above everything already logged
        highwater = self.switch.next_gid
        known, unknown = self._replay_into(engine, reset_registers=False)
        engine.next_gid = max(engine.next_gid, highwater)
        self.switch = engine
        self._switch_down = False
        self._mid_migration_evicted = set()
        # re-arm a fresh standby at the current checkpoint state
        self._standby = self._fresh_engine()
        if self.ckpts.state() is not None:
            self._standby.restore((self.ckpts.state(), 0))
        self.stats["failovers"] += 1
        return known, unknown

    def crash_node_and_recover(self, node_id: int):
        n = self.nodes[node_id]
        n.crash()
        n.recover_local()
