"""Cluster timing model (paper §7 setup): 8 nodes, 10G NICs, DPDK, one
programmable ToR switch.  Workers run closed-loop; the DES supplies lock
contention, switch pipeline-lock queueing and abort/retry dynamics.

Key latency asymmetry (the paper's core argument): the switch is reachable
in HALF the node-to-node latency, and in-switch txns take no locks at all.

Batched switch admission (``SystemConfig.batch_window`` / ``max_batch``)
------------------------------------------------------------------------
The functional hot path (``Cluster.run_batch``) commits whole groups of
hot transactions in ONE switch dispatch; this layer models the matching
admission discipline.  With batching enabled, a p4db worker no longer
performs a synchronous switch round per hot txn.  Instead each node runs
a switch-batcher (a DES ``Batcher``): hot txns arriving within
``batch_window`` seconds — or until ``max_batch`` have gathered, or,
with ``batch_window=0``, greedily while the previous round is in
flight — are dispatched as ONE switch round that pays a single
``rtt_switch``, a
per-txn ``t_pipe`` occupancy, and ONE pipeline-lock acquisition covering
the summed recirculation occupancy of its multipass members.  All members
resume (commit, record latency) when the round returns.  Because hot txns
are abort-free and commit-on-send (§6.1), the admitting worker does not
block on the round: it hands the txn to the batcher and continues, with a
per-node credit pool (``(pipeline_depth + 1) x max_batch`` outstanding
hot txns) providing closed-loop backpressure.  Per-txn admission —
``batch_window=0`` and ``max_batch=1``, the defaults — keeps the
original synchronous path, event-for-event.  Warm txns' switch sub-txns
stay synchronous in either mode: their round happens while the cold
part's locks are held.

Pipelined switch rounds (``SystemConfig.pipeline_depth``)
---------------------------------------------------------
The paper's DPDK dispatcher overlaps assembling the next batch of
hot-txn packets with the current batch's flight; serializing rounds per
node caps batched admission well below that.  ``pipeline_depth`` is the
number of switch rounds a node may have in flight concurrently: the
node's ``Batcher`` keeps servicing closed batches while earlier rounds
are still on the wire, so round k+1 is assembled (and launched) during
round k's flight.  ``pipeline_depth=1`` — the default — reproduces the
serialized (PR 2) batched model event-for-event.  The serialization
points that remain with depth > 1 are physical: the per-node NIC (below)
and the switch pipeline locks (``pipeline_locks``).

Per-node NIC serialization (``SystemConfig.nic_line_rate``)
-----------------------------------------------------------
With ``nic_line_rate > 0`` (bytes/second, e.g. 1.25e9 for the paper's
10G NICs) each switch round additionally pays wire time
``len(batch) * Timing.pkt_bytes / nic_line_rate`` on its node's NIC —
once to serialize the request burst onto the wire (TX) and once for the
response burst (RX) — under an exclusive per-node NIC ``Resource``, so
concurrent in-flight rounds from one node still serialize at the NIC.
``rtt_switch`` then models propagation + switch latency only.  The
default ``nic_line_rate=0`` folds wire time into ``rtt_switch`` exactly
as the pre-NIC model did (no NIC events at all — regression-pinned).

Shared switch ingress (``SystemConfig.switch_service_rate``)
------------------------------------------------------------
Rounds from different nodes used to contend only on the pipeline-lock
Resource; the real Tofino has ONE ingress pipeline whose packet rate
bounds aggregate throughput across ALL nodes.  With
``switch_service_rate > 0`` (packets/second) every switch round — and
every synchronous per-txn/warm switch access — holds a single global
ingress ``Resource(1)`` for ``n_pkts / switch_service_rate`` seconds
after its request burst arrives.  This makes the NIC-vs-switch
bottleneck crossover measurable: aggregate commits/s is capped by
``min(sum of NIC rates, switch_service_rate)``.  ``0`` (default)
disables the resource entirely — no extra events, the pre-ingress
model exactly.

Cold-path wire accounting (with ``nic_line_rate > 0``)
------------------------------------------------------
``rtt_node``/``t_2pc_round`` used to fold NIC serialization in; with an
explicit NIC, cold remote accesses and 2PC decision rounds also pay
per-message wire time under the accessing node's NIC ``Resource``, so
hot switch traffic can visibly starve the cold path (and vice versa) at
high line utilization.  ``nic_line_rate=0`` keeps both folded, exactly
as before.

Adaptive hot-set re-placement (``SystemConfig.reconfig_interval``)
------------------------------------------------------------------
In dynamic-workload mode (``ClusterSim(dynamic=...)``, fed by a drift
generator from ``repro.workloads.drift``) transactions are sampled and
classified at admission time against a MUTABLE hot index.  With
``reconfig_interval > 0`` an epoch controller coroutine periodically
re-detects the hot set (from a ``repro.core.heat.HeatTracker`` fed by
the admission loop, or from the generator's ground truth when
``oracle=True`` — then aligned to phase boundaries), re-runs
``make_layout`` on the observed trace window, pauses the switch for
``Timing.t_reconfig`` seconds (the migration: drain + register
copy-out/copy-in + index swap) and atomically swaps the index.  Switch
rounds arriving during the pause wait it out (``reconfig_wait`` phase).
``reconfig_interval=0`` (default) spawns nothing: the static
profile-driven path is untouched, event for event.

``SystemConfig`` knobs, summarized: ``kind`` (p4db | noswitch |
lmswitch), ``protocol`` (cold-path 2PL flavor), ``pipeline_locks``,
``fast_recirc``, ``early_release``, ``drop_on_abort``, ``batch_window``
and ``max_batch`` (batched switch admission, PR 2), ``pipeline_depth``
(concurrent in-flight rounds per node, PR 3), ``nic_line_rate``
(explicit NIC serialization, PR 3; now also charged on cold remote
accesses and 2PC rounds), ``switch_service_rate`` (shared switch
ingress, this PR) and ``reconfig_interval`` (adaptive re-placement
epochs, this PR).

Durability mirror (all default-off, zero events when off): ``crash_at``
crashes the switch once and promotes a warm standby behind a pause of
``Timing.t_failover`` + ``t_replay_send`` per send since the last
checkpoint; ``ckpt_interval`` spawns the incremental-checkpoint daemon
that bounds that replay debt; ``gate_t_reconfig`` mirrors the
functional EpochController's cost-benefit migration gate; and
``partial_availability`` lets txns whose hot keys were all evicted by
a pending re-placement demote to the cold path (home-store reads)
instead of waiting out the migration pause — the DES answer to "what
does a switch crash cost at load X".

Contention mirror (default-off, zero events when off): ``early_abort``
registers every cold/warm txn's lock-intent set with the switch at 2PC
begin; on overlap the loser is aborted mid-flight behind one
``Timing.t_abort_notify`` multicast instead of burning its remaining
round-trips (NO_WAIT: the new registrant dies; WAIT_DIE: the younger
dies, an older registrant *wounds* the younger in-flight txn, which
aborts at its next op tick and frees its locks early).  The result dict
gains an ``early_abort`` key only when the knob is on; wasted-op
accounting (ops executed by eventually-aborted attempts) fills the
registry on every run.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.heat import HeatTracker
from repro_torch.core.hotset import HotIndex, layout_for_hotset
from repro_torch.core.layout import trace_reorderable
from repro_torch.obs.names import (C_ARRIVALS, C_DROPPED, G_UTILIZATION,
                                   H_ADMISSION_WAIT, H_PHASE, H_TXN_LATENCY)
from repro_torch.obs.registry import MetricsRegistry, OccupancyMeter
from repro_torch.obs.trace import Tracer
from repro_torch.sim.des import Batcher, Resource, Sim, SimLock


@dataclass
class Timing:
    t_local_op: float = 1.0e-6        # index + latch + log per op
    rtt_node: float = 8e-6            # node -> node round trip (2 hops each way)
    rtt_switch: float = 4e-6          # node -> switch round trip (1 hop each way)
    t_pipe: float = 0.1e-6            # pipeline transit
    t_read_pipe: float = 0.05e-6      # pipeline transit of a READ-only hot
                                      # packet (read_path=True): no register
                                      # writes, no lock bits, no WAL mirror
                                      # work at the node — it shares ingress
                                      # and the NIC with writes but never
                                      # recirculates or takes the pipe lock
    t_recirc: float = 0.6e-6          # per extra pass (recirculation port)
    t_recirc_fast: float = 0.25e-6    # fast-recirculate port (lock owners)
    t_backoff: float = 10e-6          # abort backoff base (grows per retry)
    t_2pc_round: float = 8e-6         # one 2PC message round
    t_client: float = 4e-6            # node-side per-txn CPU (DPDK + logic)
    t_commit_local: float = 2e-6      # commit/log-flush while locks held
    pkt_bytes: float = 128.0          # hot-txn packet size on the wire
                                      # (eth+ip+udp hdrs + P4DB instr list);
                                      # only used when nic_line_rate > 0
    t_reconfig: float = 100e-6        # switch pause per re-placement epoch
                                      # (drain + register copy-out/in +
                                      # index swap); only charged when
                                      # reconfig_interval > 0
    t_failover: float = 300e-6        # warm-standby promotion pause on a
                                      # switch crash: detection + route
                                      # flip; only charged when crash_at>0
    t_replay_send: float = 0.5e-6     # per post-checkpoint send replayed
                                      # into the standby at takeover — the
                                      # term ckpt_interval bounds
    t_interswitch: float = 1e-6       # per extra switch hop a cross-shard
                                      # hot txn pays (multi-switch topology;
                                      # only charged when n_switches > 1)
    t_abort_notify: float = 2e-6      # mid-flight early-abort multicast:
                                      # the switch spots overlapping in-
                                      # flight intent sets and notifies the
                                      # loser (Jepsen et al. optimistic
                                      # aborts); only charged when
                                      # early_abort=True and a conflict
                                      # actually fires


@dataclass
class SystemConfig:
    kind: str = "p4db"                # p4db | noswitch | lmswitch
    protocol: str = "NO_WAIT"         # cold-path 2PL flavor
    pipeline_locks: int = 2           # fine-grained 2-bit locks (1 = naive)
    fast_recirc: bool = True
    early_release: bool = False       # Chiller-style early lock release
    drop_on_abort: bool = True        # aborted txns are replaced, not
                                      # retried forever (paper Fig 12 counts
                                      # committed txns; hot txns under
                                      # No-Switch mostly abort)
    batch_window: float = 0.0         # switch-batcher gather window (s);
                                      # 0 with max_batch=1 = per-txn rounds,
                                      # 0 with max_batch>1 = greedy (batch
                                      # = arrivals during in-flight round)
    max_batch: int = 1                # hot txns per switch round (p4db)
    pipeline_depth: int = 1           # switch rounds a node may have in
                                      # flight concurrently; 1 = serialized
                                      # rounds (the PR 2 batched model,
                                      # event-for-event)
    nic_line_rate: float = 0.0        # NIC line rate in bytes/s (1.25e9 =
                                      # 10G); rounds pay TX + RX wire time
                                      # under a per-node NIC resource, and
                                      # cold remote accesses / 2PC rounds
                                      # pay per-message wire time there too.
                                      # 0 = fold wire time into rtt_switch/
                                      # rtt_node (the pre-NIC model, exactly)
    switch_service_rate: float = 0.0  # shared switch-ingress admission
                                      # rate in packets/s across ALL nodes
                                      # (ONE pipeline, as on the Tofino);
                                      # 0 = unbounded (no ingress events,
                                      # the pre-ingress model exactly)
    reconfig_interval: float = 0.0    # seconds between adaptive hot-set
                                      # re-placement epochs (dynamic-
                                      # workload mode only); 0 = static
                                      # placement, controller never spawns
    crash_at: float = 0.0             # sim-time of a switch crash followed
                                      # by warm-standby failover: outage =
                                      # t_failover + replayed sends *
                                      # t_replay_send; 0 = never (the
                                      # pre-durability model, zero events)
    ckpt_interval: float = 0.0        # seconds between incremental
                                      # checkpoints feeding the standby —
                                      # bounds the replayed-send term of a
                                      # failover; 0 = no checkpointing
    gate_t_reconfig: float = 0.0      # sim mirror of the functional
                                      # EpochController cost-benefit gate:
                                      # migrate only when the projected
                                      # hot-share gain over the next epoch
                                      # outweighs this pause cost (s);
                                      # 0 = ungated (the PR 4 controller)
    partial_availability: bool = False  # during a migration pause, txns
                                      # whose hot keys were ALL evicted by
                                      # the pending re-placement demote to
                                      # the cold path (home-store reads)
                                      # instead of waiting out the pause
    read_path: bool = False           # switch-served read tier: READ-only
                                      # hot txns transit at t_read_pipe,
                                      # never take the pipeline lock, never
                                      # recirculate, and don't count as
                                      # checkpointable sends (non-durable by
                                      # construction).  False = every hot
                                      # txn priced as a write, zero new
                                      # events (the pre-read-tier model)
    n_switches: int = 1               # sharded register plane: each switch
                                      # has its OWN ingress pipeline
                                      # (Resource), so aggregate hot
                                      # admission scales with shards;
                                      # cross-shard txns pay t_interswitch
                                      # per extra hop.  1 = the single-
                                      # switch model, event for event
    early_abort: bool = False         # network-assisted early aborts: the
                                      # switch observes cold/warm lock-
                                      # intent sets registered at 2PC
                                      # begin, detects overlaps, and
                                      # multicasts an abort to the loser
                                      # (t_abort_notify) before it burns
                                      # its doomed round-trips; WAIT_DIE
                                      # wounds the younger in-flight txn
                                      # mid-op-loop, freeing its locks
                                      # earlier.  False = zero events, the
                                      # PR 9 result dict key-for-key


@dataclass
class TxnProfile:
    kind: str
    klass: str                        # hot | cold | warm
    hot_ops: List[tuple]              # (key, node, mode)
    cold_ops: List[tuple]             # (key, node, mode)
    home: int
    participants: frozenset
    passes: int = 1
    shards: frozenset = frozenset({0})   # switches this txn's hot ops touch


def profile_txn(txn, hot_index, home_node) -> TxnProfile:
    from repro_torch.core.packets import READ
    trace = [(k, o) for o, k, _ in txn.ops]
    if hot_index is None:
        klass = "cold"
    else:
        klass = hot_index.classify(trace)
    hot_ops, cold_ops = [], []
    parts = set()
    for o, k, v in txn.ops:
        node = k // 1_000_000_000
        mode = "S" if o == READ else "X"
        if hot_index is not None and hot_index.is_hot(k):
            hot_ops.append((k, node, mode))
        else:
            cold_ops.append((k, node, mode))
            parts.add(node)
    passes = 1
    shards = frozenset({0})
    if hot_ops:
        hot_trace = [(k, o) for k, o in trace if hot_index.is_hot(k)]
        slots = [hot_index.slot(k) for k, _ in hot_trace]
        shards = frozenset(s[0] for s in slots) or shards
        # (switch, stage) ordering keys: lexicographic order equals the
        # global pipeline order the packet layer encodes, and single-
        # switch pass counts are unchanged (switch id constant at 0)
        seq = [s[:2] for s in slots]
        if trace_reorderable(hot_trace):
            seq = sorted(seq)
        last = (-1, -1)
        for s in seq:
            if s <= last:
                passes += 1
            last = s
    return TxnProfile(txn.kind, klass, hot_ops, cold_ops, home_node,
                      frozenset(parts), passes, shards)


class ClusterSim:
    def __init__(self, profiles: List[TxnProfile], n_nodes: int,
                 workers_per_node: int, system: SystemConfig,
                 timing: Timing = Timing(), seed: int = 0,
                 sim_time: float = 0.05, warmup: float = 0.01,
                 dynamic=None, hot_index: Optional[HotIndex] = None,
                 switch_cfg=None, tracker: Optional[HeatTracker] = None,
                 oracle: bool = False, reconfig_top_k: Optional[int] = None,
                 layout_seed: int = 0, open_loop_rate: float = 0.0,
                 max_arrivals: Optional[int] = None,
                 admit_per_node: Optional[int] = None,
                 admit_queue_cap: int = 0):
        self.profiles = profiles
        self.n_nodes = n_nodes
        self.wpn = workers_per_node
        self.sys = system
        self.T = timing
        self.rng = np.random.default_rng(seed)
        self.sim_time = sim_time
        self.warmup = warmup
        self.locks: Dict[int, SimLock] = {}
        self.pipe = Resource(system.pipeline_locks)
        self.commits = collections.Counter()
        self.aborts = collections.Counter()
        self.lat_sum = collections.Counter()
        self.lat_n = collections.Counter()
        self.breakdown = collections.Counter()   # phase -> summed seconds
        self._ts = 0
        # dynamic-workload mode (adaptive hot-set management): txns are
        # sampled from a drift generator and profiled at admission against
        # a mutable hot index; with reconfig_interval > 0 a controller
        # coroutine periodically re-places it (tracker-driven, or from
        # generator ground truth when oracle=True).  dynamic=None keeps
        # the static profile-driven path untouched, event for event.
        self.dynamic = dynamic
        self.hot_index = hot_index
        self.switch_cfg = switch_cfg
        self.oracle = oracle
        self.reconfig_top_k = reconfig_top_k
        self._layout_seed = layout_seed
        self._reconfig_on = dynamic is not None and \
            system.reconfig_interval > 0
        if dynamic is not None and hot_index is None:
            raise ValueError("dynamic mode needs an initial hot_index")
        if self._reconfig_on and switch_cfg is None:
            raise ValueError("reconfig_interval > 0 needs switch_cfg "
                             "(re-placement runs make_layout against it)")
        if tracker is None and self._reconfig_on and not oracle:
            tracker = HeatTracker()
        self.tracker = tracker
        self._ctl_rng = np.random.default_rng(seed + 0x5EED)
        self.pause_until = 0.0        # switch unavailable during migration
        self.pause_reason = "reconfig"   # label pause waits are charged to
        self.reconfigs = 0
        # durability mirror (crash_at / ckpt_interval / gate / partial
        # availability — all default-off, adding zero events when off)
        self._sends_since_ckpt = 0
        self.ckpts_taken = 0
        self.failover: Optional[dict] = None
        self.reconfigs_gated = 0
        self._evicted_during_pause: set = set()
        self.partial_served = 0
        self._last_traces: list = []
        self.phase_commits = collections.Counter()   # (phase, klass) -> n
        # batched switch admission (see module docstring): per-txn rounds
        # when batch_window=0, max_batch=1 and pipeline_depth=1 — the
        # exact original path.  depth>1 alone still routes hot txns
        # through the batcher (pipelined per-txn rounds).
        self.batching = system.kind == "p4db" and \
            (system.max_batch > 1 or system.batch_window > 0 or
             system.pipeline_depth > 1)
        # credit pool: pipeline_depth rounds in flight + one forming batch
        # (depth=1 keeps the PR 2 pool of 2 x max_batch)
        self.hot_credits = (max(1, system.pipeline_depth) + 1) * \
            max(1, system.max_batch)
        self.rounds = 0                          # batched switch rounds
        self.round_txns = 0                      # hot txns they carried
        # telemetry plane (repro.obs): latency histograms and utilization
        # meters fill on EVERY run (sim-time stamped), but the default
        # result dict never gains a key — golden pins compare out == golden
        # whole-dict, so metrics live on ``self.metrics`` and new result
        # keys appear only in open-loop mode.  Pure-Python accounting:
        # zero events added, event order untouched.
        self.metrics = MetricsRegistry(namespace="p4db_sim")
        self.tracer: Optional[Tracer] = None     # built in run() (sim clock)
        self._h_lat: Dict[str, object] = {}
        self._busy = collections.Counter()       # resource -> busy seconds
        self._occ_credits = OccupancyMeter()
        self._occ_admit = OccupancyMeter()
        # open-loop serving mode: Poisson client arrivals at
        # ``open_loop_rate``/s aggregate (split evenly across nodes)
        # replace the closed-loop workers.  Admission rides two pools:
        # every txn holds one of ``admit_per_node`` (default wpn) admit
        # slots -- hot txns release it at batcher hand-off (commit-on-
        # send), cold/warm hold it to commit -- and hot txns additionally
        # take the existing per-node switch credit.  ``admit_queue_cap``
        # > 0 sheds load: an arrival finding that many waiters is dropped
        # (counted, not serviced), which also bounds DES event volume at
        # million-arrival scale.  0.0 = closed-loop workers, untouched.
        self.open_loop_rate = float(open_loop_rate)
        self.max_arrivals = max_arrivals
        self.admit_per_node = admit_per_node
        self.admit_queue_cap = int(admit_queue_cap)
        self.arrivals = 0
        self.dropped = 0
        # in-flight conflict detector mirror (early_abort=True, p4db only):
        # intent sets keyed by txn ts; wounded victims abort at their next
        # op tick.  Default-off adds ZERO events; the wasted-op attribute
        # fills on every run (registry-only, never a default result key).
        self._ea_on = system.early_abort and system.kind == "p4db"
        self._ea_inflight: Dict[int, tuple] = {}   # ts -> (wset, rset)
        self._ea_wounded: set = set()
        self.early_aborts = 0
        self.ea_wounds = 0
        self.conflicts_detected = 0
        self.wasted_ops = 0

    def _charge(self, phase, dt):
        if getattr(self, "sim", None) is not None and \
                self.sim.now >= self.warmup:
            self.breakdown[phase] += dt

    def _busy_add(self, resource, dt):
        """Post-warmup busy-seconds accounting for utilization gauges —
        deliberately NOT part of ``breakdown`` (the result dict's breakdown
        keys are frozen by the golden pins)."""
        if self.sim.now >= self.warmup:
            self._busy[resource] += dt

    def _hist_lat(self, klass):
        h = self._h_lat.get(klass)
        if h is None:
            h = self._h_lat[klass] = self.metrics.histogram(
                H_TXN_LATENCY, help="sim txn latency (admission/arrival to "
                "commit, sim time)", klass=klass)
        return h

    def _hist_phase(self, phase):
        key = ("phase", phase)
        h = self._h_lat.get(key)
        if h is None:
            h = self._h_lat[key] = self.metrics.histogram(
                H_PHASE, help="per-phase sim latency", phase=phase)
        return h

    # ------------------------------------------------------------ locks --
    def lock_of(self, key) -> SimLock:
        lk = self.locks.get(key)
        if lk is None:
            lk = self.locks[key] = SimLock(self.sys.protocol)
        return lk

    # ----------------------------------------------------------- worker --
    def _draw(self, node: int) -> TxnProfile:
        """Admit one transaction: static mode draws a pre-classified
        profile; dynamic mode samples the drift generator at the current
        sim time, feeds the heat tracker, and classifies against the
        CURRENT hot index (which a reconfiguration may have swapped)."""
        if self.dynamic is None:
            return self.profiles[int(self.rng.integers(len(self.profiles)))]
        txn = self.dynamic.sample(self.rng, self.sim.now, home=node)
        if self.tracker is not None:
            self.tracker.observe_trace([(k, o) for o, k, _ in txn.ops])
        # home from the txn, not the worker: generators may pin a txn to
        # its data's node (TPC-C homes at the warehouse) — the same
        # convention the static profile pools use (profile_txn(t, hi,
        # t.home) in benchmarks/common.py)
        return profile_txn(txn, self.hot_index, txn.home)

    def _account(self, prof: TxnProfile, t0: float):
        sim = self.sim
        self.commits[prof.klass] += 1
        self.commits["total"] += 1
        self.commits[prof.kind] += 1
        dt = sim.now - t0
        self.lat_sum[prof.klass] += dt
        self.lat_n[prof.klass] += 1
        self.lat_sum["all"] += dt
        self.lat_n["all"] += 1
        self._hist_lat(prof.klass).observe(dt)
        self._hist_lat("all").observe(dt)
        if self.dynamic is not None:
            ph = self.dynamic.phase_of(sim.now)
            self.phase_commits[(ph, prof.klass)] += 1

    def _demote_if_evicted(self, prof: TxnProfile) -> TxnProfile:
        """Partial availability during a migration pause: a txn whose hot
        keys were ALL evicted by the pending re-placement reads them from
        their authoritative home-node stores (the migration wrote evicted
        registers back before the pause) — it demotes to the cold path
        and commits instead of waiting out the pause."""
        if not (self.sys.partial_availability
                and self._evicted_during_pause
                and prof.klass != "cold"
                and self.sim.now < self.pause_until):
            return prof
        hot_keys = [k for k, _, _ in prof.hot_ops]
        if not hot_keys or not all(k in self._evicted_during_pause
                                   for k in hot_keys):
            return prof
        self.partial_served += 1
        return TxnProfile(
            prof.kind, "cold", [], prof.cold_ops + prof.hot_ops, prof.home,
            prof.participants | {n for _, n, _ in prof.hot_ops}, 1)

    def worker(self, node: int):
        sim, T = self.sim, self.T
        while True:
            prof = self._demote_if_evicted(self._draw(node))
            t0 = sim.now
            self._ts += 1
            ts = self._ts
            yield ("delay", T.t_client)
            if self.batching and prof.klass == "hot":
                # async hand-off to the node's switch-batcher: hot txns
                # are abort-free and commit-on-send, so the worker admits
                # the next txn while the round is in flight; the credit
                # pool bounds outstanding hot txns (closed-loop)
                yield ("acquire", self.credits[node])
                self._occ_credits.adjust(+1, sim.now)
                sim.spawn(self._run_hot_batched(node, prof, t0))
                continue
            committed = yield from self.run_txn(prof, ts, node)
            attempt = 1
            while not committed:
                self.aborts[prof.klass] += 1
                yield ("delay", float(self.rng.exponential(
                    min(T.t_backoff * attempt, 100e-6))))
                if self.sys.drop_on_abort:
                    break
                attempt += 1
                ts = self._retry_ts(ts)
                committed = yield from self.run_txn(prof, ts, node)
            if not committed:
                continue
            if sim.now >= self.warmup:
                self._account(prof, t0)

    def run_txn(self, prof: TxnProfile, ts: int, node: Optional[int] = None):
        node = prof.home if node is None else node
        if self.sys.kind == "p4db" and prof.klass == "hot":
            yield from self.switch_txn(prof, node)
            return True
        if self.sys.kind == "p4db" and prof.klass == "warm":
            ok = yield from self.cold_part(prof, ts)
            if not ok:
                return False
            yield from self.switch_txn(prof, node)
            # commit: 2PC prepare already implicit; switch multicasts the
            # decision, saving the second round (paper Fig 10) — the
            # coordinator's NIC only carries the participants' acks
            if len(prof.participants) > 1:
                yield from self._msg_nic(prof.home,
                                         max(1, len(prof.participants) - 1))
                yield ("delay", self.T.t_2pc_round)
            self.release_all(prof, ts)
            return True
        # noswitch / lmswitch / p4db-cold: plain 2PL (+2PC)
        ok = yield from self.cold_part(prof, ts, include_hot=True)
        if not ok:
            return False
        if self.sys.early_release:
            # Chiller-style: contended (hot) locks released right after the
            # ops, before the commit rounds
            for k, _, _ in prof.hot_ops:
                lk = self.locks.get(k)
                if lk is not None:
                    lk.release(ts, self.sim)
        if len(prof.participants) > 1 or any(
                n != prof.home for _, n, _ in prof.hot_ops):
            self._charge("commit_2pc", 2 * self.T.t_2pc_round)
            # prepare + decision bursts serialize on the coordinator's NIC
            yield from self._msg_nic(prof.home,
                                     2 * max(1, len(prof.participants) - 1))
            yield ("delay", 2 * self.T.t_2pc_round)
        else:
            self._charge("local_work", self.T.t_commit_local)
            yield ("delay", self.T.t_commit_local)   # log flush, locks held
        self.release_all(prof, ts, include_hot=True)
        return True

    # ------------------------------------------------ batched admission --
    def _run_hot_batched(self, node: int, prof: TxnProfile, t0: float):
        """One hot txn's life under batched admission: join the node's
        switch-batcher, resume when its round returns, commit.  The round
        resumes every member with its (service_start, service_end) sim
        timestamps (``_switch_round``'s return value), which stamp the
        member's trace spans without adding a single event."""
        t_join = self.sim.now
        svc = yield ("join", self.batchers[node], (prof, t_join))
        now = self.sim.now
        if now >= self.warmup:
            self._account(prof, t0)
            if self.tracer is not None:
                tr = self.tracer.start(f"{prof.kind}:{prof.klass}")
                if tr is not None:
                    t_s0, t_s1 = svc if isinstance(svc, tuple) else (t_join,
                                                                     now)
                    tr.add_span("admission", t0, t_join)
                    tr.add_span("batcher-join", t_join, t_s0)
                    tr.add_span("switch-service", t_s0, t_s1)
                    tr.add_span("commit", t_s1, now)
        self._occ_credits.adjust(-1, now)
        yield ("release", self.credits[node])

    # ------------------------------------------------ open-loop serving --
    def _source(self, node: int):
        """Open-loop Poisson client source for one node: arrivals at
        ``open_loop_rate / n_nodes`` per second, independent of service
        progress (unlike the closed-loop workers, which admit only after
        the previous txn is handed off).  An arrival that finds
        ``admit_queue_cap`` waiters on the node's admit pool is shed at
        the door: counted as dropped, zero further events — which is what
        keeps a million-arrival saturated run tractable."""
        rate = self.open_loop_rate / self.n_nodes
        c_arr = self.metrics.counter(C_ARRIVALS, help="client arrivals")
        c_drop = self.metrics.counter(C_DROPPED, help="arrivals shed at "
                                      "admission")
        while True:
            yield ("delay", float(self.rng.exponential(1.0 / rate)))
            if self.max_arrivals is not None \
                    and self.arrivals >= self.max_arrivals:
                return
            self.arrivals += 1
            c_arr.inc()
            prof = self._demote_if_evicted(self._draw(node))
            if self.admit_queue_cap and \
                    len(self.admits[node].queue) >= self.admit_queue_cap:
                self.dropped += 1
                c_drop.inc()
                continue
            self.sim.spawn(self._serve_arrival(node, prof, self.sim.now))

    def _serve_arrival(self, node: int, prof: TxnProfile, t_arr: float):
        """One client txn's life in open-loop mode, latency measured from
        ARRIVAL (so admission queueing is part of the tail — the number an
        SLO talks about).  Per-class admission rides the existing pools:
        every txn occupies an admit slot (server worker capacity); a hot
        txn under batching releases it at batcher hand-off (commit-on-
        send) and is bounded by the per-node switch credit pool instead;
        cold/warm txns hold the slot through 2PL/2PC retries to commit."""
        sim, T = self.sim, self.T
        yield ("acquire", self.admits[node])
        self._occ_admit.adjust(+1, sim.now)
        if sim.now >= self.warmup:
            self._hist_phase("admission").observe(sim.now - t_arr)
            self.metrics.histogram(
                H_ADMISSION_WAIT, help="arrival to admit-slot wait",
                klass=prof.klass).observe(sim.now - t_arr)
        yield ("delay", T.t_client)
        if self.batching and prof.klass == "hot":
            yield ("acquire", self.credits[node])
            self._occ_credits.adjust(+1, sim.now)
            sim.spawn(self._run_hot_batched(node, prof, t_arr))
            self._occ_admit.adjust(-1, sim.now)
            yield ("release", self.admits[node])
            return
        self._ts += 1
        ts = self._ts
        committed = yield from self.run_txn(prof, ts, node)
        attempt = 1
        while not committed:
            self.aborts[prof.klass] += 1
            yield ("delay", float(self.rng.exponential(
                min(T.t_backoff * attempt, 100e-6))))
            if self.sys.drop_on_abort:
                break
            attempt += 1
            ts = self._retry_ts(ts)
            committed = yield from self.run_txn(prof, ts, node)
        if committed and sim.now >= self.warmup:
            self._account(prof, t_arr)
        self._occ_admit.adjust(-1, sim.now)
        yield ("release", self.admits[node])

    def _nic_xfer(self, node: int, n_pkts: int):
        """Serialize ``n_pkts`` hot-txn packets through the node's NIC:
        exclusive use of the port for ``n_pkts * pkt_bytes /
        nic_line_rate`` seconds.  Concurrent in-flight rounds from one
        node queue here — the NIC is a physical serialization point that
        pipelining cannot overlap away."""
        t0 = self.sim.now
        yield ("acquire", self.nics[node])
        self._charge("nic_wait", self.sim.now - t0)
        wire = n_pkts * self.T.pkt_bytes / self.sys.nic_line_rate
        self._charge("nic_wire", wire)
        yield ("delay", wire)
        yield ("release", self.nics[node])

    def _msg_nic(self, node: int, n_msgs: int):
        """Cold-path message burst (remote tuple access, 2PC round)
        through the node's NIC — only with an explicit NIC; otherwise
        wire time stays folded into rtt_node/t_2pc_round and this yields
        nothing (zero events, the pre-NIC model)."""
        if self.sys.nic_line_rate > 0:
            yield from self._nic_xfer(node, n_msgs)

    def _reconfig_gate(self):
        """Hold switch traffic while a re-placement epoch (or a failover
        in progress) has the switch paused.  Yields nothing when no pause
        is active — with the controller off this is a no-op call, adding
        zero events.  The wait is charged to the cause of the pause:
        ``reconfig_wait`` (the default, label-identical to pre-durability
        runs) or ``failover_wait`` while a crashed switch's standby is
        being promoted."""
        wait = self.pause_until - self.sim.now
        if wait > 0:
            self._charge(f"{self.pause_reason}_wait", wait)
            yield ("delay", wait)

    def _ingress_admit(self, n_pkts: int):
        """ONE shared ingress pipeline across ALL nodes: admission is
        bounded at ``switch_service_rate`` packets/s globally, so
        aggregate hot throughput caps at the switch no matter how many
        NICs feed it (the Tofino's single-pipeline bound)."""
        t0 = self.sim.now
        yield ("acquire", self.ingress)
        self._charge("switch_ingress_wait", self.sim.now - t0)
        svc = n_pkts / self.sys.switch_service_rate
        self._charge("switch_ingress", svc)
        yield ("delay", svc)
        yield ("release", self.ingress)

    def _ingress_admit_sharded(self, profs):
        """Multi-switch admission (``n_switches > 1`` only): each shard
        has its OWN ingress pipeline, so a burst splits across switches
        and aggregate admission scales with the shard count.  A txn's
        packet visits every switch its hot ops touch (cross-shard txns
        occupy several pipelines); shards are admitted in id order —
        deterministic, and shard-disjoint bursts queue independently."""
        for sw in range(self.sys.n_switches):
            cnt = sum(1 for p in profs if sw in p.shards)
            if cnt == 0:
                continue
            t0 = self.sim.now
            yield ("acquire", self.ingresses[sw])
            self._charge("switch_ingress_wait", self.sim.now - t0)
            svc = cnt / self.sys.switch_service_rate
            self._charge("switch_ingress", svc)
            yield ("delay", svc)
            yield ("release", self.ingresses[sw])

    def _read_only(self, prof: TxnProfile) -> bool:
        """True when ``read_path`` serves this profile from the data plane
        as a pure read: every hot op is mode "S".  Off ⇒ always False, so
        every charge below is byte-identical to the pre-read-tier model."""
        return (self.sys.read_path and bool(prof.hot_ops)
                and all(m == "S" for _, _, m in prof.hot_ops))

    def _interswitch_hops(self, profs):
        """Total extra switch hops a set of txns pays: each cross-shard
        txn traverses ``len(shards) - 1`` inter-switch links."""
        return sum(len(p.shards) - 1 for p in profs if len(p.shards) > 1)

    def _switch_round(self, node: int, items):
        """Service one batch: a single switch round (one ``rtt_switch``)
        carrying every member; pipeline occupancy is per-txn ``t_pipe``
        plus the summed recirculations of multipass members under ONE
        pipeline-lock hold.  With ``nic_line_rate > 0`` the round also
        pays TX wire time before flight and RX wire time after, each
        under the node's exclusive NIC resource; with
        ``switch_service_rate > 0`` the request burst additionally queues
        at the shared switch ingress."""
        T = self.T
        # gather delay measured up to the gate: a migration pause is
        # charged once (reconfig_wait), not again per member as batch_wait
        t_start = self.sim.now
        yield from self._reconfig_gate()
        for _, t_join in items:
            self._charge("batch_wait", t_start - t_join)
        if self.sim.now >= self.warmup:
            h_join = self._hist_phase("batcher-join")
            for _, t_join in items:
                h_join.observe(max(0.0, t_start - t_join))
        self._charge("switch", T.rtt_switch)
        if self.sys.nic_line_rate > 0:
            yield from self._nic_xfer(node, len(items))       # TX burst
        yield ("delay", T.rtt_switch / 2)
        if self.sys.switch_service_rate > 0:
            if self.sys.n_switches > 1:
                yield from self._ingress_admit_sharded(
                    [p for p, _ in items])
            else:
                yield from self._ingress_admit(len(items))
        if self.sys.n_switches > 1:
            hops = self._interswitch_hops([p for p, _ in items])
            if hops:
                hop = hops * T.t_interswitch
                self._charge("interswitch", hop)
                yield ("delay", hop)
        n_read = sum(1 for p, _ in items if self._read_only(p))
        if n_read:
            self._charge("read_pipe", T.t_read_pipe * n_read)
        base = T.t_pipe * (len(items) - n_read) + T.t_read_pipe * n_read
        rc = T.t_recirc_fast if self.sys.fast_recirc else T.t_recirc
        # read members never recirculate: a READ-only hot txn transits in
        # one pass regardless of its slot sequence (nothing to lock)
        extra = sum((p.passes - 1) * rc for p, _ in items
                    if p.passes > 1 and not self._read_only(p))
        if extra:
            t0 = self.sim.now
            yield ("acquire", self.pipe)
            self._charge("pipe_lock_wait", self.sim.now - t0)
            self._charge("recirc", extra)
            self._busy_add("pipeline", base + extra)
            yield ("delay", base + extra)
            yield ("release", self.pipe)
        else:
            self._busy_add("pipeline", base)
            yield ("delay", base)
        yield ("delay", T.rtt_switch / 2)
        if self.sys.nic_line_rate > 0:
            yield from self._nic_xfer(node, len(items))       # RX burst
        self.rounds += 1
        self.round_txns += len(items)
        self._sends_since_ckpt += len(items) - n_read
        if self.sim.now >= self.warmup:
            self._hist_phase("switch-service").observe(self.sim.now - t_start)
        # members resume with the service window (trace span stamps)
        return (t_start, self.sim.now)

    def switch_txn(self, prof: TxnProfile, node: Optional[int] = None):
        T = self.T
        node = prof.home if node is None else node
        yield from self._reconfig_gate()
        self._charge("switch", T.rtt_switch)
        if self.sys.nic_line_rate > 0:
            yield from self._nic_xfer(node, 1)                # TX
        yield ("delay", T.rtt_switch / 2)
        if self.sys.switch_service_rate > 0:
            if self.sys.n_switches > 1:
                yield from self._ingress_admit_sharded([prof])
            else:
                yield from self._ingress_admit(1)
        if self.sys.n_switches > 1 and len(prof.shards) > 1:
            hop = (len(prof.shards) - 1) * T.t_interswitch
            self._charge("interswitch", hop)
            yield ("delay", hop)
        if self._read_only(prof):
            # the read tier: single transit at the read-path rate, no
            # pipeline lock, no recirculation, no checkpointable send
            self._charge("read_pipe", T.t_read_pipe)
            self._busy_add("pipeline", T.t_read_pipe)
            yield ("delay", T.t_read_pipe)
            yield ("delay", T.rtt_switch / 2)
            if self.sys.nic_line_rate > 0:
                yield from self._nic_xfer(node, 1)            # RX
            return
        if prof.passes == 1:
            self._busy_add("pipeline", T.t_pipe)
            yield ("delay", T.t_pipe)
        else:
            # multi-pass: pipeline lock + recirculations
            t0 = self.sim.now
            yield ("acquire", self.pipe)
            self._charge("pipe_lock_wait", self.sim.now - t0)
            rc = T.t_recirc_fast if self.sys.fast_recirc else T.t_recirc
            self._charge("recirc", (prof.passes - 1) * rc)
            self._busy_add("pipeline", T.t_pipe + (prof.passes - 1) * rc)
            yield ("delay", T.t_pipe + (prof.passes - 1) * rc)
            yield ("release", self.pipe)
        yield ("delay", T.rtt_switch / 2)
        if self.sys.nic_line_rate > 0:
            yield from self._nic_xfer(node, 1)                # RX
        self._sends_since_ckpt += 1

    # ------------------------------------- in-flight conflict detector --
    def _ea_admit(self, ts: int, intent) -> bool:
        """Register this txn's lock-intent set with the 'switch' at 2PC
        begin.  The registrant aborts early ONLY when it is already
        *doomed*: some intended key is currently locked incompatibly by
        another txn, so under NO_WAIT it would die at that lock anyway —
        after burning its round-trips.  (A mere intent overlap is NOT a
        conflict: the intent window is much wider than the lock-hold
        window, and killing on it serializes txns that would have
        interleaved fine.)  WAIT_DIE: the younger dies — an older
        registrant WOUNDS the younger lock holder instead (it aborts at
        its next op tick, freeing the lock early; Wound-Wait-style aging
        grafted onto the retry discipline).  Returns False when the
        registrant itself must abort."""
        wd = self.sys.protocol == "WAIT_DIE"
        for k, _, m in intent:
            lk = self.locks.get(k)
            if lk is None or not lk.owners:
                continue
            for ots, om in list(lk.owners.items()):
                if ots == ts or (m == "S" and om == "S"):
                    continue
                self.conflicts_detected += 1
                if wd and ts < ots:
                    self._ea_wound(ots)
                    continue
                return False                   # registrant is doomed
        self._ea_inflight[ts] = (
            frozenset(k for k, _, m in intent if m == "X"),
            frozenset(k for k, _, m in intent if m == "S"))
        return True

    def _ea_on_grant(self, ts: int, key, mode: str):
        """The switch observes a contended lock grant and multicasts
        early aborts to every in-flight txn whose registered intent is
        now doomed to die at this lock (NO_WAIT), or that this holder
        out-ages (WAIT_DIE) — they abort at their next op tick instead
        of completing their remaining round-trips first."""
        wd = self.sys.protocol == "WAIT_DIE"
        for ots, (ow, orr) in list(self._ea_inflight.items()):
            if ots == ts:
                continue
            if not (key in ow or (mode == "X" and key in orr)):
                continue
            if wd and ots < ts:
                continue          # older peer ages into priority; spare it
            self.conflicts_detected += 1
            self._ea_wound(ots)

    def _ea_wound(self, ts: int):
        self._ea_inflight.pop(ts, None)
        self._ea_wounded.add(ts)
        self.ea_wounds += 1

    def _ea_release(self, ts: int):
        self._ea_inflight.pop(ts, None)
        self._ea_wounded.discard(ts)

    def _retry_ts(self, ts: int) -> int:
        """Timestamp for a retry attempt.  Default: a fresh ts (the
        pre-contention model, event for event).  With the early-abort
        mirror on under WAIT_DIE, retries KEEP the first attempt's ts —
        the txn ages into priority (the functional RetryPolicy's
        discipline), which is what makes the wound path reachable and
        rules out livelock between peers."""
        if self._ea_on and self.sys.protocol == "WAIT_DIE":
            return ts
        self._ts += 1
        return self._ts

    def cold_part(self, prof: TxnProfile, ts: int, include_hot=False):
        T = self.T
        ops = list(prof.cold_ops)
        hot_keys = {k for k, _, _ in prof.hot_ops}
        if include_hot:
            ops = ops + list(prof.hot_ops)
        if self._ea_on and ops:
            # the switch only sees LOCK-intent: keys that would actually
            # take a lock (hot under include_hot, or pre-contended) — the
            # same contention model the lock layer itself applies, so
            # uniform cold keys can never false-positive an abort
            intent = [(k, n, m) for k, n, m in ops
                      if (include_hot and k in hot_keys)
                      or self._contended(k)]
            if intent and not self._ea_admit(ts, intent):
                # early abort at begin: pay only the notify multicast, no
                # round-trips, no locks taken, nothing wasted
                self.early_aborts += 1
                self._charge("early_abort_notify", T.t_abort_notify)
                yield ("delay", T.t_abort_notify)
                return False
        if include_hot and hot_keys and self.sys.kind == "lmswitch":
            # NetLock: ONE batched lock request for all hot keys handled in
            # the switch data plane (half node RTT); deny -> abort
            yield ("delay", T.rtt_switch)
            for key, node, mode in prof.hot_ops:
                granted = yield ("lock", self.lock_of(key), mode, ts)
                if not granted:
                    self.release_all(prof, ts, include_hot=True)
                    return False
            for key, node, mode in prof.hot_ops:
                yield ("delay", T.t_local_op if node == prof.home
                       else T.rtt_node)
            ops = list(prof.cold_ops)
        done = 0
        for key, node, mode in ops:
            if self._ea_on and ts in self._ea_wounded:
                # a mid-flight wound landed: abort now, before the next
                # round-trip — work already done is wasted, locks free early
                self.early_aborts += 1
                self.wasted_ops += done
                self._charge("early_abort_notify", T.t_abort_notify)
                yield ("delay", T.t_abort_notify)
                self.release_all(prof, ts, include_hot=include_hot)
                return False
            hot = include_hot and key in hot_keys
            if node == prof.home:
                self._charge("local_work", T.t_local_op)
                yield ("delay", T.t_local_op)
            else:
                self._charge("remote_access", T.rtt_node)
                yield from self._msg_nic(prof.home, 1)   # request TX
                yield ("delay", T.rtt_node)
                yield from self._msg_nic(prof.home, 1)   # response RX
            if hot or self._contended(key):
                t0 = self.sim.now
                granted = yield ("lock", self.lock_of(key), mode, ts)
                self._charge("lock_acquisition", self.sim.now - t0)
                if not granted:
                    self.wasted_ops += done
                    self.release_all(prof, ts, include_hot=include_hot)
                    return False
                if self._ea_on:
                    self._ea_on_grant(ts, key, mode)
            done += 1
        return True

    def _contended(self, key) -> bool:
        # cold uniform keys: conflict probability ~ 1e-5; skip simulating
        # their lock objects (latency is still charged)
        return key in self.locks

    def release_all(self, prof: TxnProfile, ts: int, include_hot=False):
        keys = [k for k, _, _ in prof.cold_ops]
        if include_hot:
            keys += [k for k, _, _ in prof.hot_ops]
        for k in keys:
            lk = self.locks.get(k)
            if lk is not None:
                lk.release(ts, self.sim)
        if self._ea_on:
            self._ea_release(ts)

    # -------------------------------------------- adaptive re-placement --
    def _controller(self):
        """Epoch controller: periodically re-place the hot set.  The
        tracker-driven (adaptive) controller fires every
        ``reconfig_interval`` seconds and estimates the hot set from
        observed accesses; the oracle fires AT each drift-phase boundary
        and reads the generator's ground truth — the per-epoch upper
        bound adaptive placement is judged against."""
        interval = self.sys.reconfig_interval
        period = getattr(self.dynamic, "period", None)
        while True:
            if self.oracle and period:
                nxt = (int(self.sim.now / period) + 1) * period
                yield ("delay", max(nxt - self.sim.now, 1e-9))
            else:
                yield ("delay", interval)
            new_hi = self._recompute_placement()
            if new_hi is None:
                continue
            old_keys = set(self.hot_index.placement.slot)
            new_keys = set(new_hi.placement.slot)
            if new_keys == old_keys:
                # hot-set membership unchanged: nothing to migrate, no
                # switch pause — steady-state epochs are free, so a short
                # interval tracks drift without constant downtime
                continue
            if self.sys.gate_t_reconfig > 0 and \
                    not self._gate_passes(new_hi):
                # cost-benefit gate (mirror of the functional
                # EpochController): the projected hot-share gain over the
                # next epoch does not pay for the pause — skip
                self.reconfigs_gated += 1
                continue
            # the migration pauses the switch: drain + register
            # copy-out/copy-in + replicated index swap (t_reconfig);
            # evicted keys stay readable from their home stores meanwhile
            # (partial availability, when enabled)
            self._evicted_during_pause = old_keys - new_keys
            self.pause_until = self.sim.now + self.T.t_reconfig
            self._charge("reconfig", self.T.t_reconfig)
            yield ("delay", self.T.t_reconfig)
            self._evicted_during_pause = set()
            self.hot_index = new_hi
            self.reconfigs += 1

    def _gate_passes(self, new_hi: HotIndex) -> bool:
        """Sim mirror of ``EpochController.projected_gain``: over the
        observed trace window, the fraction of txns that are fully hot
        under the new placement minus the fraction under the current one
        is the throughput share the migration recovers; scaled by the
        epoch length it must beat the ``gate_t_reconfig`` pause (both
        sides are per-txn-rate, so the rate cancels)."""
        traces = self._last_traces
        if not traces:
            return True
        old_slot = self.hot_index.placement.slot
        new_slot = new_hi.placement.slot
        old_hot = sum(1 for tr in traces
                      if tr and all(k in old_slot for k, _ in tr))
        new_hot = sum(1 for tr in traces
                      if tr and all(k in new_slot for k, _ in tr))
        gain = (new_hot - old_hot) / len(traces) \
            * self.sys.reconfig_interval
        return gain > self.sys.gate_t_reconfig

    # ------------------------------------------------ durability mirror --
    def _ckpt_daemon(self):
        """Incremental checkpoints feeding the warm standby: each one
        resets the replay debt a failover would pay.  The checkpoint
        itself is diff-only and off the critical path (no pause)."""
        while True:
            yield ("delay", self.sys.ckpt_interval)
            self._sends_since_ckpt = 0
            self.ckpts_taken += 1

    def _crash_daemon(self):
        """One switch crash at ``crash_at``: the warm standby is promoted
        behind a pause of ``t_failover`` (detection + route flip) plus
        ``t_replay_send`` per send logged since the last checkpoint —
        the functional ``Cluster.fail_over`` bounded-recovery contract,
        priced."""
        yield ("delay", self.sys.crash_at)
        replayed = self._sends_since_ckpt
        outage = self.T.t_failover + replayed * self.T.t_replay_send
        self.failover = dict(at=self.sim.now, outage=outage,
                             replayed=replayed)
        self.pause_until = max(self.pause_until, self.sim.now + outage)
        self.pause_reason = "failover"
        self._charge("failover", outage)
        yield ("delay", outage)
        self.pause_reason = "reconfig"
        self._sends_since_ckpt = 0

    def _recompute_placement(self) -> Optional[HotIndex]:
        k = self.reconfig_top_k
        if k is None:
            k = len(self.hot_index.placement.slot)
        if self.switch_cfg is not None:
            k = min(k, self.switch_cfg.total_slots)
        if self.oracle:
            txns = [self.dynamic.sample(self._ctl_rng, self.sim.now,
                                        home=i % self.n_nodes)
                    for i in range(512)]
            traces = [[(kk, o) for o, kk, _ in t.ops] for t in txns]
            hot = self.dynamic.hot_keys_at(self.sim.now)[:k]
        else:
            traces = self.tracker.window_traces()
            hot = self.tracker.top_k(k)
            self.tracker.advance_epoch()
        self._last_traces = traces      # the gate's evidence window
        placement = layout_for_hotset(traces, hot, self.switch_cfg,
                                      seed=self._layout_seed)
        if not placement.slot:
            return None
        return HotIndex(placement)

    # --------------------------------------------------------------- run --
    def run(self):
        self.sim = Sim()
        self.batchers = [Batcher(self.sim, partial(self._switch_round, node),
                                 self.sys.batch_window, self.sys.max_batch,
                                 depth=self.sys.pipeline_depth)
                         for node in range(self.n_nodes)]
        self.credits = [Resource(self.hot_credits)
                        for _ in range(self.n_nodes)]
        self.nics = [Resource(1) for _ in range(self.n_nodes)]
        # one ingress pipeline per switch shard; N=1 keeps the single
        # shared-ingress model (self.ingress aliases shard 0)
        self.ingresses = [Resource(1)
                          for _ in range(max(1, self.sys.n_switches))]
        self.ingress = self.ingresses[0]         # shared switch ingress
        self.tracer = Tracer(clock=lambda: self.sim.now, capacity=256)
        if self.open_loop_rate > 0:
            # open-loop serving: Poisson sources replace the closed-loop
            # workers; admit pool sized like the worker pool it displaces
            self.admits = [Resource(self.admit_per_node or self.wpn)
                           for _ in range(self.n_nodes)]
            for node in range(self.n_nodes):
                self.sim.spawn(self._source(node),
                               delay=float(self.rng.random() * 1e-6))
        else:
            for node in range(self.n_nodes):
                for w in range(self.wpn):
                    g = self.worker(node)
                    self.sim.spawn(g, delay=float(self.rng.random() * 1e-6))
        if self._reconfig_on:
            self.sim.spawn(self._controller())
        if self.sys.ckpt_interval > 0:
            self.sim.spawn(self._ckpt_daemon())
        if self.sys.crash_at > 0:
            self.sim.spawn(self._crash_daemon())
        self.sim.run(self.sim_time)
        window = self.sim_time - self.warmup
        tput = self.commits["total"] / window
        out = dict(throughput=tput,
                   commits=dict(self.commits), aborts=dict(self.aborts),
                   breakdown=dict(self.breakdown),
                   switch_rounds=self.rounds,
                   avg_batch=self.round_txns / self.rounds
                   if self.rounds else 0.0)
        for k in self.lat_n:
            out[f"lat_{k}"] = self.lat_sum[k] / max(self.lat_n[k], 1)
        self._finish_metrics(window)
        if self.open_loop_rate > 0:
            # open-loop-only result keys (a new mode: the default result
            # dict stays frozen for the golden pins)
            out["open_loop"] = dict(
                offered_rate=self.open_loop_rate, arrivals=self.arrivals,
                dropped=self.dropped, served=self.commits["total"],
                achieved_rate=self.commits["total"] / window)
            out["latency"] = {
                k: dict(p50=h.percentile(0.50), p99=h.percentile(0.99),
                        p999=h.percentile(0.999), mean=h.mean,
                        count=h.count)
                for k, h in sorted((k, h) for k, h in self._h_lat.items()
                                   if isinstance(k, str))}
            out["utilization"] = self._utilization(window)
        # durability keys appear only when the knob is on — the default
        # result dict stays byte-identical to the golden pins
        if self.sys.crash_at > 0:
            out["failover"] = self.failover
            out["ckpts_taken"] = self.ckpts_taken
        if self.sys.early_abort:
            # contention keys appear only when the knob is on (same golden-
            # pin discipline as the durability keys above)
            out["early_abort"] = dict(
                early_aborts=self.early_aborts, wounds=self.ea_wounds,
                conflicts_detected=self.conflicts_detected,
                wasted_ops=self.wasted_ops)
        if self.sys.gate_t_reconfig > 0:
            out["reconfigs_gated"] = self.reconfigs_gated
        if self.sys.partial_availability:
            out["partial_served"] = self.partial_served
        if self.dynamic is not None:
            # dynamic-mode keys only — the static result dict must stay
            # byte-identical to the golden pins
            out["reconfigs"] = self.reconfigs
            out["hot_rate"] = self.commits["hot"] / window
            # warm txns also ride the switch (their hot sub-txn); on
            # workloads that are warm-by-construction (TPC-C: every txn
            # has cold rows) switch_rate is the drift-sensitive metric
            out["switch_rate"] = (self.commits["hot"] +
                                  self.commits["warm"]) / window
            phases: Dict[int, Dict[str, int]] = {}
            for (ph, kl), c in sorted(self.phase_commits.items()):
                d = phases.setdefault(ph, {"total": 0})
                d[kl] = d.get(kl, 0) + c
                d["total"] += c
            out["phase_commits"] = phases
            out["phase_hot_rate"] = {
                ph: d.get("hot", 0) / max(d["total"], 1)
                for ph, d in phases.items()}
            out["phase_switch_rate"] = {
                ph: (d.get("hot", 0) + d.get("warm", 0)) / max(d["total"], 1)
                for ph, d in phases.items()}
        return out

    def _utilization(self, window: float) -> dict:
        """Per-resource utilization over the post-warmup window: busy (or
        occupied) seconds / (window x capacity).  Credit/admit pools use
        the time-weighted occupancy integral over the whole run (their
        level carries across the warmup boundary)."""
        util = {}
        if self.sys.nic_line_rate > 0:
            util["nic"] = self.breakdown["nic_wire"] / (window * self.n_nodes)
        if self.sys.switch_service_rate > 0:
            util["switch_ingress"] = self.breakdown["switch_ingress"] / \
                (window * max(1, self.sys.n_switches))
        util["pipeline"] = self._busy["pipeline"] / \
            (window * max(1, self.sys.pipeline_locks))
        pool = self.hot_credits * self.n_nodes
        util["credits"] = self._occ_credits.integral(self.sim.now) / \
            (self.sim_time * pool) if pool else 0.0
        if self.open_loop_rate > 0:
            slots = (self.admit_per_node or self.wpn) * self.n_nodes
            util["admit"] = self._occ_admit.integral(self.sim.now) / \
                (self.sim_time * slots) if slots else 0.0
        return util

    def _finish_metrics(self, window: float):
        """End-of-run registry refresh: utilization gauges + headline
        counters, so an export scraped after ``run()`` is complete."""
        g = self.metrics.gauge
        for res, v in self._utilization(window).items():
            g(G_UTILIZATION, help="busy fraction over the measured window",
              resource=res).set(v)
        self.metrics.counter("txns_committed_total",
                             help="committed txns")._set(
                                 self.commits["total"])
        self.metrics.counter("txn_aborts_total", help="aborts")._set(
            sum(self.aborts.values()))
        self.metrics.counter(
            "txn_wasted_ops_total",
            help="ops executed by eventually-aborted attempts")._set(
                self.wasted_ops)
        self.metrics.counter(
            "txn_early_aborts_total",
            help="in-flight conflicts aborted before completion")._set(
                self.early_aborts)
        g("switch_rounds", help="batched switch rounds").set(self.rounds)
