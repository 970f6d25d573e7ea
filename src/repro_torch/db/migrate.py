"""Epoch re-placement and switch migration (copy of
``repro/db/migrate.py``) — the control plane that turns the offline
hot-set pipeline (detect_hotset -> make_layout -> HotIndex) into a living
subsystem.

The paper bakes the placement into the switch program at deploy time and
leaves dynamic re-placement open (§3.1/§4); TurboKV shows in-switch state
can be re-balanced at runtime.  Here an ``EpochController`` watches a
``HeatTracker`` (repro_torch.core.heat) fed from the DBMS hot path and, every
``interval`` transactions, re-runs hot-set detection + declustered layout
on the observed trace window, diffs the placements, and executes the
migration protocol on the functional cluster:

  1. **drain** — the caller (``Cluster.run_batch``) flushes any pending
     hot group before the controller fires, so no switch txn is in
     flight across the boundary (hot txns are commit-on-send, so a drain
     is just a group flush, never an abort);
  2. **begin** — every node WAL-logs ``migrate_begin`` (the migration is
     a distributed txn with its own tid);
  3. **evict** — tuples leaving the switch have their live register
     values read back into their home node's store, WAL-logged as
     ordinary ``write`` entries under the migration tid (so node-crash
     recovery replays them);
  4. **load** — the new register file is rebuilt: tuples staying hot
     carry their value from the old (stage, reg) slot, newly-hot tuples
     are read from their home node's store;
  5. **swap** — the replicated ``HotIndex`` is atomically replaced on
     every node (one reference assignment per node — between transaction
     boundaries, so no reader ever sees a half-swapped index);
  6. **end** — every node WAL-logs ``migrate_end`` + ``commit``; the
     cluster re-snapshots the offload (``snapshot_offload``), making the
     migration a recovery checkpoint: ``crash_switch_and_recover``
     replays only switch sends logged AFTER each node's last
     ``migrate_end``, against the migration-time register snapshot —
     recovery is exact across any number of migration boundaries.

With ``interval=0`` the controller never fires and an attached tracker
only observes: results, registers and WALs are byte-identical to a
cluster without the subsystem (pinned in tests/test_adaptive.py).
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.heat import HeatTracker
from repro_torch.core.hotset import HotIndex, layout_for_hotset
from repro_torch.core.layout import Placement, make_layout
from repro_torch.db.txn import node_of

# migration tids live far above workload tids so WAL readers can tell
# them apart (workload tids are a small itertools.count)
_MIG_TID = itertools.count(1 << 40)


@dataclass
class MigrationPlan:
    """Diff between two placements, in deterministic (sorted-key) order.
    Slots are (switch, stage, reg) — a move may rebalance a tuple across
    shards, not just across stages."""
    evict: List[Tuple[int, Tuple[int, int, int]]]  # key, old slot
    load: List[Tuple[int, Tuple[int, int, int]]]   # key, new slot
    moved: List[Tuple[int, Tuple[int, int, int], Tuple[int, int, int]]]
    stay: int                                      # same slot in both

    @property
    def n_changed(self):
        return len(self.evict) + len(self.load) + len(self.moved)

    def summary(self) -> Dict[str, int]:
        return dict(evict=len(self.evict), load=len(self.load),
                    moved=len(self.moved), stay=self.stay)


def diff_placements(old: Placement, new: Placement) -> MigrationPlan:
    evict, load, moved = [], [], []
    stay = 0
    for k in sorted(old.slot):
        if k not in new.slot:
            evict.append((k, old.slot[k]))
    for k in sorted(new.slot):
        ns = new.slot[k]
        os_ = old.slot.get(k)
        if os_ is None:
            load.append((k, ns))
        elif os_ != ns:
            moved.append((k, os_, ns))
        else:
            stay += 1
    return MigrationPlan(evict, load, moved, stay)


def migrate(cluster, new_index: HotIndex,
            plan: Optional[MigrationPlan] = None) -> MigrationPlan:
    """Execute the migration protocol on a functional ``Cluster``.

    The caller must have flushed buffered hot groups (``run_batch``
    flushes before invoking the controller; the per-txn path is trivially
    drained between txns); the async result plane is drained HERE — a
    migration is a consistency point, so every outstanding
    ``PendingBatch`` is materialized (WAL ``switch_result`` entries
    filled) before the registers are touched or the index swapped."""
    t0 = time.perf_counter()
    cluster.drain()

    old_index = cluster.hot_index
    old = old_index.placement if old_index is not None else Placement({})
    if plan is None:
        plan = diff_placements(old, new_index.placement)
    mig_tid = next(_MIG_TID)
    epoch = cluster.stats["migrations"]

    for n in cluster.nodes:
        n.log("migrate_begin", mig_tid, epoch=epoch, **plan.summary())

    # evict: live register values return to their home node's store.
    # regs3 views the register file as [N, S, R] regardless of shard
    # count, so slot indexing is uniform
    regs = np.asarray(cluster.switch.read_all())
    regs3 = regs if regs.ndim == 3 else regs[None]
    for key, (sw, s, r) in plan.evict:
        n = cluster.nodes[node_of(key)]
        val = int(regs3[sw, s, r])
        n.log("write", mig_tid, key=key, old=n.store[key], new=val)
        n.store[key] = val

    # crash point: between migrate_begin and migrate_end the evicted keys
    # are authoritative in their home stores (partial availability) and
    # the old placement still stands — recovery abandons the migration
    cluster._fault("mid_migration", evicted=[k for k, _ in plan.evict],
                   mig_tid=mig_tid)

    # load: rebuild the register file under the new placement.  Staying
    # and moved tuples carry their live switch value (a cross-shard move
    # is just a copy between planes); newly-hot tuples come from their
    # home node's store.
    new_regs = np.zeros(regs3.shape, np.int32)
    for key, (sw, s, r) in new_index.placement.slot.items():
        o = old.slot.get(key)
        if o is not None:
            new_regs[sw, s, r] = regs3[o[0], o[1], o[2]]
        else:
            new_regs[sw, s, r] = cluster.nodes[node_of(key)].store[key]
    cluster.switch.load_registers(
        new_regs if regs.ndim == 3 else new_regs[0])

    # swap the replicated index (the cluster setter fans the new copy
    # out to every node atomically), log the boundary, then checkpoint
    cluster.hot_index = new_index
    for n in cluster.nodes:
        n.log("migrate_end", mig_tid, epoch=epoch)
        n.log("commit", mig_tid)
    # migration-boundary checkpoint: diff-only, so its cost is bounded by
    # the plan size (+ writes since the previous checkpoint), not the
    # hot-set size — the incremental-migration follow-up subsumed
    cluster.checkpoint(reason="migration")
    cluster.stats["migrations"] += 1
    cluster.stats["migrated_tuples"] += plan.n_changed
    if getattr(cluster, "metrics", None) is not None:
        cluster.metrics.histogram(
            "migration_seconds", help="migration protocol wall time",
        ).observe(time.perf_counter() - t0)
    return plan


class EpochController:
    """Periodic re-placement controller for a functional ``Cluster``.

    Attaches itself to the cluster; ``Cluster.run`` / ``run_batch`` call
    ``note()`` once per admitted transaction and invoke ``reconfigure()``
    (after draining) when it returns True.  ``interval=0`` disables the
    controller entirely.

    ``top_k`` defaults to the size of the cluster's current hot set and
    is clamped to the switch's register capacity (over-capacity layouts
    raise in ``make_layout``).

    Hysteresis / cost-benefit gating: with ``gate_t_reconfig > 0`` a due
    migration executes only when its projected benefit beats the pause it
    costs — the switch is unavailable for ``gate_t_reconfig`` seconds per
    migration (~``gate_t_reconfig * gate_txn_rate`` forgone txns), while
    the benefit is the extra fully-hot txns the new placement would have
    admitted over the next epoch, projected from the tracker's observed
    window.  The default (``gate_t_reconfig=0``) disables the gate
    entirely — byte-identical to the ungated controller (pinned in
    tests/test_hotpath.py)."""

    def __init__(self, cluster, tracker: HeatTracker, interval: int,
                 top_k: Optional[int] = None, layout_fn=make_layout,
                 seed: int = 0, min_change: int = 1,
                 gate_t_reconfig: float = 0.0,
                 gate_txn_rate: float = 100_000.0):
        self.cluster = cluster
        self.tracker = tracker
        self.interval = int(interval)
        self.top_k = top_k
        self.layout_fn = layout_fn
        self.seed = seed
        self.min_change = min_change   # skip no-op migrations below this
        self.gate_t_reconfig = float(gate_t_reconfig)
        self.gate_txn_rate = float(gate_txn_rate)
        self._since = 0
        self.epochs = 0                # reconfigure() invocations
        self.gated = 0                 # migrations skipped by the cost gate
        self.plans: List[Dict[str, int]] = []
        cluster.tracker = tracker
        cluster.controller = self

    def note(self) -> bool:
        """Count one admitted txn; True when a reconfiguration is due."""
        if self.interval <= 0:
            return False
        self._since += 1
        return self._since >= self.interval

    def reconfigure(self) -> Optional[MigrationPlan]:
        """Re-detect the hot set from the tracker, re-layout, migrate.

        Returns the executed plan, or None when the new placement is
        empty or changes fewer than ``min_change`` slots."""
        self._since = 0
        self.epochs += 1
        k = self.top_k
        if k is None:
            k = len(self.cluster.hot_index.placement.slot) \
                if self.cluster.hot_index is not None else 0
        k = min(k, self.cluster.switch_cfg.total_slots)
        hot = self.tracker.top_k(k)
        traces = self.tracker.window_traces()
        self.tracker.advance_epoch()
        placement = layout_for_hotset(traces, hot, self.cluster.switch_cfg,
                                      layout_fn=self.layout_fn,
                                      seed=self.seed)
        if not placement.slot:
            return None
        old = self.cluster.hot_index.placement \
            if self.cluster.hot_index is not None else Placement({})
        plan = diff_placements(old, placement)
        if plan.n_changed < self.min_change:
            return None
        if self.gate_t_reconfig > 0.0:
            gain = self.projected_gain(placement, traces)
            cost = self.gate_t_reconfig * self.gate_txn_rate
            if gain <= cost:
                self.gated += 1
                return None
        plan = migrate(self.cluster, HotIndex(placement), plan)
        self.plans.append(plan.summary())
        return plan

    def projected_gain(self, new_placement: Placement, traces) -> float:
        """Projected extra fully-hot txns over the next epoch if the
        cluster migrated to ``new_placement``: the observed window's hot
        share under the new placement minus its share under the current
        one, scaled to the epoch length.  The gate compares this against
        the pause cost ``gate_t_reconfig * gate_txn_rate`` (txns the
        whole cluster forgoes while the switch reloads)."""
        if not traces:
            return 0.0
        old_slot = self.cluster.hot_index.placement.slot \
            if self.cluster.hot_index is not None else {}
        new_slot = new_placement.slot
        old_hot = sum(1 for tr in traces
                      if all(k in old_slot for k, _ in tr))
        new_hot = sum(1 for tr in traces
                      if all(k in new_slot for k, _ in tr))
        horizon = self.interval if self.interval > 0 else len(traces)
        return (new_hot - old_hot) / len(traces) * horizon
