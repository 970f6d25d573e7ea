"""Fault-injection harness for the functional cluster.

A ``FaultPlan`` arms exactly one crash point; the cluster calls
``Cluster._fault(point, **ctx)`` at each instrumented site and the plan
decides whether to fire.  Firing marks the switch down, applies any
crash-side effects (torn WAL tail, mid-migration bookkeeping), and raises
``SimulatedCrash`` out of the running batch — exactly like a switch dying
mid-operation.  Recovery then goes through ``Cluster.recover_switch()``
or ``Cluster.fail_over()`` and the tests assert byte-identical registers
vs. an uncrashed run of the surviving prefix.

Crash points (the matrix in ``tests/test_durability.py``):

``mid_group_dispatch``
    After the group's ``switch_send`` records are logged but before the
    device executes the batch — the paper's in-flight window (Fig 9):
    every send must be replayed as *unknown* (no result, no GID).

``undrained_async``
    A crash with undrained async ``PendingBatch`` handles parked on the
    cluster: device work may have run, but the responses never reached
    the hosts — result records are missing and the handles are lost.

``mid_migration``
    Between ``migrate_begin`` and ``migrate_end``: registers for evicted
    keys were written back to home stores but the new placement was never
    installed.  Recovery abandons the migration (the old index stands);
    meanwhile the evicted keys stay readable from their home stores —
    the partial-availability window.

``torn_tail``
    After a group fully drains, the last ``tear_records`` records of the
    logging node's open WAL segment are torn off (simulating an unsynced
    tail lost in the crash); the surviving log is a clean verifiable
    prefix and recovery rebuilds exactly the surviving transactions.

``mid_2pc_prepare``
    Inside a cold/warm 2PC prepare, after locks are acquired and staged
    but before the write records land — the window where an in-flight
    early abort (PR 10) may arrive; the lock-leak property test asserts
    no lock survives for the aborted tid.

``mid_failover``
    During ``Cluster.fail_over()``, after the primary switch is marked
    down but before the standby takes over — the double-fault window:
    the standby itself dies (``cluster._standby`` is lost) and recovery
    must fall back to cold WAL+checkpoint rebuild.

This module also defines ``Brownout`` — not a crash point but a *degraded*
switch mode (slow/lossy, still alive): ``Cluster.enter_brownout(plan)``
evicts the register plane to home stores and demotes hot admissions to the
cold path, bounded by ``demote_cap``; see ``Cluster.enter_brownout``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .wal import SegmentedWAL

CRASH_POINTS = ("mid_group_dispatch", "undrained_async", "mid_migration",
                "torn_tail", "mid_2pc_prepare", "mid_failover")


@dataclass(frozen=True)
class Brownout:
    """A switch *brown-out*: degraded (slow/lossy), not dead.  Under a
    brown-out the cluster demotes hot admissions to the cold path instead
    of failing them; ``demote_cap`` bounds how many demotions are queued
    through the cold path before further hot admissions are shed with
    ``SwitchUnavailable`` (None = unbounded).  ``slow_factor`` is the
    modeled service-time inflation of the degraded switch — carried for
    the sim mirror and for operators reading the plan."""
    demote_cap: Optional[int] = None
    slow_factor: float = 4.0

    def __post_init__(self):
        if self.demote_cap is not None and self.demote_cap < 0:
            raise ValueError("demote_cap must be >= 0 or None")
        if self.slow_factor < 1.0:
            raise ValueError("slow_factor must be >= 1.0")


class SwitchUnavailable(Exception):
    """The switch is down (crashed, not yet recovered): hot traffic whose
    keys are not readable elsewhere cannot be served."""


class SimulatedCrash(Exception):
    """Raised at an armed crash point; carries the point name and context."""

    def __init__(self, point: str, ctx: Optional[dict] = None):
        super().__init__(f"simulated switch crash at {point}")
        self.point = point
        self.ctx = ctx or {}


@dataclass
class FaultPlan:
    """Arm one crash point.  ``after`` = fire on the Nth time the point is
    reached (1 = first).  ``tear_records``/``tear_node`` configure the
    torn-tail side effect (records ripped off node ``tear_node``'s open
    segment at crash time)."""
    point: str
    after: int = 1
    tear_records: int = 0
    tear_node: int = 0
    fired: bool = False
    hits: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.point not in CRASH_POINTS:
            raise ValueError(f"unknown crash point {self.point!r}; "
                             f"expected one of {CRASH_POINTS}")

    def should_fire(self, point: str) -> bool:
        if self.fired or point != self.point:
            return False
        self.hits += 1
        return self.hits >= self.after

    def on_crash(self, cluster, point: str, ctx: dict) -> None:
        """Apply crash-side effects before the exception unwinds."""
        self.fired = True
        if point == "mid_migration":
            cluster._mid_migration_evicted = set(ctx.get("evicted", ()))
        if point == "mid_failover":
            cluster._standby = None     # the standby died mid-takeover
        if self.tear_records > 0:
            wal = cluster.nodes[self.tear_node].wal
            if isinstance(wal, SegmentedWAL):
                wal.tear_tail(self.tear_records)
            else:                                    # legacy list mode
                del wal[len(wal) - self.tear_records:]
