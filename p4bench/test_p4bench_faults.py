"""``correct`` comes out false for the control and for each fault a cell
can have, planted in the program underneath a run that skips only the
look for a card (the CPU, the cells' own configurations, a short window).

* the control: the reference in the program's place with the
  configuration's guarantee of admission order broken (each batch run
  grouped by home node);
* a step that returns its state unchanged: every dispatch runs on a copy
  of the register file;
* half of the batch left out: ``run_batch`` runs the first half and
  answers the rest with the first half's answers;
* an answer altered where it is produced: one answer of every dispatch's
  result plane is off by one.

A cell on one card has no exchange between cards to leave out.  And, on
SmallBank at a small size (``test_p4bench_reference.smallbank_cell``),
the faults a balance constraint can meet: a refused txn answered as
committed, a committed one given up on, a refused one's ``write`` record
left in the log.
"""
import time

import numpy as np
import pytest
import torch
from repro_torch.core import engine
from repro_torch.db import dbms
from repro_torch.db.conflict import GAVE_UP
from repro_torch.db.dbms import Cluster

from p4bench import control, harness
from p4bench.reference import compare
from p4bench.test_p4bench_reference import run_all, smallbank_cell

CELLS = ["ycsb_a.allhot", "tpcc.paper"]
SEED = 2 ** 31 + 11


def _measure(name, speedup=1):
    """A run of the cell, whose traffic pool the window cannot use up
    where a fault makes each batch ``speedup`` times as cheap."""
    cell = harness.load_cell(name)
    cell["traffic"]["max_txn_per_s"] *= speedup
    out, _ = harness.measure(cell, SEED, 0.5, False, torch.device("cpu"),
                             time.perf_counter(), warmup_batches=1)
    return out["correct"], {k: v["value"] for k, v in out["checks"].items()}


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(name):
    correct, checks = _measure(name)
    assert correct, checks


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = harness.load_cell(name)
    numbers = control.control_numbers(cell, SEED,
                                      4 * cell["traffic"]["batch"])
    assert numbers["results_bad"] > 0
    assert compare.judge(numbers)[0] is False


def _unchanged_state(monkeypatch):
    run_fused = engine._run_fused
    monkeypatch.setattr(engine, "_run_fused", lambda mode, regs, *a:
                        run_fused(mode, regs.clone(), *a))


def _half_batch(monkeypatch):
    """Each batch runs half its txns: twice the batches a window."""
    run_batch = Cluster.run_batch

    def half(self, txns, *a, **kw):
        h = len(txns) // 2
        answers = list(run_batch(self, txns[:h], *a, **kw))
        return answers + answers[:len(txns) - h]
    monkeypatch.setattr(Cluster, "run_batch", half)


def _altered_answer(monkeypatch):
    results_np = engine.PendingBatch.results_np

    def altered(self):
        out = results_np(self).copy()
        out[0, 0] += 1
        return out
    monkeypatch.setattr(engine.PendingBatch, "results_np", altered)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault,caught_by", [
    (_unchanged_state, "results_bad"), (_half_batch, "commits_gap"),
    (_altered_answer, "results_bad")])
def test_fault_is_not_correct(monkeypatch, name, fault, caught_by):
    fault(monkeypatch)
    correct, checks = _measure(name, 2 if fault is _half_batch else 1)
    assert not correct and checks[caught_by] > 0, checks
    assert np.isfinite(list(checks.values())).all()


def _with_retries(monkeypatch, change):
    """``_run_with_retries`` answering ``change(txn, answer)``."""
    run = Cluster._run_with_retries
    monkeypatch.setattr(Cluster, "_run_with_retries",
                        lambda self, txn, *a, **kw:
                        change(txn, run(self, txn, *a, **kw)))


def _refused_committed(monkeypatch):
    _with_retries(monkeypatch, lambda txn, out:
                  [0] * len(txn.ops) if out is GAVE_UP else out)


def _committed_gave_up(monkeypatch):
    _with_retries(monkeypatch, lambda txn, out:
                  GAVE_UP if any(o == dbms.CADD for o, _, _ in txn.ops)
                  else out)


def _refused_write_logged(monkeypatch):
    exec_on_nodes = Cluster._exec_on_nodes

    def logged(self, txn, *a, **kw):
        try:
            return exec_on_nodes(self, txn, *a, **kw)
        except dbms.Abort:
            o, k, v = next(op for op in txn.ops if op[0] == dbms.CADD)
            node = self.nodes[dbms.node_of(k)]
            node.log("write", txn.tid, key=k, old=node.store[k],
                     new=node.store[k] + v)
            raise
    monkeypatch.setattr(Cluster, "_exec_on_nodes", logged)


@pytest.mark.parametrize("fault,caught_by", [
    (_refused_committed, ("results_bad",)),
    (_committed_gave_up, ("results_bad", "failed")),
    (_refused_write_logged, ("wal_bad",))])
def test_refusal_fault_is_not_correct(monkeypatch, fault, caught_by):
    cell = smallbank_cell(monkeypatch, async_hot=False)
    fault(monkeypatch)
    run, got = run_all(cell, SEED, 640)
    numbers = run.check(got)
    assert compare.judge(numbers)[0] is False, numbers
    numbers["failed"] = run.failed
    assert all(numbers[k] > 0 for k in caught_by), numbers
