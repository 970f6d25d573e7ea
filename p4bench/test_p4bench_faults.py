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

A cell on one card has no exchange between cards to leave out.
"""
import time

import numpy as np
import pytest
import torch
from repro_torch.core import engine
from repro_torch.db.dbms import Cluster

from p4bench import control, harness
from p4bench.reference import compare

CELLS = ["ycsb_a.allhot", "tpcc.paper"]
SEED = 2 ** 31 + 11


def _measure(name):
    cell = harness.load_cell(name)
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
    correct, checks = _measure(name)
    assert not correct and checks[caught_by] > 0, checks
    assert np.isfinite(list(checks.values())).all()
