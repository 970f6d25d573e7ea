"""Serial execution of a transaction stream on one key -> value map.

Every committed transaction of a P4DB deployment is serializable in
admission order (the switch for hot ops, 2PL with 2PC for the rest), so
its answers and state are those of running the transactions one after
another in that order: READ answers the current value, WRITE stores and
answers its operand, ADD stores and answers value + operand, ADDP adds
the answer of an earlier op of the same transaction.  Every key starts
at its loaded value (``initial``), a key never loaded at 0.  Values are
held to 32 bits signed, the registers' width: a stream that leaves that
range is refused, since the switch would wrap where the nodes would
not.

CADD, the constrained add (P4DB §5.4), depends on where its key lives,
which the caller gives as data (``switch_keys``, the keys of the
switch's registers):

* on a switch key it stores and answers ``v + x`` where that is not
  negative, else it keeps and answers ``v``: it never refuses;
* on a node key ``v + x < 0`` refuses the whole transaction: none of its
  ops apply, its switch ops neither, since the warm protocol checks the
  cold part's constraints before it sends the switch sub-transaction.

An ADDP whose source op lies on the other side of that line (a switch op
adding a node op's answer, or the reverse) is not defined by P4DB: the
switch sub-transaction carries only the switch ops.  Such a stream is
refused.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from p4bench.traffic.stream import ADD, ADDP, CADD, READ, WRITE, Stream

INT32 = (-2 ** 31, 2 ** 31 - 1)


@dataclass
class Outcome:
    """Per op (stream positions): ``res`` the answer, ``pre`` the key's
    value before the op, ``post`` after it (0, and the value unchanged,
    for the ops of a refused transaction); per transaction ``committed``;
    ``values`` the final map."""
    res: np.ndarray
    pre: np.ndarray
    post: np.ndarray
    values: Dict[int, int]
    committed: np.ndarray


def execute(stream: Stream, initial=None, switch_keys=(),
            order=None) -> Outcome:
    """Run the transactions one by one in ``order`` (admission order when
    None) and every op of one in its own order, from the loaded tuples
    ``initial`` (a key -> value map, not changed), with ``switch_keys``
    held in the switch's registers."""
    ops, keys, vals = (stream.op.tolist(), stream.key.tolist(),
                       stream.val.tolist())
    start = stream.start.tolist()
    switch = frozenset(np.asarray(switch_keys, np.int64).tolist())
    _refuse_addp_across(stream, switch)
    constrained = _has(stream, CADD)
    m = len(ops)
    res, pre, post = [0] * m, [0] * m, [0] * m
    committed = np.ones(stream.n, bool)
    values: Dict[int, int] = dict(initial or {})
    get = values.get
    lo, hi = INT32
    for i in (range(stream.n) if order is None else order):
        s, e = start[i], start[i + 1]
        undo = [] if constrained[i] else None     # (key, value before)
        for j in range(s, e):
            o, k = ops[j], keys[j]
            cur = get(k, 0)
            if o == READ:
                new = r = cur
            elif o == WRITE:
                new = r = vals[j]
            elif o == ADD:
                new = r = cur + vals[j]
            elif o == ADDP:
                new = r = cur + res[s + vals[j]]
            elif o == CADD:
                new = r = cur + vals[j]
                if new < 0:
                    if k not in switch:
                        _refuse(s, e, keys, values, undo, res, pre, post)
                        committed[i] = False
                        break
                    new = r = cur
            else:
                raise ValueError(f"op {o} is not modelled by the reference")
            if not lo <= new <= hi:
                raise ValueError(f"key {k} leaves 32 bits: {new}")
            if undo is not None:
                undo.append((k, get(k)))
            values[k] = new
            pre[j], res[j], post[j] = cur, r, new
    return Outcome(np.array(res, np.int64), np.array(pre, np.int64),
                   np.array(post, np.int64), values, committed)


def _refuse(s, e, keys, values, undo, res, pre, post):
    """Take back what the ops ``s:e`` of a refused transaction applied."""
    for k, old in reversed(undo):
        if old is None:
            del values[k]
        else:
            values[k] = old
    for j in range(s, e):
        res[j] = 0
        pre[j] = post[j] = values.get(keys[j], 0)


def _has(stream: Stream, op: int) -> list:
    """Per transaction, whether it holds an ``op``."""
    count = np.concatenate([[0], np.cumsum(stream.op == op)])
    return (count[stream.start[1:]] > count[stream.start[:-1]]).tolist()


def _refuse_addp_across(stream: Stream, switch: frozenset):
    """Raise on an ADDP whose source lies across the switch/node line."""
    at = np.flatnonzero(stream.op == ADDP)
    if not at.size or not switch:
        return
    sw = np.fromiter(switch, np.int64, len(switch))
    txn = np.searchsorted(stream.start, at, side="right") - 1
    src = np.clip(stream.start[txn] + stream.val[at], 0, stream.key.size - 1)
    mine = np.isin(stream.key[at], sw)
    theirs = np.isin(stream.key[src], sw)
    if (mine != theirs).any():
        j = int(at[np.argmax(mine != theirs)])
        raise ValueError(f"ADDP at op {j} adds an op across the switch/node "
                         f"line, which P4DB does not define")
