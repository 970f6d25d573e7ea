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
not.  CADD (which aborts a cold part but not a switch op) is
not modelled and is refused.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from p4bench.traffic.stream import ADD, ADDP, READ, WRITE, Stream

INT32 = (-2 ** 31, 2 ** 31 - 1)


@dataclass
class Outcome:
    """Per op (stream positions): ``res`` the answer, ``pre`` the key's
    value before the op, ``post`` after it; ``values`` the final map."""
    res: np.ndarray
    pre: np.ndarray
    post: np.ndarray
    values: Dict[int, int]


def execute(stream: Stream, initial=None, order=None) -> Outcome:
    """Run the transactions one by one in ``order`` (admission order when
    None) and every op of one in its own order, from the loaded tuples
    ``initial`` (a key -> value map, not changed)."""
    ops, keys, vals = (stream.op.tolist(), stream.key.tolist(),
                       stream.val.tolist())
    start = stream.start.tolist()
    m = len(ops)
    res, pre, post = [0] * m, [0] * m, [0] * m
    values: Dict[int, int] = dict(initial or {})
    get = values.get
    lo, hi = INT32
    for i in (range(stream.n) if order is None else order):
        s = start[i]
        for j in range(s, start[i + 1]):
            o, k = ops[j], keys[j]
            cur = get(k, 0)
            pre[j] = cur
            if o == READ:
                new = r = cur
            elif o == WRITE:
                new = r = vals[j]
            elif o == ADD:
                new = r = cur + vals[j]
            elif o == ADDP:
                new = r = cur + res[s + vals[j]]
            else:
                raise ValueError(f"op {o} is not modelled by the reference")
            if not lo <= new <= hi:
                raise ValueError(f"key {k} leaves 32 bits: {new}")
            values[k] = new
            res[j] = r
            post[j] = new
    return Outcome(np.array(res, np.int64), np.array(pre, np.int64),
                   np.array(post, np.int64), values)
