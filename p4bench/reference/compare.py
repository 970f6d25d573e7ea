"""The comparison that decides ``correct``: what the program served and
holds after a run, against the plain reference the configuration names
(``serial.py`` for both cells), which says per transaction whether it
commits or a constraint refuses it.

Four numbers, each an exact count with the limit 0:

* ``results_bad``: transactions whose answers (a list of ints, in op
  order) differ from the reference's, or that gave up or never answered
  (the answers packed by ``pack``) where the reference commits them; a
  transaction that the reference refuses is right only where the
  program gave up on it;
* ``values_bad``: keys whose committed value as the program holds it (a
  register on the card for a key of the switch, the node's store for
  the rest) differs from the reference's final value, plus register
  slots that hold a value and belong to no key;
* ``wal_bad``: acknowledged transactions whose write-ahead-log records
  are missing or wrong, plus records of no transaction and breaks in a
  node's hash chain.  A transaction's switch part is one ``switch_send``
  of its switch ops (a subsequence of its ops) and one ``switch_result``
  on its home node, whose answers are those ops' answers and whose GIDs
  follow admission order one by one; its other ops are the cold part:
  one ``write`` record (key, old, new) on the key's node for each key it
  writes, and one ``commit`` on each node it touches.  A refused
  transaction has no record at all and takes no GID;
* ``commits_gap``: committed transactions the program counted, less
  those the reference commits.
"""
from __future__ import annotations

import collections
import itertools

import numpy as np

from p4bench.traffic.stream import WRITES, node_of

LIMITS = {"results_bad": 0, "values_bad": 0, "wal_bad": 0,
          "commits_gap": 0}
GAVE_UP, UNANSWERED = -1, -2      # packed lengths of what is not a list


def pack(answers):
    """(lens, flat) of a list of answers: each one's length (``GAVE_UP``
    where the program answered with no list, ``UNANSWERED`` where it
    never answered or answered with something other than ints) and their
    ints one after another, as arrays the collector does not walk."""
    lists = [a if isinstance(a, list) else UNANSWERED if a is None
             else GAVE_UP for a in answers]
    try:
        return _pack(lists)
    except (TypeError, ValueError, OverflowError):
        return _pack([a if not isinstance(a, list) or all(
            isinstance(x, (int, np.integer)) for x in a) else UNANSWERED
            for a in lists])


def _pack(lists):
    lens = np.array([len(a) if isinstance(a, list) else a for a in lists],
                    np.int64)
    flat = np.fromiter(itertools.chain.from_iterable(
        a for a in lists if isinstance(a, list)), np.int64)
    return lens, flat


def results_bad(stream, ref, lens, flat) -> int:
    """Transactions of ``stream`` whose packed answers (``pack``) are not
    the reference's; a transaction past the answers counts as bad."""
    n_ops = np.diff(stream.start)
    committed = ref.committed[:stream.n]
    want = np.where(committed, n_ops, GAVE_UP)
    got = np.full(stream.n, UNANSWERED, np.int64)
    m = min(stream.n, lens.size)
    got[:m] = lens[:m]
    ok = got == want
    # the answers of the committed transactions whose lengths agree, side
    # by side
    same = ok & committed
    took = np.zeros(lens.size, bool)
    took[:m] = same[:m]
    mine = flat[np.repeat(took, np.maximum(lens, 0))]
    theirs = ref.res[np.repeat(same, n_ops)]
    txn = np.repeat(np.nonzero(same)[0], n_ops[same])
    return int((~ok).sum() + np.unique(txn[mine != theirs]).size)


def unanswered(ref, lens, first: int = 0) -> int:
    """Transactions from ``first`` on that the reference commits and the
    program gave no answer for (the result line's ``failed``); ``lens``
    holds one length a transaction of the reference."""
    return int((ref.committed[first:] & (lens[first:] < 0)).sum())


def commits_gap(ref, commits: int) -> int:
    return abs(commits - int(ref.committed.sum()))


def values_bad(ref, held, stray: int = 0) -> int:
    """Keys whose value in ``held`` is not the reference's (a key missing
    on one side holds 0 there), plus ``stray`` register slots."""
    k1, v1 = _nonzero(ref.values)
    k2, v2 = _nonzero(held)
    if k1.size == k2.size and (k1 == k2).all():
        return stray + int((v1 != v2).sum())
    keys = np.union1d(k1, k2)
    return stray + int((_at(keys, k1, v1) != _at(keys, k2, v2)).sum())


def _nonzero(values: dict):
    """The map's keys that hold a value other than 0, sorted, and their
    values."""
    n = len(values)
    k = np.fromiter(values.keys(), np.int64, n)
    v = np.fromiter(values.values(), np.int64, n)
    k, v = k[v != 0], v[v != 0]
    order = np.argsort(k, kind="stable")
    return k[order], v[order]


def _at(keys, k, v):
    """Values at ``keys`` of the sorted map (k, v), 0 where it has none."""
    out = np.zeros(keys.size, np.int64)
    out[np.isin(keys, k, assume_unique=True)] = v
    return out


def _chain_breaks(records) -> int:
    breaks, prev = 0, None
    for r in records:
        if prev is not None and (r.prev != prev.hash or r.lsn != prev.lsn + 1):
            breaks += 1
        prev = r
    return breaks


def wal_bad(stream, ref, wals, tid0: int) -> int:
    """``wals``: each node's records in log order; txn i has tid
    ``tid0 + i``."""
    by_tid = collections.defaultdict(list)
    bad = 0
    for node, records in enumerate(wals):
        bad += _chain_breaks(records)
        for r in records:
            by_tid[r.tid].append((node, r.kind, r.payload))
    ops, keys = stream.op.tolist(), stream.key.tolist()
    txn_ops = list(zip(ops, keys, stream.val.tolist()))
    start, home = stream.start.tolist(), stream.home.tolist()
    res, pre, post = ref.res.tolist(), ref.pre.tolist(), ref.post.tolist()
    committed = ref.committed.tolist()
    gids = []                       # (txn, gid) of every switch part
    for i in range(stream.n):
        if not committed[i]:
            bad += bool(by_tid.pop(tid0 + i, ()))
            continue
        s, e = start[i], start[i + 1]
        send = result = None
        writes, commits = [], []
        ok = True
        for node, kind, payload in by_tid.pop(tid0 + i, ()):
            if kind == "switch_send" and send is None:
                send = (node, payload)
            elif kind == "switch_result" and result is None:
                result = (node, payload)
            elif kind == "write":
                writes.append((node, payload["key"], payload["old"],
                               payload["new"]))
            elif kind == "commit":
                commits.append(node)
            else:
                ok = False
        cold = range(s, e)
        if send is not None or result is not None:
            if send is None or result is None:
                bad += 1
                continue
            (sn, sp), (rn, rp) = send, result
            sub = [tuple(o) for o in sp["ops"]]
            if len(sub) == e - s:
                want, answers, cold = txn_ops[s:e], res[s:e], ()
            else:
                hot = {k for _, k, _ in sub}
                want = [txn_ops[j] for j in cold if keys[j] in hot]
                answers = [res[j] for j in cold if keys[j] in hot]
                cold = [j for j in cold if keys[j] not in hot]
            ok &= sn == rn == home[i] and sub == want
            ok &= sorted(rp["results"]) == sorted(answers)
            gids.append(rp["gid"])
        if cold or writes or commits:
            first, last, written = {}, {}, set()
            for j in cold:
                first.setdefault(keys[j], j)
                last[keys[j]] = j
                if ops[j] in WRITES:
                    written.add(keys[j])
            ok &= sorted(writes) == sorted(
                (node_of(k), k, pre[first[k]], post[last[k]])
                for k in written)
            ok &= sorted(commits) == sorted({node_of(k) for k in first})
        bad += not ok
    bad += sum(b != a + 1 for a, b in zip(gids, gids[1:]))
    return bad + sum(len(v) for v in by_tid.values())


def judge(numbers: dict):
    """(correct, [(name, value, limit)]) for the numbers compared."""
    rows = [(k, numbers[k], LIMITS[k]) for k in LIMITS if k in numbers]
    return all(v <= lim for _, v, lim in rows), rows
