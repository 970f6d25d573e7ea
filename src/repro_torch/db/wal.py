"""Durability subsystem: segmented hash-chained WAL + incremental checkpoints.

P4DB's recovery story (paper §6.1 / A.3, Fig 9) leans entirely on node-side
logging of switch sends: the register file is rebuilt by replaying every
logged send in GID order.  Through PR 5 the repo mimicked that with a plain
Python list per node — fine for correctness pins, useless as a durability
claim.  This module provides the real thing behind the same ``log()`` API:

``SegmentedWAL``
    An append-only log of ``WALRecord``s split into fixed-size segments.
    Every record carries a SHA-256 hash over (previous record's hash,
    canonical JSON of the record body), so the log is a hash chain:
    corruption of any byte, reordering, or deletion of an interior record
    breaks the chain and is caught by ``verify()``.  A segment that fills
    is *sealed* — its record count and final hash are frozen in the
    segment metadata — so truncation of anything but the open tail
    segment is also detectable.  The open tail is the one place a crash
    may legitimately tear records (``tear_tail``), leaving a clean,
    verifiable prefix.  ``save()``/``load()`` round-trip the log through
    JSONL segment files + a manifest; ``python -m repro_torch.db.wal verify DIR``
    runs the integrity walk from the command line (used by CI over the
    bench smoke's emitted log).

``CheckpointStore``
    Diff-only register snapshots.  The first checkpoint stores the full
    register file; every later one stores only the cells that changed
    since the previous checkpoint, so checkpoint cost is bounded by the
    write set (for migration-boundary checkpoints: by the plan size, not
    the hot-set size).  ``reconstruct()`` rebuilds the latest register
    state from base + diffs — that is the path recovery actually uses,
    so the diffs are load-bearing, not decorative.

The list-like surface of ``SegmentedWAL`` (len / iteration / indexing /
slicing) is deliberate: every existing test and bench that pokes
``node.wal`` — negative indexing, filtering into plain lists, slice
truncation — keeps working unchanged.

In memory a sealed segment's records are held packed: one pickled
``bytes`` object in place of a record object, a payload dict and its
lists per record, so the garbage collector's full passes do not walk the
log's history.  Only the open segment is held as live ``WALRecord``s.
Any read of a sealed segment (an index, a slice, iteration, ``verify``,
``save``) unpacks it and keeps it unpacked, so an edit made through the
list surface persists and ``verify()`` sees it.  ``packed_segments`` and
``unpacked_segments`` count the segments held packed and the unpacks.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

GENESIS = "0" * 64               # prev-hash of the first record
DEFAULT_SEGMENT_SIZE = 256       # records per segment before sealing


class WALIntegrityError(Exception):
    """The integrity walk found corruption, reordering, or truncation."""


def _jsonable(obj):
    """Canonical-JSON fallback for numpy scalars/arrays and sets so record
    hashing is stable across process boundaries and save/load."""
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (set, frozenset)):
        return sorted(obj)
    raise TypeError(f"not JSON-serializable for WAL hashing: {type(obj)}")


def _canon_encoder():
    """The encoder of ``json.dumps(obj, sort_keys=True, separators=(",",
    ":"), default=_jsonable)``, built once: ``json.dumps`` builds a
    ``JSONEncoder`` and ``encode`` its C encoder on every call.  The C
    encoder is built without the circular-reference markers (a record
    holds no cycle), so it keeps no state between calls."""
    enc = json.JSONEncoder(sort_keys=True, separators=(",", ":"),
                           default=_jsonable)
    c = json.encoder.c_make_encoder(
        None, enc.default, json.encoder.encode_basestring_ascii, enc.indent,
        enc.key_separator, enc.item_separator, enc.sort_keys, enc.skipkeys,
        enc.allow_nan)
    return lambda obj: "".join(c(obj, 0))


_encode = _canon_encoder()


def _canon(obj) -> bytes:
    # sort_keys + fixed separators => byte-stable serialization; tuples and
    # lists serialize identically, so hashes survive a JSONL round-trip
    return _encode(obj).encode()


def record_hash(prev: str, lsn: int, kind: str, tid: int, payload: dict) -> str:
    return hashlib.sha256(
        prev.encode() + _canon([lsn, kind, tid, payload])).hexdigest()


@dataclass
class WALRecord:
    """One log record.  ``kind``/``tid``/``payload`` match the legacy
    ``LogEntry`` surface; ``lsn``/``prev``/``hash`` are the chain."""
    lsn: int
    kind: str
    tid: int
    payload: dict
    prev: str
    hash: str


@dataclass
class SegmentMeta:
    index: int
    start_lsn: int
    count: int = 0
    sealed: bool = False
    seal_hash: str = ""


class _Packed:
    """A sealed run of records as one pickled ``bytes`` object, which the
    collector does not walk.  ``pickle`` keeps every payload's types
    (``marshal`` would turn a numpy scalar into ``bytes``)."""
    __slots__ = ("blob", "n", "last")

    def __init__(self, recs: List[WALRecord]):
        self.blob = pickle.dumps(
            [(r.lsn, r.kind, r.tid, r.payload, r.prev, r.hash)
             for r in recs], pickle.HIGHEST_PROTOCOL)
        self.n = len(recs)
        self.last = (recs[-1].hash, recs[-1].lsn)

    def records(self) -> List[WALRecord]:
        return [WALRecord(*row) for row in pickle.loads(self.blob)]


class _Records:
    """The log's records as one list.  ``chunks`` holds them in order:
    each sealed run a ``_Packed`` until something reads it, then a plain
    list again; the last chunk is always the live list ``append`` fills.
    Only the last chunk may be empty."""

    def __init__(self):
        self.chunks: list = [[]]
        self.n = 0
        self.packed = 0          # chunks held packed now
        self.unpacked = 0        # packed chunks a read has unpacked

    # ------------------------------------------------------ the log's own
    def append(self, rec: WALRecord):
        self.chunks[-1].append(rec)
        self.n += 1

    def seal(self):
        """Pack the live tail (the segment just sealed) and open another."""
        tail = self.chunks[-1]
        if tail:
            self.chunks[-1] = _Packed(tail)
            self.packed += 1
            self.chunks.append([])

    def last(self) -> Optional[Tuple[str, int]]:
        """(hash, lsn) of the last record, without unpacking anything."""
        tail = self.chunks[-1]
        if tail:
            return tail[-1].hash, tail[-1].lsn
        if len(self.chunks) == 1:
            return None
        prev = self.chunks[-2]
        return prev.last if isinstance(prev, _Packed) else \
            (prev[-1].hash, prev[-1].lsn)

    def truncate(self, keep: int):
        """Drop every record after the first ``keep``."""
        while self.n > keep:
            tail = self._live(-1)
            drop = min(len(tail), self.n - keep)
            del tail[len(tail) - drop:]
            self.n -= drop
            if self.n > keep:
                self.chunks.pop()

    def _live(self, ci: int) -> list:
        chunk = self.chunks[ci]
        if isinstance(chunk, _Packed):
            chunk = self.chunks[ci] = chunk.records()
            self.packed -= 1
            self.unpacked += 1
        return chunk

    def _locate(self, i: int) -> Tuple[int, int]:
        if i < 0:
            i += self.n
        if not 0 <= i < self.n:
            raise IndexError("list index out of range")
        start = self.n
        for ci in range(len(self.chunks) - 1, -1, -1):
            chunk = self.chunks[ci]
            start -= chunk.n if isinstance(chunk, _Packed) else len(chunk)
            if i >= start:
                return ci, i - start
        raise AssertionError("chunk lengths disagree with the count")

    # ------------------------------------------------------- list surface
    def __len__(self) -> int:
        return self.n

    def __iter__(self) -> Iterator[WALRecord]:
        ci = 0
        while ci < len(self.chunks):
            yield from self._live(ci)
            ci += 1

    def __getitem__(self, i):
        if not isinstance(i, slice):
            ci, off = self._locate(i)
            return self._live(ci)[off]
        idx = range(self.n)[i]
        if not idx:
            return []
        lo, hi = min(idx[0], idx[-1]), max(idx[0], idx[-1]) + 1
        part, start = [], 0
        for ci in range(len(self.chunks)):
            chunk = self.chunks[ci]
            end = start + (chunk.n if isinstance(chunk, _Packed)
                           else len(chunk))
            if end > lo:
                part += self._live(ci)[max(lo - start, 0):hi - start]
            if end >= hi:
                break
            start = end
        return part if idx.step == 1 else [part[j - lo] for j in idx]

    def __setitem__(self, i: int, rec: WALRecord):
        ci, off = self._locate(i)
        self._live(ci)[off] = rec

    def __delitem__(self, i: int):
        ci, off = self._locate(i)
        chunk = self._live(ci)
        del chunk[off]
        self.n -= 1
        if not chunk and ci != len(self.chunks) - 1:
            del self.chunks[ci]


class SegmentedWAL:
    """Segmented append-only hash-chained log (see module docstring)."""

    def __init__(self, segment_size: int = DEFAULT_SEGMENT_SIZE):
        if segment_size < 1:
            raise ValueError("segment_size must be >= 1")
        self.segment_size = int(segment_size)
        self._records = _Records()
        self._segments: List[SegmentMeta] = [SegmentMeta(0, 0)]

    @property
    def packed_segments(self) -> int:
        """Sealed segments held packed now."""
        return self._records.packed

    @property
    def unpacked_segments(self) -> int:
        """Packed segments that a read has unpacked, since the log began."""
        return self._records.unpacked

    # ------------------------------------------------------------ append
    def append(self, kind: str, tid: int, payload: dict) -> WALRecord:
        recs = self._records
        last = recs.last()
        prev, lsn = (last[0], last[1] + 1) if last else (GENESIS, 0)
        seg = self._segments[-1]
        if seg.count >= self.segment_size:          # seal full segment, roll
            seg.sealed = True
            seg.seal_hash = prev
            recs.seal()
            seg = SegmentMeta(seg.index + 1, lsn)
            self._segments.append(seg)
        tid = int(tid)
        rec = WALRecord(lsn, kind, tid, payload, prev,
                        record_hash(prev, lsn, kind, tid, payload))
        recs.append(rec)
        seg.count += 1
        return rec

    # ------------------------------------------------------- list surface
    def __len__(self) -> int:
        return len(self._records)

    def __iter__(self) -> Iterator[WALRecord]:
        return iter(self._records)

    def __getitem__(self, i):
        # slices return plain lists — callers that filter/truncate get an
        # ordinary list, exactly like the legacy in-memory WAL
        return self._records[i]

    # ------------------------------------------------------------ verify
    def verify(self) -> dict:
        """Full integrity walk.  Raises ``WALIntegrityError`` on a flipped
        byte (hash mismatch), reordering/deletion (chain break or LSN gap),
        or truncation of a sealed segment.  A torn open-tail segment is a
        valid prefix and passes.  Returns a summary dict on success."""
        records = list(self._records)
        prev = GENESIS
        expected_lsn = 0
        for r in records:
            if r.lsn != expected_lsn:
                raise WALIntegrityError(
                    f"lsn gap at record {r.lsn} (expected {expected_lsn}): "
                    f"interior truncation or reordering")
            if r.prev != prev:
                raise WALIntegrityError(
                    f"hash-chain break at lsn {r.lsn}: reordering or "
                    f"deletion upstream")
            h = record_hash(r.prev, r.lsn, r.kind, r.tid, r.payload)
            if h != r.hash:
                raise WALIntegrityError(
                    f"corrupt record at lsn {r.lsn} ({r.kind}): stored hash "
                    f"does not match recomputed hash")
            prev = r.hash
            expected_lsn += 1
        pos = 0
        for seg in self._segments:
            recs = records[pos:pos + seg.count]
            if len(recs) != seg.count:
                raise WALIntegrityError(
                    f"segment {seg.index} holds {len(recs)} records, "
                    f"metadata says {seg.count}: truncation")
            if seg.sealed:
                if seg.count != self.segment_size:
                    raise WALIntegrityError(
                        f"sealed segment {seg.index} has {seg.count} records "
                        f"(expected {self.segment_size}): truncation")
                if recs[-1].hash != seg.seal_hash:
                    raise WALIntegrityError(
                        f"sealed segment {seg.index} final hash mismatch: "
                        f"tail of a sealed segment was rewritten")
            pos += seg.count
        if pos != len(records):
            raise WALIntegrityError(
                f"{len(records) - pos} records beyond the last "
                f"segment boundary: metadata truncation")
        return dict(ok=True, records=len(records),
                    segments=len(self._segments),
                    sealed=sum(1 for s in self._segments if s.sealed))

    # --------------------------------------------------------- torn tail
    def tear_tail(self, n: int) -> int:
        """Simulate a crash tearing the last ``n`` records off the *open*
        segment (the only legitimately tearable region — sealed segments
        are fsync'd history).  Returns how many records were torn."""
        seg = self._segments[-1]
        n = min(int(n), seg.count)
        if n <= 0:
            return 0
        self._records.truncate(len(self._records) - n)
        seg.count -= n
        return n

    # --------------------------------------------------------- save/load
    def save(self, path: str) -> dict:
        """Persist to ``path/``: one JSONL file per segment + a manifest.
        Hashes are stored verbatim; ``load()`` + ``verify()`` re-derives
        them, so a flipped byte on disk is caught."""
        os.makedirs(path, exist_ok=True)
        manifest = dict(segment_size=self.segment_size,
                        segments=[dict(index=s.index, start_lsn=s.start_lsn,
                                       count=s.count, sealed=s.sealed,
                                       seal_hash=s.seal_hash)
                                  for s in self._segments])
        records = list(self._records)
        pos = 0
        for seg in self._segments:
            fname = os.path.join(path, f"seg-{seg.index:05d}.jsonl")
            with open(fname, "w") as f:
                for r in records[pos:pos + seg.count]:
                    f.write(json.dumps(
                        dict(lsn=r.lsn, kind=r.kind, tid=r.tid,
                             payload=r.payload, prev=r.prev, hash=r.hash),
                        sort_keys=True, separators=(",", ":"),
                        default=_jsonable) + "\n")
            pos += seg.count
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        return dict(records=len(records), segments=len(self._segments))

    @classmethod
    def load(cls, path: str) -> "SegmentedWAL":
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        wal = cls(segment_size=manifest["segment_size"])
        wal._segments = [SegmentMeta(m["index"], m["start_lsn"], m["count"],
                                     m["sealed"], m["seal_hash"])
                         for m in manifest["segments"]]
        for seg in wal._segments:
            fname = os.path.join(path, f"seg-{seg.index:05d}.jsonl")
            if not os.path.exists(fname):
                raise WALIntegrityError(f"segment file missing: {fname}")
            with open(fname) as f:
                for line in f:
                    if not line.strip():
                        continue
                    d = json.loads(line)
                    wal._records.append(WALRecord(
                        d["lsn"], d["kind"], d["tid"], d["payload"],
                        d["prev"], d["hash"]))
            if seg.sealed:
                wal._records.seal()
        return wal


# ===================================================================== #
#  Incremental checkpoints                                              #
# ===================================================================== #

class CheckpointStore:
    """Diff-only register checkpoints: a full base snapshot, then one diff
    per checkpoint listing only the cells that changed.  Recovery rebuilds
    the latest checkpointed state via ``reconstruct()`` (base + diffs in
    order), which a test pins against the cached ``state()``."""

    def __init__(self):
        self.base: Optional[np.ndarray] = None
        self.diffs: List[dict] = []
        self._state: Optional[np.ndarray] = None
        self.next_id = 0

    def checkpoint(self, regs) -> dict:
        regs = np.asarray(regs)
        ckid = self.next_id
        self.next_id += 1
        if self.base is None:
            self.base = regs.copy()
            self._state = regs.copy()
            return dict(id=ckid, kind="full", n_changed=int(regs.size))
        # flat (raveled) indices: rank-agnostic, so [S, R] single-switch
        # and [N, S, R] sharded register stacks diff through the same path
        flat, prev = regs.ravel(), self._state.ravel()
        changed = np.flatnonzero(flat != prev)
        cells = [(int(i), int(flat[i])) for i in changed]
        self.diffs.append(dict(id=ckid, cells=cells))
        self._state = regs.copy()
        return dict(id=ckid, kind="incremental", n_changed=len(cells))

    def state(self) -> Optional[np.ndarray]:
        """Latest checkpointed registers (cached fast path)."""
        return None if self._state is None else self._state.copy()

    def reconstruct(self) -> Optional[np.ndarray]:
        """Rebuild the latest checkpointed registers from base + diffs —
        the honest recovery path (what survives a host restart)."""
        if self.base is None:
            return None
        st = self.base.copy()
        flat = st.ravel()                 # view: writes land in st
        for d in self.diffs:
            for i, v in d["cells"]:
                flat[i] = v
        return st


# ===================================================================== #
#  CLI: python -m repro_torch.db.wal verify <dir>                             #
# ===================================================================== #

def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="repro_torch.db.wal",
        description="segmented hash-chained WAL utilities")
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("verify", help="run the integrity walk over a saved "
                                      "WAL directory")
    v.add_argument("path", help="directory written by SegmentedWAL.save()")
    args = ap.parse_args(argv)
    if args.cmd == "verify":
        try:
            report = SegmentedWAL.load(args.path).verify()
        except (WALIntegrityError, OSError, json.JSONDecodeError,
                KeyError) as e:
            print(f"FAIL: {e}")
            return 1
        print(f"OK: {report['records']} records across {report['segments']} "
              f"segments ({report['sealed']} sealed), hash chain intact")
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
