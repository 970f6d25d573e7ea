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
"""
from __future__ import annotations

import hashlib
import json
import os
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


def _canon(obj) -> bytes:
    # sort_keys + fixed separators => byte-stable serialization; tuples and
    # lists serialize identically, so hashes survive a JSONL round-trip
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=_jsonable).encode()


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


class SegmentedWAL:
    """Segmented append-only hash-chained log (see module docstring)."""

    def __init__(self, segment_size: int = DEFAULT_SEGMENT_SIZE):
        if segment_size < 1:
            raise ValueError("segment_size must be >= 1")
        self.segment_size = int(segment_size)
        self._records: List[WALRecord] = []
        self._segments: List[SegmentMeta] = [SegmentMeta(0, 0)]

    # ------------------------------------------------------------ append
    def append(self, kind: str, tid: int, payload: dict) -> WALRecord:
        if self._records:
            prev, lsn = self._records[-1].hash, self._records[-1].lsn + 1
        else:
            prev, lsn = GENESIS, 0
        seg = self._segments[-1]
        if seg.count >= self.segment_size:          # seal full segment, roll
            seg.sealed = True
            seg.seal_hash = self._records[-1].hash
            seg = SegmentMeta(seg.index + 1, lsn)
            self._segments.append(seg)
        rec = WALRecord(lsn, kind, int(tid), payload, prev,
                        record_hash(prev, lsn, kind, int(tid), payload))
        self._records.append(rec)
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
        prev = GENESIS
        expected_lsn = 0
        for r in self._records:
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
            recs = self._records[pos:pos + seg.count]
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
        if pos != len(self._records):
            raise WALIntegrityError(
                f"{len(self._records) - pos} records beyond the last "
                f"segment boundary: metadata truncation")
        return dict(ok=True, records=len(self._records),
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
        del self._records[len(self._records) - n:]
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
        pos = 0
        for seg in self._segments:
            fname = os.path.join(path, f"seg-{seg.index:05d}.jsonl")
            with open(fname, "w") as f:
                for r in self._records[pos:pos + seg.count]:
                    f.write(json.dumps(
                        dict(lsn=r.lsn, kind=r.kind, tid=r.tid,
                             payload=r.payload, prev=r.prev, hash=r.hash),
                        sort_keys=True, separators=(",", ":"),
                        default=_jsonable) + "\n")
            pos += seg.count
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        return dict(records=len(self._records), segments=len(self._segments))

    @classmethod
    def load(cls, path: str) -> "SegmentedWAL":
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        wal = cls(segment_size=manifest["segment_size"])
        wal._segments = [SegmentMeta(m["index"], m["start_lsn"], m["count"],
                                     m["sealed"], m["seal_hash"])
                         for m in manifest["segments"]]
        wal._records = []
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
