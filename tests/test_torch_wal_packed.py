"""The port's WAL holds each sealed segment packed (one pickled ``bytes``
object the garbage collector does not walk) and hashes records with one
canonical encoder built once.  Against the JAX package's ``SegmentedWAL``,
which holds every record live and builds an encoder per record: the same
records, types included, the same hashes, slices and ``verify()``
outcomes, edits through the list surface that persist, ``save()`` /
``load()``, a torn tail after a seal, and a cluster's recovery from
packed logs.  Also: what the collector can reach from a long log, the
packed / unpacked counters, and the encoder's bytes against
``json.dumps``."""
import gc
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.db import wal as j_wal  # noqa: E402
from repro.db.dbms import Cluster as JCluster  # noqa: E402
from repro_torch.db import wal as t_wal  # noqa: E402
from repro_torch.db.dbms import Cluster as TCluster  # noqa: E402
from repro_torch.obs.names import G_WAL_PACKED, G_WAL_UNPACKED  # noqa: E402
from test_torch_dbms import (SW, TSW, _assert_same, _indexes,  # noqa: E402
                             _port_txns, _ycsb)

PKGS = (j_wal, t_wal)


def _payloads(n):
    """``n`` (kind, tid, payload) of every kind the port logs, with the
    types they carry: lists of op tuples, result lists, store values,
    strings, numpy ints and arrays, sets."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        tid = 1000 + i
        k = i % 9
        if k == 0:
            out.append(("switch_send", tid, dict(ops=[
                (int(o), int(key), int(v)) for o, key, v in
                rng.integers(0, 1 << 20, (8, 3))])))
        elif k == 1:
            out.append(("switch_result", tid, dict(
                gid=i, results=rng.integers(-5, 5, 8).tolist())))
        elif k == 2:
            out.append(("write", tid, dict(key=int(rng.integers(1 << 40)),
                                           old=-(1 << 63), new=(1 << 64))))
        elif k == 3:
            out.append(("commit", tid, {}))
        elif k == 4:
            out.append(("ckpt", i, dict(reason="interval \"q\"\né",
                                        n_changed=3, full=False)))
        elif k == 5:
            out.append(("early_abort", tid, dict(attempt=2)))
        elif k == 6:
            out.append(("write", np.int64(tid), dict(
                key=np.int64(i), old=np.int32(-3), new=np.uint16(9))))
        elif k == 7:
            out.append(("migrate_begin", tid, dict(
                keys={5, 3, 1}, evict=frozenset({2}),
                slots=np.arange(4, dtype=np.int32), flag=True, none=None)))
        else:
            out.append(("switch_send", tid, dict(ops=[(1, i, -i), [2, i, 0]],
                                                 nested=((1, (2, [3])),))))
    return out


def _fill(wal, n):
    for kind, tid, payload in _payloads(n):
        wal.append(kind, tid, payload)


def _typed(x):
    """``x`` with every value's type beside it, so equal means equal
    types too (a tuple stays a tuple, a numpy int a numpy int)."""
    if isinstance(x, dict):
        return ("dict", sorted((k, _typed(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [_typed(v) for v in x])
    if isinstance(x, (set, frozenset)):
        return (type(x).__name__, sorted(x))
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.tolist())
    return (type(x).__name__, x)


def _rec(r):
    return (r.lsn, r.kind, type(r.tid).__name__, r.tid, _typed(r.payload),
            r.prev, r.hash)


def _verdict(pkg, wal):
    try:
        return wal.verify()
    except pkg.WALIntegrityError as e:
        return ("WALIntegrityError", str(e))


@pytest.mark.parametrize("segment_size", [4, 256])
def test_packed_records_match_jax(segment_size):
    """2,100 records of every kind: the port holds every sealed segment
    packed until read, and then reads exactly the JAX package's records,
    slices, length and ``verify()``."""
    n = 2100
    jw, tw = j_wal.SegmentedWAL(segment_size), t_wal.SegmentedWAL(
        segment_size)
    _fill(jw, n)
    _fill(tw, n)
    sealed = sum(s.sealed for s in tw._segments)
    assert sealed == (n - 1) // segment_size
    assert (tw.packed_segments, tw.unpacked_segments) == (sealed, 0)
    assert len(tw) == len(jw) == n
    assert tw.packed_segments == sealed          # len() unpacks nothing
    assert _rec(tw[-1]) == _rec(jw[-1])
    assert tw.unpacked_segments == 0             # nor does the open tail
    for s in (slice(3, 17), slice(-5, None), slice(None, None, 7),
              slice(n - 9, 5, -3), slice(n, None), slice(10, 10),
              slice(-700, -650)):
        assert [_rec(r) for r in tw[s]] == [_rec(r) for r in jw[s]], s
    for i in (0, 1, segment_size - 1, segment_size, n // 2, -1, -n):
        assert _rec(tw[i]) == _rec(jw[i])
    for i in (n, -n - 1):
        for w in (jw, tw):
            with pytest.raises(IndexError):
                w[i]
    assert [_rec(r) for r in tw] == [_rec(r) for r in jw]
    assert _verdict(t_wal, tw) == _verdict(j_wal, jw)
    assert tw.verify()["ok"]
    assert (tw.packed_segments, tw.unpacked_segments) == (0, sealed)


def _reachable(root) -> int:
    """Objects the collector tracks that it reaches from ``root`` (types
    and modules, shared by everything, not followed)."""
    seen, stack, n = set(), [root], 0
    while stack:
        o = stack.pop()
        if id(o) in seen or isinstance(o, type) or not gc.is_tracked(o):
            continue
        seen.add(id(o))
        n += 1
        stack.extend(gc.get_referents(o))
    return n


@pytest.mark.parametrize("segment_size", [4, 64])
def test_collector_reach_is_bounded_by_segments(segment_size):
    """What the collector can walk in a log is the open segment's records
    and a few objects a sealed segment, whatever the number of records;
    the JAX package's log grows by a record's objects a record."""
    for n in (1000, 4000):
        tw, jw = t_wal.SegmentedWAL(segment_size), j_wal.SegmentedWAL(
            segment_size)
        _fill(tw, n)
        _fill(jw, n)
        segments = len(tw._segments)
        # an open record's objects: itself, its payload, lists and tuples
        # (the 8-op send: one list and 8 tuples); a sealed segment's: its
        # metadata and its packed records
        bound = 12 * segment_size + 4 * segments + 16
        assert _reachable(tw) <= bound
        assert _reachable(jw) > 2 * n > bound
        list(tw)                                 # a read unpacks them all
        assert _reachable(tw) > 2 * n


def test_counters_count_packs_and_unpacks():
    wal = t_wal.SegmentedWAL(4)
    assert (wal.packed_segments, wal.unpacked_segments) == (0, 0)
    _fill(wal, 4)
    assert wal.packed_segments == 0              # full, not yet sealed
    _fill(wal, 1)
    assert wal.packed_segments == 1              # sealed on the roll
    _fill(wal, 16)                               # 21 records, 5 sealed
    assert (wal.packed_segments, wal.unpacked_segments) == (5, 0)
    wal[5]
    wal[6]                                       # the same segment again
    assert (wal.packed_segments, wal.unpacked_segments) == (4, 1)
    wal[-1]
    wal[-1:]
    assert wal.unpacked_segments == 1            # the open segment is live
    wal[0:9]                                     # segments 0 and 2 (1 is)
    assert (wal.packed_segments, wal.unpacked_segments) == (2, 3)
    list(wal)
    list(wal)
    assert (wal.packed_segments, wal.unpacked_segments) == (0, 5)
    _fill(wal, 4)                                # seals one more
    assert (wal.packed_segments, wal.unpacked_segments) == (1, 5)
    wal.verify()
    assert (wal.packed_segments, wal.unpacked_segments) == (0, 6)


def test_cluster_wal_counters():
    """``Cluster.wal_counters`` gives each node's two counters under their
    names; a list-mode node has none."""
    c = TCluster(2, TSW, None, use_switch=False, device="cpu",
                 wal_segment_size=2)
    from repro_torch.db.txn import Txn, key_of
    for i in range(5):
        c.run(Txn("t", [(1, key_of(0, i), 3)], 0))
    got = c.wal_counters()
    assert set(got) == {G_WAL_PACKED, G_WAL_UNPACKED}
    assert got[G_WAL_PACKED][0] == c.nodes[0].wal.packed_segments > 0
    assert got[G_WAL_UNPACKED] == [0, 0]
    list(c.nodes[0].wal)
    assert c.wal_counters()[G_WAL_UNPACKED][0] == got[G_WAL_PACKED][0]
    lc = TCluster(2, TSW, None, use_switch=False, device="cpu",
                  wal_mode="list")
    assert lc.wal_counters() == {G_WAL_PACKED: [], G_WAL_UNPACKED: []}


# ===================================================================== #
#  The encoder                                                          #
# ===================================================================== #

def _dumps(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=t_wal._jsonable).encode()


def test_canon_equals_json_dumps_property():
    """The encoder built once gives ``json.dumps``'s bytes, and the JAX
    package's, for random payloads: big and negative ints, bools, None,
    floats, numpy scalars and arrays, sets, escaped strings, nested lists,
    tuples and dicts."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies
    ints = st.integers(-(1 << 70), 1 << 70)
    leaf = st.one_of(
        st.none(), st.booleans(), ints, st.floats(),
        st.integers(-(1 << 63), (1 << 63) - 1).map(np.int64),
        st.integers(-(1 << 31), (1 << 31) - 1).map(np.int32),
        st.integers(0, (1 << 64) - 1).map(np.uint64),
        st.floats(width=32).map(np.float32), st.floats().map(np.float64),
        st.text(), st.sets(ints, max_size=4),
        st.frozensets(st.integers(-9, 9), max_size=4),
        st.lists(st.integers(-(1 << 31), (1 << 31) - 1), max_size=4).map(
            lambda v: np.array(v, np.int64)))
    payload = st.recursive(leaf, lambda inner: st.one_of(
        st.lists(inner, max_size=4),
        st.lists(inner, max_size=4).map(tuple),
        st.dictionaries(st.text(), inner, max_size=4)), max_leaves=24)

    @hyp.settings(max_examples=400, deadline=None, database=None)
    @hyp.given(payload, st.text(), ints)
    def check(p, kind, tid):
        body = [7, kind, tid, p]
        assert t_wal._canon(body) == _dumps(body) == j_wal._canon(body)
        assert t_wal.record_hash("ab", 7, kind, tid, p) == \
            j_wal.record_hash("ab", 7, kind, tid, p)

    check()


def test_canon_rejects_what_json_dumps_rejects():
    for bad in (object(), [1, {2, "a"}], {"k": np.bool_(True)}, {1: 2j}):
        for enc in (t_wal._canon, _dumps, j_wal._canon):
            with pytest.raises(TypeError):
                enc(bad)


# ===================================================================== #
#  Edits, save / load, torn tail, recovery                              #
# ===================================================================== #

def _flip(wal):
    wal[5].payload["ops"][0][2] += 1


def _reorder(wal):
    wal._records[5], wal._records[6] = wal._records[6], wal._records[5]


def _truncate(wal):
    del wal._records[5]


def _sealed_end(wal):
    wal._records[7] = wal._records[7].__class__(
        **{**wal._records[7].__dict__, "hash": "f" * 64})


EDITS = {"flip": _flip, "reorder": _reorder, "truncate": _truncate,
         "sealed_end": _sealed_end}


def _send(wal, n):
    for i in range(n):
        wal.append("switch_send", i, dict(ops=[[1, 7, i]]))


@pytest.mark.parametrize("edit", list(EDITS))
def test_edit_in_packed_segment_is_caught(edit):
    """Flip, reorder and truncate on a record of a sealed, packed segment
    persist and fail ``verify()`` with the JAX package's message."""
    out = []
    for pkg in PKGS:
        wal = pkg.SegmentedWAL(segment_size=4)
        _send(wal, 13)
        if pkg is t_wal:
            assert wal.packed_segments == 3
        EDITS[edit](wal)
        out.append(([_rec(r) for r in wal], _verdict(pkg, wal)))
    assert out[0] == out[1]
    assert out[1][1][0] == "WALIntegrityError"
    if edit == "flip":
        assert out[1][0][5][4] == ("dict", [("ops", ("list", [
            ("list", [("int", 1), ("int", 7), ("int", 6)])]))])


def test_save_load_half_packed(tmp_path):
    """A log with one segment read back (live), one still packed and an
    open tail saves, loads under both packages and verifies; the port's
    load holds sealed segments packed again."""
    wal = t_wal.SegmentedWAL(segment_size=4)
    ref = j_wal.SegmentedWAL(segment_size=4)
    _fill(wal, 10)
    _fill(ref, 10)
    wal[1]
    assert (wal.packed_segments, wal.unpacked_segments) == (1, 1)
    d = str(tmp_path / "wal")
    wal.save(d)
    loaded = [pkg.SegmentedWAL.load(d) for pkg in PKGS]
    assert loaded[1].packed_segments == 2
    # a JSONL round trip turns tuples into lists on both sides
    assert [[(r.lsn, r.kind, r.tid, r.payload, r.prev, r.hash) for r in w]
            for w in loaded] == \
        [[(r.lsn, r.kind, r.tid, json.loads(_dumps(r.payload)), r.prev,
           r.hash) for r in ref]] * 2
    assert [w.verify() for w in loaded] == [ref.verify()] * 2
    assert [pkg.main(["verify", d]) for pkg in PKGS] == [0, 0]


@pytest.mark.parametrize("n", [8, 9, 10])
def test_tear_tail_after_seal(n):
    """Tearing the open segment right after a seal, then appending: the
    chain continues from the packed segment's last record without
    unpacking it, as the JAX package's does."""
    out = []
    for pkg in PKGS:
        wal = pkg.SegmentedWAL(segment_size=4)
        _send(wal, n)
        torn = wal.tear_tail(5)
        _send(wal, 2)
        if pkg is t_wal:
            assert wal.unpacked_segments == 0
        out.append((torn, [_rec(r) for r in wal], _verdict(pkg, wal),
                    len(wal._segments)))
    assert out[0] == out[1]
    assert out[1][2]["ok"]


def test_recovery_from_packed_wals_matches_jax():
    """An async YCSB-A cluster whose WALs hold packed segments: crash and
    recovery leave the JAX package's registers, and every WAL record."""
    traces, top_k, txns, loads, n_nodes = _ycsb(480)
    jhi, thi = _indexes(traces, top_k)
    jc = JCluster(n_nodes, SW, jhi, async_hot=True, wal_segment_size=8)
    tc = TCluster(n_nodes, TSW, thi, async_hot=True, wal_segment_size=8,
                  device="cpu")
    ttxns = _port_txns(txns)
    for i in range(0, len(txns), 60):
        jc.run_batch(txns[i:i + 60])
        tc.run_batch(ttxns[i:i + 60])
    jc.drain()
    tc.drain()
    packed = tc.wal_counters()[G_WAL_PACKED]
    assert min(packed) > 0 and tc.wal_counters()[G_WAL_UNPACKED] == \
        [0] * n_nodes
    before = np.asarray(tc.switch.read_all()).copy()
    assert jc.crash_switch_and_recover() == tc.crash_switch_and_recover()
    np.testing.assert_array_equal(before, tc.switch.read_all())
    _assert_same(jc, tc)
    assert all(w.verify()["ok"] for w in (n.wal for n in tc.nodes))
