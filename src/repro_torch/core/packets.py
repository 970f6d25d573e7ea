"""Switch-transaction packet format (paper §5.4, Figure 6).

One network packet == one transaction.  A packet carries a header
(is_multipass, locks, nb_recircs) and up to ``max_instrs`` instructions,
each targeting one (stage, register) slot with one operation:

  NOP    —
  READ   result = v
  WRITE  v' = x          result = x
  ADD    v' = v + x      result = v + x        (fixed-point arithmetic)
  CADD   v' = v + x  if  v + x >= 0  else  v   (P4 constrained-write;
         result = v', success flag = applied)  e.g. SmallBank balance >= 0

Tofino constraints modeled (paper §2.3/§4.1):
  * register arrays are partitioned over MAU stages; one access per stage
    register per pipeline pass,
  * access order within a pass must follow stage order (strictly
    increasing stage sequence),
  * violating either forces a multi-pass execution (recirculation).

We model one register array per stage (S stages x R slots); hardware with
k arrays per stage is equivalent to S*k virtual stages (noted in DESIGN.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

NOP, READ, WRITE, ADD, CADD, ADDP = 0, 1, 2, 3, 4, 5
OP_NAMES = {NOP: "nop", READ: "read", WRITE: "write", ADD: "add",
            CADD: "cadd", ADDP: "addp"}
# ADDP: v' = v + result(instr[operand]) — the read value of an earlier
# instruction in the SAME packet is carried in packet metadata and used as
# the operand of a later-stage op (paper Fig 4: "B = B + A").  Only legal
# when the source instruction targets an earlier stage — which is exactly
# what the declustered layout guarantees for single-pass transactions.


@dataclass(frozen=True)
class SwitchConfig:
    n_stages: int = 20
    regs_per_stage: int = 65536      # ~820K 8B tuples/pipe (paper §2.3) / 16
    max_instrs: int = 8
    n_switches: int = 1              # shards in the register plane; hot
                                     # capacity and dispatch bandwidth both
                                     # scale with this (P4DB §8 scale-out)

    @property
    def total_slots(self):
        return self.n_switches * self.n_stages * self.regs_per_stage

    @property
    def slots_per_switch(self):
        return self.n_stages * self.regs_per_stage


def empty_packets(n: int, cfg: SwitchConfig) -> Dict[str, np.ndarray]:
    K = cfg.max_instrs
    return dict(
        op=np.zeros((n, K), np.int32),
        stage=np.zeros((n, K), np.int32),
        reg=np.zeros((n, K), np.int32),
        operand=np.zeros((n, K), np.int32),
        is_multipass=np.zeros((n,), bool),
        locks=np.zeros((n, 2), np.int32),
        nb_recircs=np.zeros((n,), np.int32),
    )


def make_packet(instrs, cfg: SwitchConfig) -> Dict[str, np.ndarray]:
    """instrs: list of (op, stage, reg, operand)."""
    p = empty_packets(1, cfg)
    assert len(instrs) <= cfg.max_instrs, "too many instructions"
    for i, (op, st, rg, val) in enumerate(instrs):
        p["op"][0, i] = op
        p["stage"][0, i] = st
        p["reg"][0, i] = rg
        p["operand"][0, i] = val
    p["is_multipass"][0] = n_passes(p, 0, cfg) > 1
    return p


def concat_packets(pkts) -> Dict[str, np.ndarray]:
    return {k: np.concatenate([p[k] for p in pkts], axis=0)
            for k in pkts[0]}


def split_passes(p: Dict[str, np.ndarray], i: int):
    """Greedy pass decomposition of packet i: a new pass starts whenever the
    stage sequence does not strictly increase (paper §5.2)."""
    passes = []
    cur = []
    last = -1
    K = p["op"].shape[1]
    for k in range(K):
        if p["op"][i, k] == NOP:
            continue
        st = int(p["stage"][i, k])
        if st <= last:
            passes.append(cur)
            cur = []
        cur.append(k)
        last = st
    if cur:
        passes.append(cur)
    return passes or [[]]


def n_passes(p: Dict[str, np.ndarray], i: int, cfg: SwitchConfig = None):
    return len(split_passes(p, i))


def is_single_pass(p: Dict[str, np.ndarray], i: int) -> bool:
    return n_passes(p, i) == 1


def mark_multipass(p: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    for i in range(p["op"].shape[0]):
        passes = split_passes(p, i)
        p["is_multipass"][i] = len(passes) > 1
        p["nb_recircs"][i] = len(passes) - 1
    return p


def mark_multipass_batch(p: Dict[str, np.ndarray],
                         n_ops: np.ndarray) -> Dict[str, np.ndarray]:
    """Vectorized ``mark_multipass`` for packets whose instructions are
    densely packed from slot 0 (NOPs only in the tail, as ``build_packets``
    emits): a new pass starts wherever the stage sequence fails to strictly
    increase.  Also fills ``nb_recircs`` (= passes - 1)."""
    st = p["stage"]
    B, K = st.shape
    valid = np.arange(K)[None, :] < np.asarray(n_ops)[:, None]
    breaks = (st[:, 1:] <= st[:, :-1]) & valid[:, 1:]
    p["is_multipass"] = breaks.any(axis=1)
    p["nb_recircs"] = breaks.sum(axis=1).astype(np.int32)
    return p


def build_packets(txns, hot_index, cfg: SwitchConfig):
    """Vectorized batch packet assembly: one packet per hot transaction, in
    admission (list) order — the switch executes the batch in exactly this
    serial order (paper §5.1).

    Beyond the initial flatten of the Python op tuples, all work — slot
    lookup, reorderability analysis, per-packet stage sorting, scatter into
    the [B, K] arrays, multipass marking — is pure numpy with no per-op
    Python loops.

    Ordering matches the per-txn builder (``Cluster._to_packet``):
    dependency-free transactions (unique keys, no ADDP) are sorted by
    stage so the declustered layout yields single-pass packets; all others
    keep program order.

    Multi-switch encoding: with ``cfg.n_switches > 1`` the packet ``stage``
    field carries the GLOBAL stage id ``switch * n_stages + stage`` — the
    sharded pipeline viewed as one long pipeline — so the packet format
    (and the fused staging-buffer layout) is unchanged; the sharded engine
    decodes ``stage // n_stages`` to route rows, and single-switch configs
    are byte-identical to the pre-sharding encoding.

    Returns ``(pkts, meta)`` where meta carries:
      * ``has_cadd`` / ``has_addp`` — batch opcode presence, so the engine
        can pick its execution path without re-scanning arrays on host,
      * ``n_ops`` [B] — instruction count per packet,
      * ``order`` [B, K] — packet slot -> txn op index permutation,
      * ``shard`` [B] — per-txn switch id, or -1 for a cross-shard txn
        (ops spanning multiple switches).
    """
    B = len(txns)
    K = cfg.max_instrs
    pkts = empty_packets(B, cfg)
    if B == 0:
        return pkts, dict(has_cadd=False, has_addp=False,
                          addp_unsafe=False,
                          n_ops=np.zeros(0, np.int64),
                          order=np.zeros((0, K), np.int64),
                          res_base=np.zeros((0, K), np.int32),
                          gather_idx=np.zeros(0, np.int32),
                          shard=np.zeros(0, np.int32))
    n_ops = np.fromiter((len(t.ops) for t in txns), np.int64, B)
    if n_ops.max(initial=0) > K:
        raise ValueError(f"txn with > max_instrs={K} ops")
    # concatenating the txns' cached ops arrays (Txn.ops_np, parsed once
    # per txn) beats re-iterating Python tuples — the flatten was the hot
    # path's single biggest host-side cost at B=256
    flat = np.concatenate([t.ops_np for t in txns])
    opc = flat[:, 0].astype(np.int32)
    keys = flat[:, 1]
    operand = flat[:, 2].astype(np.int32)
    row = np.repeat(np.arange(B), n_ops)
    offsets = np.cumsum(n_ops) - n_ops
    pos = np.arange(len(flat)) - np.repeat(offsets, n_ops)
    switch, stage, reg = hot_index.slots_np(keys)
    stage = (switch * cfg.n_stages + stage).astype(np.int32)  # global stage
    # per-txn shard id (-1 when a txn's ops span multiple switches)
    smin = np.full(B, np.iinfo(np.int32).max, np.int32)
    smax = np.zeros(B, np.int32)
    np.minimum.at(smin, row, switch)
    np.maximum.at(smax, row, switch)
    shard = np.where(n_ops == 0, 0,
                     np.where(smin == smax, smax, -1)).astype(np.int32)

    # reorderable txns: unique keys and no ADDP (layout.trace_reorderable)
    by_key = np.lexsort((keys, row))
    dup = (row[by_key][1:] == row[by_key][:-1]) & \
          (keys[by_key][1:] == keys[by_key][:-1])
    reorder = np.ones(B, bool)
    reorder[row[by_key][1:][dup]] = False
    has_addp_row = np.zeros(B, bool)
    np.logical_or.at(has_addp_row, row, opc == ADDP)
    reorder &= ~has_addp_row

    # within each packet: sort by stage if reorderable, else program order;
    # ties keep program order (stable, matching list.sort)
    sort_key = np.where(reorder[row], stage, pos.astype(np.int32))
    perm = np.lexsort((pos, sort_key, row))
    slot = pos                                   # rows stay contiguous
    pkts["op"][row, slot] = opc[perm]
    pkts["stage"][row, slot] = stage[perm]
    pkts["reg"][row, slot] = reg[perm]
    pkts["operand"][row, slot] = operand[perm]
    order = np.zeros((B, K), np.int64)
    order[row, slot] = pos[perm]
    mark_multipass_batch(pkts, n_ops)
    base, gather_idx = result_plane(pkts)
    meta = dict(has_cadd=bool((opc == CADD).any()),
                has_addp=bool(has_addp_row.any()),
                addp_unsafe=addp_needs_serial(pkts),
                n_ops=n_ops, order=order,
                res_base=base, gather_idx=gather_idx,
                shard=shard)
    return pkts, meta


def result_plane(p: Dict[str, np.ndarray]):
    """Split a batch's result plane into its host-derivable part and the
    device-only remainder (the async hot path's result compaction).

    WRITE results echo the operand and NOP results are 0 — both known at
    packet-build time — so only the remaining ops (READ, ADD, ADDP, CADD)
    carry information that must travel device -> host.  Returns
    ``(base, idx)``: ``base`` [B, K] int32 holds the host-known results,
    ``idx`` [M] int32 the flat (row-major) positions the engine gathers on
    device; the drained result plane is ``base`` with the M gathered
    values scattered back at ``idx``.  On YCSB-style read/write mixes this
    roughly halves the result bytes shipped to host."""
    op = np.asarray(p["op"])
    operand = np.asarray(p["operand"], np.int32)
    base = np.where(op == WRITE, operand, 0).astype(np.int32)
    idx = np.flatnonzero((op != NOP) & (op != WRITE)).astype(np.int32)
    return base, idx


# staging-buffer layout: one fused [N_PLANES, Bp, K] int32 host buffer per
# dispatch — planes 0..3 are op/stage/reg/operand, plane 4's flat view
# carries the result-compaction gather indices.  ONE jnp.asarray call then
# moves the whole group H2D instead of four-plus transfers.
N_PLANES = 5


class PacketStager:
    """Reusable pre-allocated staging buffers for batch dispatch.

    ``stage`` copies a packet batch (padded to its ``Bp`` shape bucket)
    plus its gather indices into a pooled host buffer and returns it.
    Buffers are recycled round-robin per (Bp, K) shape; the pool is sized
    past the cluster's in-flight window so a buffer is never rewritten
    while an async dispatch could still be reading it."""

    def __init__(self, pool: int = 4):
        self.pool = max(int(pool), 2)
        self._bufs: Dict[tuple, list] = {}
        self._next: Dict[tuple, int] = {}

    def stage(self, p: Dict[str, np.ndarray], idx: np.ndarray,
              Bp: int, Mp: int) -> np.ndarray:
        B, K = np.asarray(p["op"]).shape
        ring = self._bufs.setdefault((Bp, K), [])
        slot = self._next.get((Bp, K), 0)
        if len(ring) <= slot:
            ring.append(np.zeros((N_PLANES, Bp, K), np.int32))
        self._next[(Bp, K)] = (slot + 1) % self.pool
        buf = ring[slot]
        for plane, f in enumerate(("op", "stage", "reg", "operand")):
            buf[plane, :B] = p[f]
            buf[plane, B:] = 0                    # pad rows are NOPs
        flat = buf[4].reshape(-1)
        flat[:len(idx)] = idx
        flat[len(idx):Mp] = 0                     # pad gathers hit slot 0
        return buf


# --------------------------------------------------------- read packets --

@dataclass(frozen=True)
class ReadPacket:
    """READ-only packet batch — the in-network read tier's wire format.

    A read packet carries bare (switch, stage, reg) slots, no opcodes and
    no header: reads never modify registers, so stage-access order is
    irrelevant (no multipass / recirculation) and the pipeline lock is
    never taken — ``is_multipass`` and ``locks`` simply do not exist on
    this class, by construction.  The engine serves the whole batch as
    one device gather (``SwitchEngine.execute_reads``); values come back
    in key (build) order.

    ``switch``/``stage``/``reg`` are flat int32 [n] arrays (one entry per
    requested key, NOT the [B, K] instruction plane — a read has no
    result-ordering metadata to carry)."""
    switch: np.ndarray
    stage: np.ndarray
    reg: np.ndarray

    @property
    def n(self) -> int:
        return int(self.switch.shape[0])

    def flat_idx(self, cfg: SwitchConfig) -> np.ndarray:
        """Per-switch flat register index ``stage * R + reg`` [n]."""
        return (self.stage.astype(np.int64) * cfg.regs_per_stage
                + self.reg).astype(np.int32)


def build_read_packets(keys, hot_index, cfg: SwitchConfig) -> ReadPacket:
    """Assemble one READ-only packet batch for a hot-key vector.

    Slot resolution goes through ``HotIndex.slots_np`` — the placement-
    versioned vectorized lookup the write path uses — so an in-place
    re-placement can never serve a read from a stale slot.  Raises
    KeyError if any key is not hot (callers route cold keys to their
    home-node stores)."""
    keys = np.asarray(keys, np.int64)
    switch, stage, reg = hot_index.slots_np(keys)
    return ReadPacket(switch=switch, stage=stage, reg=reg)


def shard_rows(p: Dict[str, np.ndarray], cfg: SwitchConfig) -> np.ndarray:
    """Per-row switch id [B] decoded from the global-stage encoding
    (``stage // n_stages``); -1 marks a cross-shard row.  Fallback for
    packets that arrive without ``build_packets`` meta (per-op builders,
    tests); all-NOP rows route to shard 0."""
    op = np.asarray(p["op"])
    sw = np.asarray(p["stage"]) // cfg.n_stages
    live = op != NOP
    smin = np.where(live, sw, cfg.n_switches).min(axis=1, initial=cfg.n_switches)
    smax = np.where(live, sw, -1).max(axis=1, initial=-1)
    return np.where(~live.any(axis=1), 0,
                    np.where(smin == smax, smax, -1)).astype(np.int32)


def scan_flags(p: Dict[str, np.ndarray]) -> Dict[str, bool]:
    """Host-side opcode-presence scan for a packet batch — the same three
    flags ``build_packets`` returns in its meta, for packets built by other
    paths (``_to_packet``, tests)."""
    op = np.asarray(p["op"])
    has_cadd = bool((op == CADD).any())
    has_addp = bool((op == ADDP).any())
    return dict(has_cadd=has_cadd, has_addp=has_addp,
                addp_unsafe=has_addp and addp_needs_serial(p))


def addp_unsafe_rows(p: Dict[str, np.ndarray]) -> np.ndarray:
    """Per-packet [B] bool mask: packet i carries an ADDP instruction whose
    source slot executes at the same or a later stage.  The staged engine
    forwards results from *earlier* stages only (the single-pass property
    the declustered layout guarantees); such packets are multipass on real
    hardware and must take the serial path here.  The batched DBMS hot
    path splits its groups at these rows so safe runs stay vectorized."""
    op = np.asarray(p["op"])
    stage = np.asarray(p["stage"])
    K = op.shape[1]
    src = np.clip(np.asarray(p["operand"]), 0, K - 1)
    src_stage = np.take_along_axis(stage, src, axis=1)
    return ((op == ADDP) & (src_stage >= stage)).any(axis=1)


def addp_needs_serial(p: Dict[str, np.ndarray]) -> bool:
    """True if any packet in the batch is ADDP-unsafe (see
    ``addp_unsafe_rows``)."""
    op = np.asarray(p["op"])
    if not (op == ADDP).any():
        return False
    return bool(addp_unsafe_rows(p).any())
