"""The in-switch transaction engine in PyTorch (counterpart of
``repro/core/engine.py``).

Semantics are the reference's (paper §5.1): a packet batch executes in
serial-equivalent admission order, every executed transaction gets a GID,
and the register file stays resident on the engine's device between
calls.  Execution paths, with the reference's mode names:

  serial  — the flat instruction stream in order; the oracle, every
            opcode including CADD and ADDP.
  affine  — {NOP, READ, WRITE, ADD} as affine maps v' = a*v + c with a in
            {0, 1}: one chain per slot, in admission order.
  staged  — stage by stage affine passes, forwarding ADDP operands from
            earlier stages' results.
  pallas  — the hand-written CUDA kernels of ``kernels/switch_txn`` (the
            name is kept so every caller validates exactly as before).

On the card the first three are the walk kernel of
``kernels/switch_engine`` (one launch a dispatch, like the reference's one
compiled program); on the CPU they are its plain versions.

The read tier (``execute_reads``, ``execute_scan``) answers from the same
resident registers through the gather and scan-prune kernels, and
``ShardedSwitchEngine`` runs N such planes on one device.

The register file is an int32 tensor updated IN PLACE by every engine —
the port's replacement for the reference's buffer donation
(``repro/core/engine.py:265``).  Every path that hands registers out or
takes them in (``init_registers``, ``read_all``, ``snapshot``,
``restore``, ``load_registers``) therefore copies.

``device=None`` resolves to ``"cuda"`` and raises when no GPU is present;
it never drops to the CPU.  Pass ``device="cpu"`` explicitly for the
plain versions.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.packets import (ADD, ADDP, NOP, PacketStager,
                                      ReadPacket, SwitchConfig,
                                      result_plane, scan_flags, shard_rows)
from repro_torch.kernels.switch_engine import ops as kwk
from repro_torch.kernels.switch_engine.switch_engine import (
    affine_plain as _affine_engine_impl, serial_plain as _serial_engine_impl,
    staged_plain as _staged_engine_impl)
from repro_torch.kernels.switch_txn import ops as ktx
from repro_torch.kernels.switch_txn.switch_txn import (AGG_MAX_EMPTY,
                                                       AGG_MIN_EMPTY)


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``, which must exist; anything else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain PyTorch versions")
    return dev


def init_registers(cfg: SwitchConfig, values=None, device=None):
    """A fresh [S, R] int32 register file on ``device`` (resolved as by
    ``resolve_device``); always a copy of ``values`` (registers are
    updated in place, so a caller-held array must never be aliased)."""
    device = resolve_device(device)
    shape = (cfg.n_stages, cfg.regs_per_stage)
    if values is None:
        return torch.zeros(shape, dtype=torch.int32, device=device)
    if isinstance(values, torch.Tensor):
        out = values.to(device=device, dtype=torch.int32, copy=True)
    else:
        out = torch.tensor(np.asarray(values), dtype=torch.int32,
                           device=device)
    return out.reshape(shape).contiguous()


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


# the engines of the explicit modes and of ``auto``: the plain versions
# (CPU tensors) and their kernels live in kernels/switch_engine
_ENGINE_IMPLS = {"serial": _serial_engine_impl,
                 "staged": _staged_engine_impl,
                 "affine": _affine_engine_impl}


def _run_fused(mode: str, registers, fused, Mp: int):
    """One dispatch: run the engine on the fused [N_PLANES, Bp, K] staging
    tensor and gather the compacted device-only result rows.  On the
    card every mode is one kernel launch, engine and gather together, for
    a group of up to 8,192 instructions: ``pallas`` the switch_txn kernel
    (``kernels/switch_txn/ops.switch_exec_gather``), ``serial`` /
    ``staged`` / ``affine`` the walk kernel
    (``kernels/switch_engine/ops.engine_exec_gather``); nothing waits for
    the device or copies to the host.  CPU tensors run the plain
    versions."""
    op, stage, reg, val = fused[0], fused[1], fused[2], fused[3]
    idx = fused[4].reshape(-1)[:Mp]
    if mode == "pallas":
        return ktx.switch_exec_gather(registers, op, stage, reg, val, idx)
    return kwk.engine_exec_gather(mode, registers, op, stage, reg, val, idx)


def _bucket(b: int) -> int:
    """Round a batch size up to its power-of-two shape bucket, bounding the
    number of distinct shapes to O(log max_B)."""
    return 1 if b <= 1 else 1 << (b - 1).bit_length()


class PendingRead:
    """Opaque handle to one dispatched READ-only batch — the read tier's
    ``PendingBatch`` sibling.  Carries only the gathered values (device-
    resident until ``values_np()``); there is no ok plane, no GID and no
    WAL footprint: reads are non-durable by construction."""

    __slots__ = ("vals", "n", "_fut", "_np")

    def __init__(self, vals, n, fut=None):
        self.vals, self.n = vals, n
        self._fut = fut
        self._np = None

    def _resolve(self):
        if self._fut is not None:
            self.vals = self._fut.result()
            self._fut = None

    def values_np(self) -> np.ndarray:
        """Materialize the [n] value vector on host (cached)."""
        if self._np is None:
            self._resolve()
            vals = self.vals
            if isinstance(vals, torch.Tensor):
                vals = vals.cpu().numpy()
            self._np = np.array(vals[:self.n])
        return self._np

    def block(self):
        self._resolve()
        if isinstance(self.vals, torch.Tensor):
            _sync(self.vals.device)
        return self

    def ready(self) -> bool:
        return self._np is not None


class PendingBatch:
    """Opaque handle to one dispatched batch — the async hot path's unit
    of in-flight work.

    Device-resident outputs stay on device: ``res`` (full [Bp, K] result
    plane), ``ok`` (success flags) and ``compact`` (the gathered
    device-only result rows).  Host-side metadata — ``base`` (the
    host-derivable results: WRITE echoes, NOP zeros), ``idx`` (flat
    positions of the gathered rows) and ``gids`` — is available
    immediately.  A deferred dispatch carries a future instead of tensors
    until resolved; either way nothing crosses device -> host until
    ``results_np()`` runs, and that transfer ships only the M compacted
    values, not the whole B*K plane.

    Iteration yields ``(results[:B], ok[:B], gids)`` device slices, so
    ``res, ok, gids = engine.execute_batch(...)`` unpacking works."""

    __slots__ = ("res", "ok", "compact", "gids", "B", "K", "base", "idx",
                 "mode", "_fut", "_res_np")

    def __init__(self, res, ok, compact, gids, B, K, base, idx,
                 mode="auto", fut=None):
        self.res, self.ok, self.compact = res, ok, compact
        self.gids, self.B, self.K = gids, B, K
        self.base, self.idx, self.mode = base, idx, mode
        self._fut = fut
        self._res_np = None

    def _resolve(self):
        """Join the dispatch thread's future (deferred handles only)."""
        if self._fut is not None:
            _, self.res, self.ok, self.compact = self._fut.result()
            self._fut = None

    def results_np(self) -> np.ndarray:
        """Materialize the [B, K] result plane on host: the host-known
        base overlaid with the compacted device gather (cached)."""
        if self._res_np is None:
            self._resolve()
            out = self.base.copy()
            if len(self.idx):
                out.reshape(-1)[self.idx] = \
                    self.compact[:len(self.idx)].cpu().numpy()
            self._res_np = out
        return self._res_np

    def ok_np(self) -> np.ndarray:
        self._resolve()
        ok = self.ok
        if isinstance(ok, torch.Tensor):
            ok = ok.cpu().numpy()
        return np.array(ok[:self.B])

    def block(self):
        """Barrier: wait for this dispatch's device work to finish."""
        self._resolve()
        if isinstance(self.res, torch.Tensor):
            _sync(self.res.device)
        return self

    def ready(self) -> bool:
        return self._res_np is not None

    def __iter__(self):
        self._resolve()
        yield self.res[:self.B]
        yield self.ok[:self.B]
        yield self.gids


class SwitchEngine:
    """Functional switch: holds register state on its device, executes
    packet batches in serial-equivalent order, assigns GIDs.

    ``dispatch_count`` counts dispatches — the batched DBMS hot path
    commits a whole group of hot transactions in exactly one."""

    def __init__(self, cfg: SwitchConfig, registers=None,
                 stager_pool: int = 4, async_dispatch: bool = False,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.registers = init_registers(cfg, registers, self.device)
        self.next_gid = 0
        self.dispatch_count = 0
        self.read_dispatch_count = 0    # READ-only gathers (no GID, no WAL)
        self._scan_idx = None           # (host slots, device copy): last scan
        # reusable host staging buffers (one fused H2D per dispatch); the
        # pool must stay deeper than the caller's async in-flight window
        self._stager = PacketStager(pool=stager_pool)
        # async dispatch: a single-worker thread owns all device calls; one
        # worker = FIFO = the switch's serial admission order is preserved
        self.async_dispatch = bool(async_dispatch)
        self._pool = None
        self._last_fut = None
        self._defer_futs = collections.deque()   # submitted, not yet run

    def _put(self, x: np.ndarray) -> torch.Tensor:
        # copy=True: the staging buffer is recycled, so the device tensor
        # must never alias host memory (on the CPU, .to() alone would)
        return torch.from_numpy(x).to(self.device, copy=True)

    # ------------------------------------------------ dispatch thread --
    def _submit(self, job, defer: bool):
        """Run ``job`` inline (sync engine), or on the dispatch thread.
        Returns (outputs, future): exactly one is non-None; ``defer``
        asks for the future, otherwise the call blocks for outputs.

        Backpressure: a staging buffer may only be recycled after the
        job reading it has executed, so outstanding deferred jobs are
        bounded to the stager pool depth — the oldest is joined before a
        submit that would overflow it."""
        if not self.async_dispatch:
            return job(), None
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="switch-dispatch")
        fut = self._pool.submit(job)
        self._last_fut = fut
        if defer:
            self._defer_futs.append(fut)
            while len(self._defer_futs) > self._stager.pool - 2:
                self._defer_futs.popleft().result()
            return None, fut
        out = fut.result()      # FIFO worker: every earlier job is done
        self._defer_futs.clear()
        return out, None

    def _join(self):
        """Wait for every submitted dispatch to finish.  EVERY outstanding
        future is joined, so a failed dispatch re-raises here."""
        while self._defer_futs:
            self._defer_futs.popleft().result()
        if self._last_fut is not None:
            fut, self._last_fut = self._last_fut, None
            fut.result()

    @staticmethod
    def _resolve_mode(mode: str, has_cadd: bool, has_addp: bool,
                      addp_unsafe: bool) -> str:
        if mode == "auto":
            return ("serial" if has_cadd or addp_unsafe else
                    "staged" if has_addp else "affine")
        if mode == "affine" and (has_cadd or has_addp):
            raise ValueError("affine engine handles {READ,WRITE,ADD} only")
        if mode == "staged" and has_cadd:
            raise ValueError("staged engine cannot execute CADD; use serial")
        if mode == "staged" and addp_unsafe:
            raise ValueError("staged engine forwards ADDP results from "
                             "earlier stages only; multipass ADDP packets "
                             "need the serial path")
        if mode == "pallas" and has_addp:
            raise ValueError("pallas kernel has no ADDP opcode; use serial")
        if mode not in ("serial", "staged", "affine", "pallas"):
            raise ValueError(mode)
        return mode

    def execute(self, pkts: Dict[str, np.ndarray], mode: str = "auto"
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Execute a batch (serial order = batch order).

        Returns (results [B,K], success [B,K], gids [B]) on host."""
        pb = self.execute_batch(pkts, meta=None, mode=mode)
        return pb.results_np(), np.asarray(pb.ok_np()), pb.gids

    def execute_batch(self, pkts: Dict[str, np.ndarray],
                      meta: Optional[dict] = None, mode: str = "auto",
                      defer: bool = False, gids=None) -> PendingBatch:
        """The batched hot path: execute all B packets in one dispatch
        (serial order = batch order) and return a ``PendingBatch`` handle
        without forcing materialization.

        ``meta`` is the opcode-presence (+ result-plane) metadata from
        ``packets.build_packets``.  The batch is padded to a power-of-two
        bucket with NOP rows and crosses host -> device as ONE fused
        staging tensor; GIDs go to the B real packets only.  The dispatch
        also gathers the device-only result rows into a compact tensor, so
        draining ships M values to host instead of B*K.  With
        ``defer=True`` on an ``async_dispatch`` engine the dispatch runs on
        the engine's thread and the handle carries a future."""
        op_np = np.asarray(pkts["op"], np.int32)
        B, K = op_np.shape
        if meta is None:
            meta = scan_flags(pkts)
        mode = self._resolve_mode(mode, meta["has_cadd"], meta["has_addp"],
                                  meta["addp_unsafe"])
        if gids is None:
            gids = np.arange(self.next_gid, self.next_gid + B,
                             dtype=np.int64)
        else:
            gids = np.asarray(gids, np.int64)
        if B == 0:
            return PendingBatch(np.zeros((0, K), np.int32),
                                np.zeros((0, K), bool),
                                np.zeros(0, np.int32), gids, 0, K,
                                np.zeros((0, K), np.int32),
                                np.zeros(0, np.int32), mode)

        base = meta.get("res_base")
        idx = meta.get("gather_idx")
        if base is None or idx is None:
            base, idx = result_plane(pkts)
        Bp = _bucket(B)
        Mp = min(_bucket(max(len(idx), 1)), Bp * K)
        # staged on the host thread (the packet arrays may be reused by
        # the caller); the job reads self.registers AT EXECUTION time
        staged = self._stager.stage(pkts, idx, Bp, Mp)

        def job():
            fused = self._put(staged)
            return _run_fused(mode, self.registers, fused, Mp)

        self.dispatch_count += 1
        self.next_gid = max(self.next_gid, int(gids[-1]) + 1)
        out, fut = self._submit(job, defer)
        if fut is not None:
            return PendingBatch(None, None, None, gids, B, K, base, idx,
                                mode, fut=fut)
        _, res, ok, compact = out
        return PendingBatch(res, ok, compact, gids, B, K, base, idx, mode)

    def execute_reads(self, rp: ReadPacket, mode: str = "auto",
                      defer: bool = False) -> PendingRead:
        """The switch-served read path: answer a READ-only packet batch
        straight from the resident registers — no GID, no WAL entry, no
        result plane.  One gather per call (power-of-two index bucket),
        values returned in key order.  On an ``async_dispatch`` engine the
        gather runs on the same FIFO dispatch thread as every write, so it
        observes every earlier write without a drain."""
        M = rp.n
        if M == 0:
            return PendingRead(np.zeros(0, np.int32), 0)
        Mp = _bucket(M)
        idx = np.zeros(Mp, np.int32)
        idx[:M] = rp.flat_idx(self.cfg)
        def job():          # every mode: one result_gather on the card
            return ktx.gather_results(self.registers, self._put(idx))

        self.read_dispatch_count += 1
        out, fut = self._submit(job, defer)
        if fut is not None:
            return PendingRead(None, M, fut=fut)
        return PendingRead(out, M)

    def execute_scan(self, rp: ReadPacket, lo: int, hi: int,
                     cap: Optional[int] = None, k: Optional[int] = None):
        """Switch-side pruned scan over a READ-only slot set: gather the
        slots, filter by ``lo <= v <= hi`` on device, ship only the
        surviving rows (the kernels/switch_txn scan-prune path).

        Exactly one of ``cap``/``k``: ``cap`` returns the first ``cap``
        survivors in slot order plus (count, sum, min, max) aggregates;
        ``k`` returns the k largest in-range values (ties toward the
        lower slot position) plus the match count.  Returns host arrays
        ``(vals, pos, agg_or_count)`` where ``pos`` indexes into ``rp``'s
        key order; like ``execute_reads`` the device call runs on the
        FIFO dispatch thread, so it observes every earlier write without
        a result-plane drain."""
        if (cap is None) == (k is None):
            raise ValueError("exactly one of cap/k")
        idx = self._scan_slots(rp.flat_idx(self.cfg))

        def job():
            if k is not None:
                return ktx.scan_topk(self.registers, idx, lo, hi, k=k)
            return ktx.scan_prune_packed(self.registers, idx, lo, hi, cap)

        self.read_dispatch_count += 1
        out, _ = self._submit(job, defer=False)
        if k is not None:
            vals, pos, count = out
            return vals.cpu().numpy(), pos.cpu().numpy(), int(count)
        # one device -> host copy of vals | pos | agg, split on the host
        return ktx.unpack_scan(out.cpu().numpy(), cap)

    def _scan_slots(self, flat: np.ndarray) -> torch.Tensor:
        """The scan's slot list on the engine's device.  A scan over the
        same slots as the previous one (a repeated range query over one
        hot set, or the rescan after a truncated one) reuses that copy,
        so it needs no host -> device copy; the list is read-only."""
        last = self._scan_idx
        if last is None or not np.array_equal(last[0], flat):
            last = self._scan_idx = (flat, self._put(flat))
        return last[1]

    def read_all(self) -> np.ndarray:
        """A host copy of the [S, R] register file."""
        self._join()
        return self.registers.to("cpu", copy=True).numpy()

    def snapshot(self):
        self._join()
        return self.registers.to("cpu", copy=True).numpy(), self.next_gid

    def restore(self, snap):
        self._join()
        regs, gid = snap
        # init_registers copies: the snapshot (a checkpoint the warm
        # standby may restore from repeatedly) must never be aliased
        self.registers = init_registers(self.cfg, regs, self.device)
        self.next_gid = gid

    def load_registers(self, values):
        """Replace the whole register file ([S, R] host array or tensor);
        copies, never aliases the input."""
        self._join()
        self.registers = init_registers(self.cfg, values, self.device)

    def read_value(self, slot) -> int:
        """Read one register by placement slot ((switch, stage, reg) or
        (stage, reg); a plain engine IS switch 0)."""
        *sw, s, r = slot
        self._join()
        return int(self.registers[s, r])


class ShardedSwitchEngine:
    """N-switch register plane: one ``SwitchEngine`` per shard, each with
    its own register tensor and its own dispatch thread, all on the one
    device the engine was given (the reference pins each plane to its own
    JAX device when several exist; the port keeps every plane on the
    cluster's card).

    A batch arrives with the global-stage encoding (``stage = switch *
    n_stages + stage``; see ``packets.build_packets``).  Rows that live
    entirely on one shard are grouped per shard — preserving per-shard
    admission order — and dispatched per shard (different shards touch
    disjoint registers, so their rows commute in the serial order).  A
    cross-shard row is a barrier: pending groups flush first, then its ops
    execute one mini-dispatch at a time in slot order, forwarding ADDP
    operands across shards on the host (the model of an inter-switch hop
    per dependency).

    The facade owns the GLOBAL gid sequence — sub-dispatches receive their
    rows' ids explicitly — so results, WAL entries and recovery replay
    order are identical to a single switch executing the same admission
    order.  With ``n_switches == 1`` every call delegates verbatim to the
    single plane: the sharded path is byte-identical to ``SwitchEngine``
    by construction."""

    def __init__(self, cfg: SwitchConfig, registers=None,
                 stager_pool: int = 4, async_dispatch: bool = False,
                 device=None):
        from dataclasses import replace
        self.cfg = cfg
        self.n = cfg.n_switches
        self.device = resolve_device(device)
        self.async_dispatch = bool(async_dispatch)
        self.next_gid = 0
        plane_cfg = replace(cfg, n_switches=1)
        regs = None
        if registers is not None:
            regs = registers if isinstance(registers, torch.Tensor) \
                else np.asarray(registers)
            if regs.ndim == 2:
                regs = regs[None] if self.n == 1 else None
            if regs is None or regs.shape[0] != self.n:
                raise ValueError("registers must be [n_switches, S, R]")
        self.planes = [
            SwitchEngine(plane_cfg,
                         registers=None if regs is None else regs[i],
                         stager_pool=stager_pool,
                         async_dispatch=async_dispatch, device=self.device)
            for i in range(self.n)
        ]

    # ------------------------------------------------------- bookkeeping --
    @property
    def dispatch_count(self) -> int:
        return sum(p.dispatch_count for p in self.planes)

    @property
    def read_dispatch_count(self) -> int:
        return sum(p.read_dispatch_count for p in self.planes)

    @property
    def registers(self):
        """The plane's register tensor with one shard; an [N, S, R] copy
        on the engine's device otherwise."""
        if self.n == 1:
            return self.planes[0].registers
        self._join()
        return torch.stack([p.registers for p in self.planes])

    @registers.setter
    def registers(self, values):
        self.load_registers(values)

    def _join(self):
        for p in self.planes:
            p._join()

    # --------------------------------------------------------- execution --
    def execute(self, pkts: Dict[str, np.ndarray], mode: str = "auto"
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        pb = self.execute_batch(pkts, meta=None, mode=mode)
        return pb.results_np(), np.asarray(pb.ok_np()), pb.gids

    def execute_batch(self, pkts: Dict[str, np.ndarray],
                      meta: Optional[dict] = None, mode: str = "auto",
                      defer: bool = False, gids=None):
        if self.n == 1:
            pb = self.planes[0].execute_batch(pkts, meta, mode=mode,
                                              defer=defer, gids=gids)
            self.next_gid = self.planes[0].next_gid
            return pb
        op_np = np.asarray(pkts["op"], np.int32)
        B, K = op_np.shape
        if meta is None:
            meta = scan_flags(pkts)
        shard = meta.get("shard")
        if shard is None:
            shard = shard_rows(pkts, self.cfg)
        # one mode for the whole batch, resolved exactly like the single
        # switch would (explicit modes validate against whole-batch flags)
        mode = SwitchEngine._resolve_mode(
            mode, meta["has_cadd"], meta["has_addp"], meta["addp_unsafe"])
        if gids is None:
            gids = np.arange(self.next_gid, self.next_gid + B,
                             dtype=np.int64)
        else:
            gids = np.asarray(gids, np.int64)
        if B == 0:
            return PendingBatch(np.zeros((0, K), np.int32),
                                np.zeros((0, K), bool),
                                np.zeros(0, np.int32), gids, 0, K,
                                np.zeros((0, K), np.int32),
                                np.zeros(0, np.int32), mode)
        self.next_gid = max(self.next_gid, int(gids.max()) + 1)

        stage_np = np.asarray(pkts["stage"], np.int32)
        reg_np = np.asarray(pkts["reg"], np.int32)
        val_np = np.asarray(pkts["operand"], np.int32)
        S = self.cfg.n_stages
        flags = dict(has_cadd=meta["has_cadd"], has_addp=meta["has_addp"],
                     addp_unsafe=meta["addp_unsafe"])
        parts = []
        pend: Dict[int, list] = {}

        def flush():
            for sw in sorted(pend):
                ridx = np.asarray(pend[sw])
                sub_op = op_np[ridx]
                # global stage -> this shard's local pipeline stage
                sub = dict(op=sub_op,
                           stage=np.where(sub_op != NOP,
                                          stage_np[ridx] - sw * S,
                                          0).astype(np.int32),
                           reg=reg_np[ridx], operand=val_np[ridx])
                base, idx = result_plane(sub)
                sub_meta = dict(flags, res_base=base, gather_idx=idx)
                pb = self.planes[sw].execute_batch(
                    sub, sub_meta, mode=mode,
                    defer=self.async_dispatch, gids=gids[ridx])
                parts.append((ridx, pb, None, None))
            pend.clear()

        for i in range(B):
            sh = int(shard[i])
            if sh >= 0:
                pend.setdefault(sh, []).append(i)
                continue
            flush()        # barrier: a cross-shard row sees every earlier
            res_row, ok_row = self._exec_cross_row(   # row's effects
                op_np[i], stage_np[i], reg_np[i], val_np[i], int(gids[i]))
            parts.append((np.array([i]), None, res_row, ok_row))
        flush()

        handle = _MergedBatch(gids, B, K, parts, mode, self.device)
        if not defer and self.async_dispatch:
            handle.block()     # non-deferred contract: work is done on
        return handle          # return, matching SwitchEngine._submit

    def _exec_cross_row(self, op, stage, reg, val, gid):
        """Execute one cross-shard packet op-by-op in slot order: each op
        is a B=1 serial mini-dispatch on its shard, and ADDP operands are
        resolved on the host from the already-known earlier results (the
        inter-switch result forwarding a real deployment would do with a
        recirculating hop per dependency)."""
        K = len(op)
        S = self.cfg.n_stages
        res = np.zeros(K, np.int32)
        ok = np.ones(K, bool)
        for k in range(K):
            o = int(op[k])
            if o == NOP:
                continue
            sw, s_loc = divmod(int(stage[k]), S)
            v = int(val[k])
            if o == ADDP:       # source result is already materialized:
                o, v = ADD, int(res[min(max(int(val[k]), 0), K - 1)])
            mini = dict(op=np.array([[o]], np.int32),
                        stage=np.array([[s_loc]], np.int32),
                        reg=np.array([[int(reg[k])]], np.int32),
                        operand=np.array([[v]], np.int32))
            pb = self.planes[sw].execute_batch(
                mini, mode="serial", gids=np.array([gid], np.int64))
            res[k] = int(pb.results_np()[0, 0])
            ok[k] = bool(pb.ok_np()[0, 0])
        return res, ok

    def execute_reads(self, rp: ReadPacket, mode: str = "auto",
                      defer: bool = False):
        """Sharded read path: split the READ-only batch by shard, gather
        each shard's values on its own plane (its own dispatch thread),
        scatter back to key order on drain.  Reads touch disjoint
        registers per shard and modify nothing, so no cross-shard barrier
        exists — each key lives on exactly one shard."""
        if self.n == 1:
            return self.planes[0].execute_reads(rp, mode=mode, defer=defer)
        M = rp.n
        if M == 0:
            return PendingRead(np.zeros(0, np.int32), 0)
        parts = []
        for sw in range(self.n):
            pos = np.flatnonzero(rp.switch == sw)
            if not len(pos):
                continue
            sub = ReadPacket(switch=np.zeros(len(pos), np.int32),
                             stage=rp.stage[pos], reg=rp.reg[pos])
            # defer per shard even on a sync call: the shards gather
            # concurrently; _MergedRead's materialization joins them
            pr = self.planes[sw].execute_reads(
                sub, mode=mode, defer=self.async_dispatch)
            parts.append((pos, pr))
        handle = _MergedRead(M, parts)
        if not defer and self.async_dispatch:
            handle.block()
        return handle

    def execute_scan(self, rp: ReadPacket, lo: int, hi: int,
                     cap: Optional[int] = None, k: Optional[int] = None):
        """Sharded pruned scan: each shard filters its own slots on its
        own plane, ships ≤ cap (or k) survivors, and the host merges by
        global key position — the per-shard prefix property makes the
        merge exact (the global first-``cap`` survivors are a union of
        per-shard survivor prefixes, so no shard can hide one)."""
        if self.n == 1:
            return self.planes[0].execute_scan(rp, lo, hi, cap=cap, k=k)
        if (cap is None) == (k is None):
            raise ValueError("exactly one of cap/k")
        cand_pos, cand_vals, aggs, total = [], [], [], 0
        for sw in range(self.n):
            pos = np.flatnonzero(rp.switch == sw)
            if not len(pos):
                continue
            sub = ReadPacket(switch=np.zeros(len(pos), np.int32),
                             stage=rp.stage[pos], reg=rp.reg[pos])
            cc = None if cap is None else min(cap, len(pos))
            kk = None if k is None else min(k, len(pos))
            vals, p, tail = self.planes[sw].execute_scan(
                sub, lo, hi, cap=cc, k=kk)
            if cap is not None:
                t = min(int(tail[0]), cc)
                cand_pos.append(pos[p[:t]])
                cand_vals.append(vals[:t])
                aggs.append(tail)
            else:
                cand_pos.append(pos[p])
                cand_vals.append(vals)
                total += tail
        gp = np.concatenate(cand_pos) if cand_pos else np.zeros(0, np.int32)
        gv = np.concatenate(cand_vals) if cand_vals else np.zeros(0, np.int32)
        if cap is not None:
            order = np.argsort(gp, kind="stable")[:cap]
            vals = np.zeros(cap, np.int32)
            posg = np.full(cap, -1, np.int32)
            vals[:len(order)] = gv[order]
            posg[:len(order)] = gp[order]
            if aggs:
                a = np.stack(aggs)
                agg = np.array([a[:, 0].sum(dtype=np.int32),
                                a[:, 1].sum(dtype=np.int32),
                                a[:, 2].min(), a[:, 3].max()], np.int32)
            else:
                agg = np.array([0, 0, AGG_MIN_EMPTY, AGG_MAX_EMPTY],
                               np.int32)
            return vals, posg, agg
        # global top-k by (-value, global key position): the same tie rule
        # the per-plane top-k applies
        order = np.lexsort((gp, -gv.astype(np.int64)))[:k]
        vals = np.full(k, AGG_MAX_EMPTY, np.int32)
        posg = np.zeros(k, np.int32)
        vals[:len(order)] = gv[order]
        posg[:len(order)] = gp[order]
        return vals, posg, int(total)

    # ------------------------------------------------------ state access --
    def read_all(self) -> np.ndarray:
        """[S, R] with one shard, [N, S, R] stacked otherwise."""
        if self.n == 1:
            return self.planes[0].read_all()
        return np.stack([p.read_all() for p in self.planes])

    def snapshot(self):
        if self.n == 1:
            snap = self.planes[0].snapshot()
            self.next_gid = self.planes[0].next_gid
            return snap
        return self.read_all(), self.next_gid

    def restore(self, snap):
        regs, gid = snap
        if self.n == 1:
            self.planes[0].restore(snap)
        else:
            for i, p in enumerate(self.planes):
                p.restore((regs[i], gid))
        self.next_gid = gid

    def load_registers(self, values):
        """Replace every plane's registers from an [N, S, R] host array or
        tensor (or [S, R] with one shard); copies, never aliases."""
        if not isinstance(values, torch.Tensor):
            values = np.asarray(values)
        if self.n == 1:
            self.planes[0].load_registers(
                values if values.ndim == 2 else values[0])
            return
        if values.ndim != 3 or values.shape[0] != self.n:
            raise ValueError("expected [n_switches, S, R] register stack")
        for i, p in enumerate(self.planes):
            p.load_registers(values[i])

    def read_value(self, slot) -> int:
        sw, s, r = (0, *slot) if len(slot) == 2 else slot
        return self.planes[sw].read_value((s, r))


class _MergedRead:
    """PendingRead-compatible handle over a sharded read gather: per-shard
    value vectors scatter back into the caller's key order on drain."""

    __slots__ = ("n", "_parts", "_np")

    def __init__(self, n, parts):
        self.n = n
        self._parts = parts        # (positions [m], PendingRead)
        self._np = None

    def values_np(self) -> np.ndarray:
        if self._np is None:
            out = np.zeros(self.n, np.int32)
            for pos, pr in self._parts:
                out[pos] = pr.values_np()
            self._np = out
        return self._np

    def block(self):
        for _, pr in self._parts:
            pr.block()
        return self

    def ready(self) -> bool:
        return self._np is not None


class _MergedBatch:
    """PendingBatch-compatible handle over a sharded dispatch: the per-
    shard sub-batches' compacted results scatter back into the caller's
    [B, K] plane on drain; cross-shard rows carry their (already
    materialized) per-op results inline.  Iteration yields
    ``(results, ok, gids)`` with the two planes as tensors on the
    engine's device."""

    __slots__ = ("gids", "B", "K", "mode", "device", "_parts", "_res_np",
                 "_ok_np")

    def __init__(self, gids, B, K, parts, mode="auto", device=None):
        # parts: (row_idx [b], PendingBatch | None, res_row, ok_row)
        self.gids, self.B, self.K, self.mode = gids, B, K, mode
        self.device = device
        self._parts = parts
        self._res_np = None
        self._ok_np = None

    def _materialize(self):
        if self._res_np is None:
            res = np.zeros((self.B, self.K), np.int32)
            ok = np.ones((self.B, self.K), bool)
            for rows, pb, res_row, ok_row in self._parts:
                if pb is not None:
                    res[rows] = pb.results_np()
                    ok[rows] = pb.ok_np()
                else:
                    res[rows[0]] = res_row
                    ok[rows[0]] = ok_row
            self._res_np, self._ok_np = res, ok

    def results_np(self) -> np.ndarray:
        self._materialize()
        return self._res_np

    def ok_np(self) -> np.ndarray:
        self._materialize()
        return self._ok_np

    def block(self):
        for _, pb, _, _ in self._parts:
            if pb is not None:
                pb.block()
        return self

    def ready(self) -> bool:
        return self._res_np is not None

    def __iter__(self):
        self._materialize()
        yield torch.from_numpy(self._res_np).to(self.device, copy=True)
        yield torch.from_numpy(self._ok_np).to(self.device, copy=True)
        yield self.gids
