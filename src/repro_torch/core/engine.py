"""The in-switch transaction engine in PyTorch (counterpart of
``repro/core/engine.py``).

Semantics are the reference's (paper §5.1): a packet batch executes in
serial-equivalent admission order, every executed transaction gets a GID,
and the register file stays resident on the engine's device between
calls.  Execution paths, with the reference's mode names:

  serial  — a Python loop over the flat instruction stream; the oracle,
            every opcode including CADD and ADDP.
  affine  — {NOP, READ, WRITE, ADD} as affine maps v' = a*v + c with a in
            {0, 1}: the reference's segmented associative scan becomes a
            segmented cumsum that restarts at each slot and at each WRITE.
  staged  — stage by stage affine passes, forwarding ADDP operands from
            earlier stages' results.
  pallas  — the hand-written CUDA kernels of ``kernels/switch_txn`` (the
            name is kept so every caller validates exactly as before).

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

from repro_torch.core.packets import (ADD, ADDP, CADD, NOP, READ, WRITE,
                                      PacketStager, ReadPacket,
                                      SwitchConfig, result_plane)
from repro_torch.kernels.switch_txn import ops as ktx
from repro_torch.kernels.switch_txn.switch_txn import _wrap32


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


# ------------------------------------------------------------- serial ----

def _serial_engine_impl(registers, op, stage, reg, val):
    """Oracle: sequential execution of the [B, K] instruction stream in
    (txn, instr) order.  Handles every opcode; ADDP adds the result of an
    earlier instruction of the same txn.  Updates ``registers`` in place."""
    S, R = registers.shape
    B, K = op.shape
    n_slots = S * R
    flat = registers.cpu().numpy().reshape(-1).astype(np.int64)
    ops_ = op.cpu().numpy()
    g = stage.cpu().numpy().astype(np.int64) * R + reg.cpu().numpy()
    vals = val.cpu().numpy()
    results = np.zeros((B, K), np.int64)
    ok = np.ones((B, K), bool)
    for b in range(B):
        for k in range(K):
            o = int(ops_[b, k])
            if o == NOP:
                continue
            gi, v = int(g[b, k]), int(vals[b, k])
            cur = int(flat[min(max(gi, 0), n_slots - 1)])
            addend = int(results[b, min(max(v, 0), K - 1)]) if o == ADDP \
                else v
            post = ((cur + addend + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31
            cadd_ok = post >= 0
            new = (v if o == WRITE else
                   post if o in (ADD, ADDP) or (o == CADD and cadd_ok)
                   else cur)
            results[b, k] = cur if o == READ else new
            ok[b, k] = cadd_ok if o == CADD else True
            if 0 <= gi < n_slots:          # out-of-range writes drop
                flat[gi] = new
    dev = registers.device
    registers.copy_(torch.from_numpy(flat.reshape(S, R)).to(torch.int32))
    return (registers,
            torch.from_numpy(results).to(dev, torch.int32),
            torch.from_numpy(ok).to(dev))


# ------------------------------------------------------------- affine ----

def _affine_engine_impl(registers, op, stage, reg, val):
    """Vectorized serial-equivalent execution for {NOP, READ, WRITE, ADD}.

    Every op is v' = a*v + c with a = 0 for WRITE and 1 otherwise, so the
    value after op i is the value at the last reset — the segment start
    (the register's old value) or the latest WRITE (0) — plus the sum of
    c since that reset: a segmented cumsum.  Sums run in int64 and wrap to
    int32, which equals the reference's int32 scan modulo 2^32.  Updates
    ``registers`` in place."""
    S, R = registers.shape
    B, K = op.shape
    N = B * K
    dev = registers.device
    flat = registers.view(-1)
    opf = op.reshape(-1)
    g = (stage * R + reg).reshape(-1).to(torch.int64)
    g = torch.where(opf == NOP, S * R, g)             # sort NOPs to the end
    v = val.reshape(-1)

    gs, order = torch.sort(g, stable=True)           # admission order/slot
    os_ = opf[order]
    vs = v[order].to(torch.int64)
    is_write = os_ == WRITE
    c = torch.where(is_write | (os_ == ADD), vs, torch.zeros_like(vs))
    seg_start = torch.ones(N, dtype=torch.bool, device=dev)
    seg_start[1:] = gs[1:] != gs[:-1]
    v0 = flat[gs.clamp(max=S * R - 1)].to(torch.int64)

    reset = seg_start | is_write                      # a cumsum restarts
    csum = torch.cumsum(c, 0)
    first = torch.nonzero(reset).squeeze(1)
    blk_first = first[torch.cumsum(reset.to(torch.int64), 0) - 1]
    base = torch.where(is_write[blk_first], torch.zeros_like(v0), v0)
    post64 = base + csum - csum[blk_first] + c[blk_first]
    post = _wrap32(post64)
    prev_post = torch.cat([post[:1] * 0, post[:-1]])
    pre = torch.where(seg_start, v0.to(torch.int32), prev_post)
    res_sorted = torch.where(os_ == READ, pre,
                 torch.where(os_ == NOP, torch.zeros_like(post), post))

    # final register value = post at each segment's last element; the NOP
    # segment (slot S*R) is dropped
    seg_end = torch.ones(N, dtype=torch.bool, device=dev)
    seg_end[:-1] = gs[1:] != gs[:-1]
    upd = seg_end & (gs < S * R)
    flat[gs[upd]] = post[upd]

    res = torch.empty(N, dtype=torch.int32, device=dev)
    res[order] = res_sorted                           # unsort
    ok = torch.ones((B, K), dtype=torch.bool, device=dev)
    return registers, res.reshape(B, K), ok


def _staged_engine_impl(registers, op, stage, reg, val):
    """Pipeline-structured vectorized engine: stages execute in order; in
    each stage an affine pass gives the serial-equivalent values, with ADDP
    operands resolved from earlier stages' results (legal because the
    declustered layout puts dependency sources in earlier stages).
    Opcodes: NOP/READ/WRITE/ADD/ADDP.  Updates ``registers`` in place."""
    S, R = registers.shape
    B, K = op.shape
    results = torch.zeros((B, K), dtype=torch.int32, device=registers.device)
    src = val.clamp(0, K - 1).to(torch.int64)
    zero_stage = torch.zeros_like(stage)
    for s in range(S):                       # the pipeline: stage by stage
        active = torch.where(stage == s, op, torch.zeros_like(op))
        prev = torch.gather(results, 1, src)
        v_eff = torch.where(active == ADDP, prev, val)
        o_eff = torch.where(active == ADDP, torch.full_like(active, ADD),
                            active)
        _, res_s, _ = _affine_engine_impl(registers[s:s + 1], o_eff,
                                          zero_stage, reg, v_eff)
        results = torch.where(active != NOP, res_s, results)
    return registers, results, torch.ones((B, K), dtype=torch.bool,
                                          device=registers.device)


_ENGINE_IMPLS = {"serial": _serial_engine_impl,
                 "staged": _staged_engine_impl,
                 "affine": _affine_engine_impl,
                 "pallas": ktx.switch_exec}


def _run_fused(mode: str, registers, fused, Mp: int):
    """One dispatch: run the engine on the fused [N_PLANES, Bp, K] staging
    tensor and gather the compacted device-only result rows."""
    op, stage, reg, val = fused[0], fused[1], fused[2], fused[3]
    idx = fused[4].reshape(-1)[:Mp]
    regs, res, ok = _ENGINE_IMPLS[mode](registers, op, stage, reg, val)
    if mode == "pallas":
        compact = ktx.gather_results(res, idx)
    else:
        flat = res.reshape(-1)
        compact = flat[idx.clamp(0, flat.shape[0] - 1).to(torch.int64)]
    return regs, res, ok, compact


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
            from repro_torch.core.packets import scan_flags
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
        if mode == "pallas":
            def job():
                return ktx.gather_results(self.registers, self._put(idx))
        else:
            def job():
                flat = self.registers.view(-1)
                i = self._put(idx).clamp(0, flat.shape[0] - 1)
                return flat[i.to(torch.int64)]

        self.read_dispatch_count += 1
        out, fut = self._submit(job, defer)
        if fut is not None:
            return PendingRead(None, M, fut=fut)
        return PendingRead(out, M)

    def execute_scan(self, rp: ReadPacket, lo: int, hi: int,
                     cap: Optional[int] = None, k: Optional[int] = None):
        """Switch-side pruned scan — not ported yet."""
        raise NotImplementedError(
            "execute_scan (scan_prune kernel) is not ported yet: ROADMAP "
            "Queue 1 item 4 and Queue 2 kernel 3")

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
    """N-switch register plane — not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ShardedSwitchEngine (n_switches > 1) is not ported yet: "
            "ROADMAP Queue 1 item 6")
