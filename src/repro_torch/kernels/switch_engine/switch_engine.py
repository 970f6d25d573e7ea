"""Launchers of the switch-engine CUDA kernels, and their plain PyTorch
versions.

The reference runs each ``serial``, ``staged`` and ``affine`` dispatch as
one compiled XLA program (``repro/core/engine.py``: ``_serial_engine_impl``
:98, a ``lax.scan``; ``_staged_engine_impl`` :132, an affine pass per
stage; ``_affine_engine_impl`` :170, a segmented associative scan), with
the result-compaction gather fused in (``_fused_engine_impl`` :232).
``switch_walk_gather_call`` is that program on the card: for a stream of
up to ``WALK_SMEM_MAX`` instructions, ONE launch of the single-CTA walk
kernel in ``csrc/switch_engine.cu`` (a block radix sort of the slot keys,
then a segmented scan of the affine and staged chains or a walk of each
serial chain by one thread, in rounds while ADDP results change); a
longer stream takes the large route (a prep kernel, a stable
``torch.sort`` of the slot keys, the link kernel, the rounds as
multi-block scans or chain walks, then ``result_gather``), with no host
sync on either route.  A CUDA tensor always goes to the kernels (built at
first use by ``kernels/build.py``), a CPU tensor to the plain versions
below; each launch runs on the card that holds the tensors.  There is no
fallback: a failed build or launch raises.
``LAUNCHES`` counts kernel launches only, by route and mode:
``switch_walk_smem.<mode>`` the single-CTA route, ``switch_walk.<mode>``
one per large-route dispatch.

Slot rules, the reference's on every slot (JAX wraps a negative index
once by the array's length, then clamps a read and drops a write):

* every mode: slot ``g = stage * R + reg`` with int32 wraparound; a NOP
  answers 0 with ok 1; sums wrap to int32; an opcode the mode does not
  execute reads.
* serial: ``a = g + S*R`` for a negative ``g``, else ``g``; an ``a``
  outside the file reads the live value of ``clamp(a)`` and drops its
  write.  ADDP adds the result its source has at that moment (0 if it has
  not run).  CADD: ok = post >= 0, keeps the value when post < 0 and
  answers the new value.
* affine: each distinct ``g`` is its own chain (NOPs are keyed ``S*R``),
  seeded from the pre-batch value of ``clamp(g + S*R if g < 0 else g)``.
  A chain with ``g >= S*R`` is never written back; one with ``g < 0``
  writes to ``g + S*R + 1`` when that lies in the file (the reference's
  write-back buffer has one extra slot), and a chain of that slot itself
  wins.  READ answers the pre-value, WRITE and ADD the post-value.
* staged: stages 0..S-1 in turn, each an affine pass over its row (R
  slots) in stream order; an instruction whose stage lies outside [0, S)
  never runs.  ADDP adds its source's result when the source's stage is
  earlier, else 0.

The register file is updated IN PLACE, as by every engine of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.build import (check_int32, library, raise_on,
                                      raw_stream, same_device)
from repro_torch.kernels.switch_txn.switch_txn import (_wrap32,
                                                       result_gather_call,
                                                       result_gather_plain)

NOP, READ, WRITE, ADD, CADD, ADDP = 0, 1, 2, 3, 4, 5
MODES = ("serial", "staged", "affine")       # kSerial, kStaged, kAffine

# the longest stream the single-CTA walk takes (kWalkSmemMax in
# csrc/switch_engine.cu: 19 B an instruction plus the sort's and the
# scan's region, 223,232 bytes at 8,192; 16,384 would need twice that)
WALK_SMEM_MAX = 8192

# rounds of serial walks (and of the large route's staged scans) before
# the one-thread walk takes over (kRoundCap in csrc/switch_engine.cu)
ROUND_CAP = 8

LAUNCHES = {f"{route}.{mode}": 0 for route in ("switch_walk_smem",
                                                "switch_walk")
            for mode in MODES}
_KEY = {mode: (f"switch_walk_smem.{mode}", f"switch_walk.{mode}", i)
        for i, mode in enumerate(MODES)}

_I32 = torch.int32
# C entry points and the stream getter, resolved at the first launch
_SMEM = _PREP = _WALK = _SCRATCH = _STREAM = None


def by_route(launches=None):
    """``LAUNCHES`` (or a copy of it) summed over modes, by route."""
    launches = LAUNCHES if launches is None else launches
    out = {}
    for k, v in launches.items():
        route = k.split(".")[0]
        out[route] = out.get(route, 0) + v
    return out


def _slots(stage, reg, R: int):
    """The flat slot ``stage * R + reg`` of each instruction, int64, with
    the reference's int32 wraparound."""
    return _wrap32(stage.to(torch.int64) * R + reg.to(torch.int64)).to(
        torch.int64)


# ------------------------------------------------------------- serial ----

def serial_plain(registers, op, stage, reg, val):
    """Oracle: sequential execution of the [B, K] instruction stream in
    (txn, instr) order.  Handles every opcode; ADDP adds the result of an
    earlier instruction of the same txn.  Updates ``registers`` in place.

    Values never leave the registers' device, and only the slots the
    stream names are read and written: the loop follows a host copy of
    the (small) instruction stream, and each instruction is a few scalar
    tensor ops on a gathered copy of the touched slots, scattered back at
    the end."""
    S, R = registers.shape
    B, K = op.shape
    n_slots = S * R
    dev = registers.device
    ops_, vals = torch.stack((op, val)).cpu().numpy().reshape(2, -1)
    g = _slots(stage, reg, R).reshape(-1).cpu().numpy()
    a = np.where(g < 0, g + n_slots, g)      # JAX wraps a negative index
    keep = (a >= 0) & (a < n_slots)          # out-of-range writes drop
    live = np.flatnonzero(ops_ != NOP)
    slots, loc = np.unique(np.clip(a[live], 0, n_slots - 1),
                           return_inverse=True)
    slots_t = torch.from_numpy(slots).to(dev)
    flat = registers.view(-1)
    cur = flat[slots_t]                     # [U] the touched slots
    results = torch.zeros(B * K, dtype=torch.int32, device=dev)
    ok = torch.ones(B * K, dtype=torch.bool, device=dev)
    for i, j in zip(live.tolist(), loc.reshape(-1).tolist()):
        o, v = int(ops_[i]), int(vals[i])
        c = cur[j]                          # 0-d view of the slot's value
        if o == WRITE:
            results[i] = v
            if keep[i]:
                c.fill_(v)
            continue
        if o not in (ADD, ADDP, CADD):      # READ, and any other opcode
            results[i] = c
            continue
        addend = results[i - i % K + min(max(v, 0), K - 1)] \
            if o == ADDP else v
        post = _wrap32(c.to(torch.int64) + addend)
        if o == CADD:
            ok[i] = post >= 0
            post = torch.where(ok[i], post, c)
        results[i] = post
        if keep[i]:
            c.copy_(post)
    flat[slots_t] = cur
    return registers, results.view(B, K), ok.view(B, K)


# ------------------------------------------------------------- affine ----

def affine_plain(registers, op, stage, reg, val):
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
    n_slots = S * R
    dev = registers.device
    flat = registers.view(-1)
    opf = op.reshape(-1)
    g = _slots(stage, reg, R).reshape(-1)
    g = torch.where(opf == NOP, n_slots, g)           # sort NOPs to the end
    v = val.reshape(-1)

    gs, order = torch.sort(g, stable=True)           # admission order/slot
    os_ = opf[order]
    vs = v[order].to(torch.int64)
    is_write = os_ == WRITE
    c = torch.where(is_write | (os_ == ADD), vs, torch.zeros_like(vs))
    seg_start = torch.ones(N, dtype=torch.bool, device=dev)
    seg_start[1:] = gs[1:] != gs[:-1]
    seed = torch.where(gs < 0, gs + n_slots, gs).clamp(0, n_slots - 1)
    v0 = flat[seed].to(torch.int64)

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

    # final register value = post at each segment's last element, written
    # to the segment's slot, or for a negative slot to g + n_slots + 1; the
    # NOP segment and slots past the file are dropped; the negative
    # segments go first, so a segment of the same slot overwrites them
    seg_end = torch.ones(N, dtype=torch.bool, device=dev)
    seg_end[:-1] = gs[1:] != gs[:-1]
    tgt = torch.where(gs < 0, gs + n_slots + 1, gs)
    upd = seg_end & (gs < n_slots) & (tgt >= 0) & (tgt < n_slots)
    for part in (upd & (gs < 0), upd & (gs >= 0)):
        flat[tgt[part]] = post[part]

    res = torch.empty(N, dtype=torch.int32, device=dev)
    res[order] = res_sorted                           # unsort
    ok = torch.ones((B, K), dtype=torch.bool, device=dev)
    return registers, res.reshape(B, K), ok


def staged_plain(registers, op, stage, reg, val):
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
        _, res_s, _ = affine_plain(registers[s:s + 1], o_eff, zero_stage,
                                   reg, v_eff)
        results = torch.where(active != NOP, res_s, results)
    return registers, results, torch.ones((B, K), dtype=torch.bool,
                                          device=registers.device)


PLAIN = {"serial": serial_plain, "staged": staged_plain,
         "affine": affine_plain}


def switch_walk_plain(mode, registers, op, stage, reg, val, idx=None):
    """Plain version of the walk kernels: the mode's engine, then the
    result compaction ``compact[j] = res[clamp(idx[j], 0, N - 1)]``."""
    regs, res, ok = PLAIN[mode](registers, op, stage, reg, val)
    compact = None if idx is None else result_gather_plain(
        res.reshape(-1), idx)
    return regs, res, ok, compact


# ------------------------------------------------------------ launchers --

def _resolve():
    """The C entry points and the raw stream getter, resolved once (after
    the build), so later launches take no lock."""
    global _SMEM, _PREP, _WALK, _SCRATCH, _STREAM
    lib = library("switch_engine")
    _SMEM, _PREP = lib.switch_walk_smem_launch, lib.switch_walk_prep_launch
    _WALK, _SCRATCH = lib.switch_walk_launch, lib.switch_walk_scratch_words
    _STREAM = raw_stream()


def _check(mode, registers, op, stage, reg, val, idx):
    """The precise checks, for whatever the fast path of
    ``switch_walk_gather_call`` does not take: raises on a bad argument,
    else returns the one device of the tensors."""
    if mode not in MODES:
        raise ValueError(f"unknown engine mode {mode!r}")
    if not isinstance(registers, torch.Tensor) or registers.dim() != 2:
        raise ValueError("registers must be an [S, R] tensor")
    if not isinstance(op, torch.Tensor) or op.dim() != 2:
        raise ValueError("op must be a [B, K] tensor")
    if not registers.is_contiguous():
        raise ValueError("registers must be contiguous")
    check_int32("registers", registers.view(-1))
    n = op.numel()
    for name, t in (("op", op), ("stage", stage), ("reg", reg),
                    ("val", val)):
        if t.shape != op.shape:
            raise ValueError(f"{name}: expected shape {tuple(op.shape)}, "
                             f"got {tuple(t.shape)}")
        check_int32(name, t.reshape(-1), n)
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    ts = (registers, op, stage, reg, val)
    if idx is not None:
        check_int32("idx", idx)
        ts += (idx,)
    if registers.numel() < 1:
        raise ValueError("registers are empty")
    if idx is not None and idx.numel() and n == 0:
        raise ValueError("src is empty")          # nothing to gather from
    return same_device(*ts)


def _fast(mode, registers, op, stage, reg, val, idx):
    """The CUDA device index when the arguments are what the engine
    passes (int32, contiguous, one card, [S, R] registers, [B, K] planes,
    1-D idx), else None; a few attribute tests a tensor."""
    try:
        d = registers.get_device()
        shape = op.shape
        if (d < 0 or mode not in _KEY or registers.dim() != 2
                or len(shape) != 2 or stage.shape != shape
                or reg.shape != shape or val.shape != shape
                or (idx is not None and idx.dim() != 1)):
            return None
        for t in (registers, op, stage, reg, val) if idx is None else (
                registers, op, stage, reg, val, idx):
            if (t.dtype is not _I32 or not t.is_contiguous()
                    or t.get_device() != d):
                return None
    except AttributeError:
        return None
    return d


def switch_walk_gather_call(mode, registers, op, stage, reg, val, idx=None,
                            rounds=False):
    """One ``serial`` / ``staged`` / ``affine`` dispatch with its result
    compaction.

    registers: [S, R] int32, contiguous, updated in place; op/stage/reg/
    val: [B, K] int32, contiguous; idx: [M] int32 flat positions into the
    result plane (clamped), or None.  Returns (registers, res [B, K]
    int32, ok [B, K] bool, compact [M] int32 or None), and with
    ``rounds=True`` a fifth item: a [1] int32 tensor on the registers'
    device, the rounds the kernel took (affine 1; negative: ``-ROUND_CAP``
    serial rounds, or staged rounds on the large route, did not converge
    and the one-thread walk ran; 0 on the CPU, whose plain versions take
    no rounds).

    On the card, N = B * K <= ``WALK_SMEM_MAX`` is one launch of the
    single-CTA walk; a longer stream takes the large route.  Neither
    copies anything to the host or waits for the device.  The host path
    of the engine's own tensors is a few attribute tests, the outputs'
    allocation and the C call; anything else takes the precise checks."""
    d = _fast(mode, registers, op, stage, reg, val, idx)
    if d is None:
        dev = _check(mode, registers, op, stage, reg, val, idx)
        if dev.type == "cpu":
            out = switch_walk_plain(mode, registers, op, stage, reg, val,
                                    idx)
            return out + (torch.zeros(1, dtype=_I32),) if rounds else out
        d = dev.index
    B, K = op.shape
    n = B * K
    m = 0 if idx is None else idx.shape[0]
    res = torch.empty_like(op)
    ok = torch.empty_like(op, dtype=torch.bool)
    taken = torch.zeros(1, dtype=_I32, device=op.device) if rounds else None
    if n == 0 or registers.numel() == 0:
        _check(mode, registers, op, stage, reg, val, idx)   # raises if bad
        out = (registers, res, ok, None if idx is None else idx.clone())
        return out + (taken,) if rounds else out
    if _SMEM is None:
        _resolve()
    S, R = registers.shape
    smem_key, large_key, mid = _KEY[mode]
    stream = _STREAM(d)
    if n <= WALK_SMEM_MAX:
        compact = None if idx is None else torch.empty_like(idx)
        err = _SMEM(d, mid, registers.data_ptr(), S, R, K, op.data_ptr(),
                    stage.data_ptr(), reg.data_ptr(), val.data_ptr(), n,
                    res.data_ptr(), ok.data_ptr(),
                    idx.data_ptr() if m else None,
                    compact.data_ptr() if m else None, m,
                    taken.data_ptr() if rounds else None, stream)
        if err:
            raise_on(err, "switch_walk_smem")
        LAUNCHES[smem_key] += 1
        out = (registers, res, ok, compact)
        return out + (taken,) if rounds else out
    # the large route: per-instruction keys, seeds and flags; the stable
    # slot order by torch.sort; the link kernel and the rounds
    dev = op.device
    key = torch.empty(n, dtype=torch.int64, device=dev)
    cur = torch.empty(n, dtype=_I32, device=dev)
    vq = torch.empty(n, dtype=_I32, device=dev)
    opf = torch.empty(n, dtype=torch.uint8, device=dev)
    err = _PREP(d, mid, registers.data_ptr(), S, R, K, op.data_ptr(),
                stage.data_ptr(), reg.data_ptr(), val.data_ptr(), n,
                key.data_ptr(), cur.data_ptr(), opf.data_ptr(),
                vq.data_ptr(), res.data_ptr(), stream)
    raise_on(err, "switch_walk_prep")
    skey, perm = torch.sort(key, stable=True)
    scratch = torch.empty(_SCRATCH(n), dtype=_I32, device=dev)
    err = _WALK(d, mid, registers.data_ptr(), S, R, n, skey.data_ptr(),
                perm.data_ptr(), opf.data_ptr(), vq.data_ptr(),
                cur.data_ptr(), res.data_ptr(), ok.data_ptr(),
                scratch.data_ptr(), stream)
    raise_on(err, "switch_walk")
    LAUNCHES[large_key] += 1
    compact = None if idx is None else result_gather_call(res.view(-1),
                                                          idx)
    out = (registers, res, ok, compact)
    return out + (scratch[:1],) if rounds else out
