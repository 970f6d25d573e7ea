"""Launchers of the switch-transaction CUDA kernels, and their plain
PyTorch versions.

``switch_txn_gather_call`` replaces ``repro/kernels/switch_txn/
switch_txn.py::switch_txn_call`` (Pallas ``_kernel``) and, on the hot
dispatch, ``result_gather_call`` (``_gather_kernel``) in one launch of
the single-CTA kernel for streams of up to ``SMEM_MAX_N`` instructions;
longer streams take the large-N path, ``switch_txn_call`` (a stable
``torch.sort`` and the multi-block walk) then ``result_gather_call``.
``result_gather_call`` also serves the read tier.  ``scan_prune_call``
replaces ``scan_prune_call`` (``_scan_prune_kernel``), and
``scan_prune_gather_call`` / ``scan_prune_gather_packed`` fuse the
result gather into it: one launch per scan of up to ``SCAN_SMEM_MAX``
positions, writing one packed buffer.  Each launcher takes int32,
contiguous, 1-D tensors: a CUDA tensor always goes to a hand-written
kernel in ``csrc/switch_txn.cu`` (built at first use by
``kernels/build.py``) on the card that holds it, a CPU tensor to the
plain versions below.  There is no fallback: a failed build or launch
raises.  ``LAUNCHES`` counts kernel launches only: ``switch_txn_smem``
the single-CTA path, ``switch_txn`` the large-N path; ``scan_prune``
every scan, ``scan_prune_large`` those of the two-launch path.

The register file is updated IN PLACE — the port's stand-in for JAX's
buffer donation — so callers copy it where they need an old state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.build import (check_int32, library, raise_on,
                                      raw_stream, same_device)

NOP, READ, WRITE, ADD, CADD = 0, 1, 2, 3, 4

# the longest stream the single-CTA kernel takes (kSmemMaxN in
# csrc/switch_txn.cu, whose 160 KB working set fits a block's 227 KB)
SMEM_MAX_N = 8192

# the longest stream the single-CTA scan takes (kScanSmemMaxM in
# csrc/switch_txn.cu); a longer one takes the two-launch path
SCAN_SMEM_MAX = 16384

LAUNCHES = {"switch_txn_smem": 0, "switch_txn": 0, "result_gather": 0,
            "scan_prune": 0, "scan_prune_large": 0}

_I32 = torch.int32
# C entry points, resolved at the first CUDA launch; each launch passes
# its tensors' device index first and that device's current stream last
_LARGE = _SMEM = _GATHER = _SCAN = _SCAN_LARGE = _SCAN_SCRATCH = None
_STREAM = None

AGG_MIN_EMPTY = 2147483647        # int32 identities the aggregate lanes
AGG_MAX_EMPTY = -2147483648       # start from (empty-scan sentinels)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (JAX int32 rule)."""
    return (((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)


# ------------------------------------------------------------ switch_txn --

def _sort_key(registers_flat, op, g):
    """Per-instruction sort key: the slot clamped into the register file,
    or ``n_slots`` for a NOP (a NOP touches no register, so the bucket
    padding never forms one long segment at slot 0)."""
    n_slots = registers_flat.shape[0]
    return torch.where(op == NOP, n_slots, g.clamp(0, n_slots - 1))


def switch_txn_plain(registers_flat, op, g, val):
    """Plain version of the switch_txn kernel: the reference kernel's serial
    walk over the stream in order (``repro/kernels/switch_txn/
    switch_txn.py:37-51``), on host copies; slots clamp into the file.
    Updates ``registers_flat`` in place and returns (registers_flat,
    res [N], ok [N] int32)."""
    n_slots = registers_flat.shape[0]
    flat = registers_flat.cpu().numpy().copy()
    ops_, gs, vals = (t.cpu().numpy() for t in (op, g, val))
    res = np.zeros(ops_.shape[0], np.int32)
    ok = np.ones(ops_.shape[0], np.int32)
    for i in range(ops_.shape[0]):
        o = int(ops_[i])
        if o == NOP:                          # res 0, ok 1, no register
            continue
        s, v = min(max(int(gs[i]), 0), n_slots - 1), int(vals[i])
        cur = int(flat[s])
        post = ((cur + v + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31
        new = (v if o == WRITE else
               post if o == ADD or (o == CADD and post >= 0) else cur)
        res[i] = cur if o == READ else new
        ok[i] = post >= 0 if o == CADD else 1
        flat[s] = new
    registers_flat.copy_(torch.from_numpy(flat))
    dev = registers_flat.device
    return (registers_flat, torch.from_numpy(res).to(dev),
            torch.from_numpy(ok).to(dev))


def switch_txn_call(registers_flat, op, g, val):
    """registers_flat: [n_slots] int32, updated in place; op/g/val: [N]
    int32.  Returns (registers_flat, res [N], ok [N] int32)."""
    check_int32("registers_flat", registers_flat)
    check_int32("op", op)
    n = op.shape[0]
    check_int32("g", g, n)
    check_int32("val", val, n)
    if registers_flat.shape[0] < 1:
        raise ValueError("registers_flat is empty")
    dev = same_device(registers_flat, op, g, val)
    if dev.type == "cpu":
        return switch_txn_plain(registers_flat, op, g, val)
    res = torch.empty(n, dtype=torch.int32, device=dev)
    ok = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return registers_flat, res, ok
    if _LARGE is None:
        _resolve()
    # the permutation the kernel walks: stream positions in stable slot
    # order (the TPU kernel needs none — its grid walks the stream in order)
    sorted_slot, perm = torch.sort(_sort_key(registers_flat, op, g),
                                   stable=True)
    err = _LARGE(dev.index, registers_flat.data_ptr(),
                 registers_flat.shape[0], op.data_ptr(), val.data_ptr(),
                 sorted_slot.data_ptr(), perm.data_ptr(), res.data_ptr(),
                 ok.data_ptr(), n, _STREAM(dev.index))
    raise_on(err, "switch_txn")
    LAUNCHES["switch_txn"] += 1
    return registers_flat, res, ok


# --------------------------------------------------------- result_gather --

def result_gather_plain(src, idx):
    """Plain PyTorch version: out[i] = src[clamp(idx[i], 0, n-1)]."""
    return src[idx.clamp(0, src.shape[0] - 1).long()]


def _resolve():
    """The C entry points and the raw stream getter, resolved once (after
    the build), so later launches take no lock."""
    global _LARGE, _SMEM, _GATHER, _SCAN, _SCAN_LARGE, _SCAN_SCRATCH, _STREAM
    lib = library("switch_txn")
    _LARGE = lib.switch_txn_launch
    _SMEM, _GATHER = lib.switch_txn_smem_launch, lib.result_gather_launch
    _SCAN, _SCAN_LARGE = lib.scan_prune_launch, lib.scan_prune_large_launch
    _SCAN_SCRATCH = lib.scan_prune_scratch_len
    _STREAM = raw_stream()


def result_gather_call(src, idx):
    """Result-compaction gather: src [N] int32, idx [M] int32.  Returns
    out [M] int32 with out[i] = src[clamp(idx[i], 0, N-1)].

    The read tier calls this once per read batch, so a CUDA call's host
    path is short: a few attribute tests (the precise checks run only
    when one fails), one output allocation and the C call on the raw
    stream handle."""
    try:
        fast = (src.is_cuda and idx.is_cuda and src.dtype is _I32
                and idx.dtype is _I32 and src.ndim == 1 and idx.ndim == 1
                and src.is_contiguous() and idx.is_contiguous())
    except AttributeError:
        fast = False
    if not fast:                        # the CPU, or an error to raise
        check_int32("src", src)
        check_int32("idx", idx)
        if src.numel() < 1:
            raise ValueError("src is empty")
        same_device(src, idx)
        return result_gather_plain(src, idx)
    n = src.numel()
    if n < 1:
        raise ValueError("src is empty")
    d = src.get_device()
    if d != idx.get_device():
        same_device(src, idx)           # raises: two cards
    out = torch.empty_like(idx)
    m = idx.numel()
    if m:
        if _GATHER is None:
            _resolve()
        err = _GATHER(d, src.data_ptr(), n, idx.data_ptr(), out.data_ptr(),
                      m, _STREAM(d))
        if err:
            raise_on(err, "result_gather")
        LAUNCHES["result_gather"] += 1
    return out


# ------------------------------------------------------ switch_txn_smem --

def switch_txn_gather_call(registers_flat, op, stage, reg, val, R: int,
                           idx=None):
    """One hot dispatch: apply the stream to ``registers_flat`` in place
    and gather its compacted results.

    registers_flat: [n_slots] int32; op/stage/reg/val: [N] int32, each
    instruction on slot ``stage * R + reg`` (int32 wraparound) clamped
    into the file; idx: [M] int32 or None.  Returns (registers_flat, res
    [N] int32, ok [N] bool, compact [M] int32, or None without ``idx``),
    compact[j] = res[clamp(idx[j], 0, N-1)].

    A CUDA tensor with N <= ``SMEM_MAX_N`` is one launch of the
    single-CTA kernel; a longer stream takes the large-N path,
    ``switch_txn_call`` then ``result_gather_call``.  A CPU tensor takes
    the plain versions."""
    ts = (registers_flat, op, stage, reg, val)
    if idx is not None:
        ts += (idx,)
    try:
        n = op.shape[0]
        fast = (all(t.dtype is _I32 and t.dim() == 1 and t.is_contiguous()
                    for t in ts)
                and stage.shape[0] == n and reg.shape[0] == n
                and val.shape[0] == n)
    except (AttributeError, IndexError):
        fast = False
    if not fast:                        # raise the precise error
        check_int32("registers_flat", registers_flat)
        check_int32("op", op)
        n = op.shape[0]
        for name, t in (("stage", stage), ("reg", reg), ("val", val)):
            check_int32(name, t, n)
        if idx is not None:
            check_int32("idx", idx)
    n_slots = registers_flat.shape[0]
    if n_slots < 1:
        raise ValueError("registers_flat is empty")
    m = 0 if idx is None else idx.shape[0]
    if n == 0 and m:
        raise ValueError("src is empty")          # nothing to gather from
    dev = same_device(*ts)
    if n > SMEM_MAX_N:                            # the large-N path
        _, res, ok = switch_txn_call(registers_flat, op,
                                     _wrap32(stage.long() * R + reg), val)
        compact = None if idx is None else result_gather_call(res, idx)
        return registers_flat, res, ok.to(torch.bool), compact
    if dev.type == "cpu":
        _, res, ok = switch_txn_plain(registers_flat, op,
                                      _wrap32(stage.long() * R + reg), val)
        compact = None if idx is None else result_gather_plain(res, idx)
        return registers_flat, res, ok.to(torch.bool), compact
    res = torch.empty(n, dtype=_I32, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    compact = None if idx is None else torch.empty_like(idx)
    if n == 0:
        return registers_flat, res, ok, compact
    if _SMEM is None:
        _resolve()
    d = dev.index
    err = _SMEM(d, registers_flat.data_ptr(), n_slots, int(R), op.data_ptr(),
                stage.data_ptr(), reg.data_ptr(), val.data_ptr(), n,
                res.data_ptr(), ok.data_ptr(),
                idx.data_ptr() if m else None,
                compact.data_ptr() if m else None, m, _STREAM(d))
    if err:
        raise_on(err, "switch_txn_smem")
    LAUNCHES["switch_txn_smem"] += 1
    return registers_flat, res, ok, compact


# ------------------------------------------------------------ scan_prune --

def _int32(name: str, x) -> int:
    x = int(x)
    if not AGG_MAX_EMPTY <= x <= AGG_MIN_EMPTY:
        raise OverflowError(f"{name}={x} does not fit in int32")
    return x


def scan_prune_plain(src, lo, hi, cap):
    """Plain PyTorch version of the scan_prune kernel: the first ``cap``
    matches of ``lo <= v <= hi`` in stream order (values 0-padded,
    positions -1-padded) and (count, int32-wrapped sum, min, max) over all
    matches, with the identities for an empty scan."""
    dev = src.device
    pos = torch.nonzero((src >= lo) & (src <= hi)).squeeze(1)
    count = pos.shape[0]
    t = min(count, cap)
    vals = torch.zeros(cap, dtype=torch.int32, device=dev)
    idx = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    vals[:t] = src[pos[:t]]
    idx[:t] = pos[:t].to(torch.int32)
    if count:
        hits = src[pos]
        agg = torch.stack([torch.tensor(count, dtype=torch.int32, device=dev),
                           _wrap32(hits.to(torch.int64).sum()),
                           hits.min(), hits.max()])
    else:
        agg = torch.tensor([0, 0, AGG_MIN_EMPTY, AGG_MAX_EMPTY],
                           dtype=torch.int32, device=dev)
    return vals, idx, agg


def scan_prune_gather_plain(registers_flat, idx, lo, hi, cap):
    """Plain version of the fused scan: ``scan_prune_plain`` over the
    gathered stream ``result_gather_plain(registers_flat, idx)``."""
    return scan_prune_plain(result_gather_plain(registers_flat, idx), lo,
                            hi, cap)


def unpack_scan(out, cap: int):
    """(vals [cap], pos [cap], agg [4]): views of a packed scan buffer
    ``out`` [2 cap + 4]; the same split of a host copy (numpy) works."""
    return out[:cap], out[cap:2 * cap], out[2 * cap:]


def _scan_large(src, idx, lo, hi, cap, m):
    """The large-M path (M > ``SCAN_SMEM_MAX``): two launches on the
    card, the plain version for CPU tensors."""
    if src.device.type == "cpu":
        return _packed_plain(src, idx, lo, hi, cap)
    if _SCAN is None:
        _resolve()
    scratch = src.new_empty(_SCAN_SCRATCH(m))
    out = src.new_empty(2 * cap + 4)
    d = src.get_device()
    err = _SCAN_LARGE(d, src.data_ptr(), src.shape[0],
                      None if idx is None else idx.data_ptr(), m, lo, hi,
                      cap, out.data_ptr(), scratch.data_ptr(),
                      scratch.shape[0], _STREAM(d))
    if err:
        raise_on(err, "scan_prune")
    LAUNCHES["scan_prune"] += 1
    LAUNCHES["scan_prune_large"] += 1
    return out


def _packed_plain(src, idx, lo, hi, cap):
    vals, pos, agg = (scan_prune_plain(src, lo, hi, cap) if idx is None else
                      scan_prune_gather_plain(src, idx, lo, hi, cap))
    return torch.cat([vals, pos, agg])


def scan_prune_gather_packed(src, idx, lo, hi, cap):
    """The pruned scan of ``src`` [n] int32, read through ``idx`` [M]
    int32 (clamped into src from both sides) when it is given, else of src
    itself.  Returns one int32 buffer [2 cap + 4] = vals [cap] | pos [cap]
    | agg [4], with pos the matches' positions in the stream.  On the
    card, one launch of the single-CTA kernel for M <= ``SCAN_SMEM_MAX``,
    two beyond; the host path is short, as in ``result_gather_call``:
    attribute tests (the precise checks run only when one fails), one
    output allocation and one C call on the raw stream handle, and
    nothing is pre-filled or copied to the card."""
    try:
        fast = (src.is_cuda and src.dtype is _I32 and src.ndim == 1
                and src.is_contiguous())
        if idx is not None:
            fast = (fast and idx.is_cuda and idx.dtype is _I32
                    and idx.ndim == 1 and idx.is_contiguous())
    except AttributeError:
        fast = False
    if not fast:                        # the CPU, or an error to raise
        check_int32("src", src)
        if idx is not None:
            check_int32("idx", idx)
            same_device(src, idx)
        else:
            same_device(src)
    lo, hi = _int32("lo", lo), _int32("hi", hi)
    cap = int(cap)
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    n = src.shape[0]
    if idx is None:
        m = n
    else:
        m = idx.shape[0]
        if n < 1:
            raise ValueError("src is empty")
    if m > SCAN_SMEM_MAX:
        return _scan_large(src, idx, lo, hi, cap, m)
    if not fast:
        return _packed_plain(src, idx, lo, hi, cap)
    d = src.get_device()
    if idx is not None and idx.get_device() != d:
        same_device(src, idx)           # raises: two cards
    out = src.new_empty(2 * cap + 4)
    if _SCAN is None:
        _resolve()
    err = _SCAN(d, src.data_ptr(), n,
                None if idx is None else idx.data_ptr(), m, lo, hi, cap,
                out.data_ptr(), _STREAM(d))
    if err:
        raise_on(err, "scan_prune")
    LAUNCHES["scan_prune"] += 1
    return out


def scan_prune_call(src, lo, hi, cap):
    """Switch-side scan pruning: src [M] int32 value stream, lo/hi int32
    scalars (inclusive range), cap the output capacity.  Returns vals
    [cap] int32 (0-padded), idx [cap] int32 stream positions (-1-padded)
    and agg [4] int32 = (count, sum, min, max) over ALL matches; ``count
    > cap`` tells the caller the output was truncated.  The three are
    views of one packed buffer (``scan_prune_gather_packed``)."""
    return unpack_scan(scan_prune_gather_packed(src, None, lo, hi, cap),
                       int(cap))


def scan_prune_gather_call(registers_flat, idx, lo, hi, cap):
    """The fused scan over the gathered slots, registers_flat [n_slots]
    int32 read through idx [M] int32: ``scan_prune_gather_packed`` split
    into (vals [cap], pos [cap] positions in idx, agg [4])."""
    return unpack_scan(scan_prune_gather_packed(registers_flat, idx, lo, hi,
                                                cap), int(cap))
