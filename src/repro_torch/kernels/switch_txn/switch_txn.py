"""Launchers of the switch-transaction CUDA kernels, and their plain
PyTorch versions.

``switch_txn_call`` replaces ``repro/kernels/switch_txn/switch_txn.py::
switch_txn_call`` (Pallas ``_kernel``), ``result_gather_call`` replaces
``result_gather_call`` (``_gather_kernel``) and ``scan_prune_call``
replaces ``scan_prune_call`` (``_scan_prune_kernel``).  Each launcher
takes int32, contiguous, 1-D tensors: a CUDA tensor always goes to the
hand-written kernel in ``csrc/switch_txn.cu`` (built at first use by
``kernels/build.py``), a CPU tensor to the plain version below.  There is no
fallback: a failed build or launch raises.  ``LAUNCHES`` counts kernel
launches only.

The register file is updated IN PLACE — the port's stand-in for JAX's
buffer donation — so callers copy it where they need an old state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.build import (check_int32, library, raise_on,
                                      same_device)

NOP, READ, WRITE, ADD, CADD = 0, 1, 2, 3, 4

LAUNCHES = {"switch_txn": 0, "result_gather": 0, "scan_prune": 0}

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
    lib = library("switch_txn")
    # the permutation the kernel walks: stream positions in stable slot
    # order (the TPU kernel needs none — its grid walks the stream in order)
    sorted_slot, perm = torch.sort(_sort_key(registers_flat, op, g),
                                   stable=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.switch_txn_launch(registers_flat.data_ptr(),
                                registers_flat.shape[0], op.data_ptr(),
                                val.data_ptr(), sorted_slot.data_ptr(),
                                perm.data_ptr(), res.data_ptr(),
                                ok.data_ptr(), n, stream)
    raise_on(err, "switch_txn")
    LAUNCHES["switch_txn"] += 1
    return registers_flat, res, ok


# --------------------------------------------------------- result_gather --

def result_gather_plain(src, idx):
    """Plain PyTorch version: out[i] = src[clamp(idx[i], 0, n-1)]."""
    return src[idx.clamp(0, src.shape[0] - 1).long()]


def result_gather_call(src, idx):
    """Result-compaction gather: src [N] int32, idx [M] int32.  Returns
    out [M] int32 with out[i] = src[clamp(idx[i], 0, N-1)]."""
    check_int32("src", src)
    check_int32("idx", idx)
    if src.shape[0] < 1:
        raise ValueError("src is empty")
    dev = same_device(src, idx)
    if dev.type == "cpu":
        return result_gather_plain(src, idx)
    m = idx.shape[0]
    out = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return out
    lib = library("switch_txn")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.result_gather_launch(src.data_ptr(), src.shape[0],
                                   idx.data_ptr(), out.data_ptr(), m, stream)
    raise_on(err, "result_gather")
    LAUNCHES["result_gather"] += 1
    return out


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


def scan_prune_call(src, lo, hi, cap):
    """Switch-side scan pruning: src [M] int32 value stream, lo/hi int32
    scalars (inclusive range), cap the output capacity.  Returns vals
    [cap] int32 (0-padded), idx [cap] int32 stream positions (-1-padded)
    and agg [4] int32 = (count, sum, min, max) over ALL matches; ``count
    > cap`` tells the caller the output was truncated."""
    check_int32("src", src)
    lo, hi = _int32("lo", lo), _int32("hi", hi)
    cap = int(cap)
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    dev = same_device(src)
    if dev.type == "cpu":
        return scan_prune_plain(src, lo, hi, cap)
    vals = torch.zeros(cap, dtype=torch.int32, device=dev)
    idx = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    agg = torch.tensor([0, 0, AGG_MIN_EMPTY, AGG_MAX_EMPTY],
                       dtype=torch.int32, device=dev)
    m = src.shape[0]
    if m == 0:
        return vals, idx, agg
    lib = library("switch_txn")
    n_scratch = lib.scan_prune_scratch_len(m)
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.scan_prune_launch(src.data_ptr(), m, lo, hi, cap,
                                vals.data_ptr(), idx.data_ptr(),
                                agg.data_ptr(), scratch.data_ptr(), n_scratch,
                                stream)
    raise_on(err, "scan_prune")
    LAUNCHES["scan_prune"] += 1
    return vals, idx, agg
