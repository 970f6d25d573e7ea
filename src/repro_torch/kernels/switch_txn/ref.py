"""Oracles for the switch-transaction kernels (counterpart of
``repro/kernels/switch_txn/ref.py``).  The switch_exec oracle's loop is
the launcher's plain version, ``switch_txn.switch_txn_plain``; the scan
oracles are plain numpy."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.switch_txn.switch_txn import (AGG_MAX_EMPTY,
                                                       AGG_MIN_EMPTY,
                                                       switch_txn_plain)


def switch_exec_ref(registers, op, stage, reg, val):
    """registers: [S, R] int32; op/stage/reg/val: [B, K] int32 tensors.
    Returns (new_registers, results [B, K], ok [B, K] bool) on the input's
    device; the input registers are not modified."""
    S, R = registers.shape
    B, K = op.shape
    regs = registers.to(torch.int32).clone().reshape(-1)
    flat = lambda t: t.to(torch.int32).reshape(-1)
    _, res, ok = switch_txn_plain(regs, flat(op), flat(stage * R + reg),
                                  flat(val))
    return (regs.reshape(S, R), res.reshape(B, K),
            ok.reshape(B, K).to(torch.bool))


# ------------------------------------------------- scan-pruning oracles --

def scan_prune_ref(src, lo, hi, cap):
    """Plain-numpy oracle for ``scan_prune_call``: first-``cap`` matches
    of ``lo <= v <= hi`` in stream order, plus whole-stream aggregates.

    Returns (vals [cap], idx [cap], agg [4]) with identical padding and
    empty-scan sentinels to the kernel."""
    src = np.asarray(src, np.int32)
    pos = np.flatnonzero((src >= lo) & (src <= hi)).astype(np.int32)
    count = len(pos)
    vals = np.zeros(cap, np.int32)
    idx = np.full(cap, -1, np.int32)
    t = min(count, cap)
    vals[:t] = src[pos[:t]]
    idx[:t] = pos[:t]
    if count:
        # int64 sum cast back to int32: the same wraparound the kernel's
        # int32 accumulator lane exhibits
        s = int(src[pos].astype(np.int64).sum())
        agg = np.array([count, np.int64(s).astype(np.int32),
                        src[pos].min(), src[pos].max()], np.int32)
    else:
        agg = np.array([0, 0, AGG_MIN_EMPTY, AGG_MAX_EMPTY], np.int32)
    return vals, idx, agg


def scan_topk_ref(src, lo, hi, k):
    """Plain-numpy oracle for ``ops.scan_topk``: the k largest in-range
    values, ties broken toward the lower stream position (lax.top_k's
    tie rule).  Returns (vals [k], idx [k], count); slots past ``count``
    hold the int32-min sentinel and whatever position sorted there."""
    src = np.asarray(src, np.int32)
    masked = np.where((src >= lo) & (src <= hi), src,
                      np.int32(AGG_MAX_EMPTY))
    count = int(((src >= lo) & (src <= hi)).sum())
    order = np.lexsort((np.arange(len(src)), -masked.astype(np.int64)))
    top = order[:k].astype(np.int32)
    return masked[top], top, count
