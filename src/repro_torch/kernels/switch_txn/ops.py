"""Wrappers over the switch_txn kernels (counterparts of
``repro/kernels/switch_txn/ops.py``): flatten (stage, reg) to a global
slot and restore the [B, K] shapes."""
from __future__ import annotations

import torch

from repro_torch.kernels.switch_txn.switch_txn import (
    AGG_MAX_EMPTY, result_gather_call, scan_prune_gather_call,
    scan_prune_gather_packed, switch_txn_gather_call, unpack_scan)


def switch_exec_gather(registers, op, stage, reg, val, idx):
    """One hot dispatch with its result compaction: on the card, one
    launch of the single-CTA kernel for up to ``SMEM_MAX_N`` instructions.

    registers: [S, R] int32 (contiguous, updated in place); op/stage/
    reg/val: [B, K] int32; idx: [M] int32 flat row-major positions into
    the result plane (clamped), or None.

    Returns (registers [S, R], results [B, K], ok [B, K] bool, compact
    [M] int32, or None without ``idx``)."""
    S, R = registers.shape
    B, K = op.shape
    if not registers.is_contiguous():
        raise ValueError("registers must be contiguous")
    flat = lambda t: t.reshape(-1).contiguous()
    _, res, ok, compact = switch_txn_gather_call(
        registers.view(-1), flat(op), flat(stage), flat(reg), flat(val), R,
        None if idx is None else flat(idx))
    return registers, res.reshape(B, K), ok.reshape(B, K), compact


def switch_exec(registers, op, stage, reg, val):
    """registers: [S, R] int32 (contiguous, updated in place); op/stage/
    reg/val: [B, K] int32.

    Returns (registers [S, R], results [B, K], ok [B, K] bool)."""
    return switch_exec_gather(registers, op, stage, reg, val, None)[:3]


def gather_results(res, idx):
    """Result compaction: gather the device-only result positions out of
    the full [B, K] plane (or any int32 tensor, read flat).

    res: [B, K] int32; idx: [M] int32 flat row-major positions (clamped).
    Returns [M] int32."""
    return result_gather_call(res.reshape(-1).contiguous(), idx.contiguous())


def scan_prune_packed(registers, idx, lo, hi, cap):
    """Scan/filter query over the hot slots, pruned on device: gather the
    ``idx`` slots out of the register file, filter by ``lo <= v <= hi``
    and compact the first ``cap`` survivors, all in the scan-prune kernel
    (one launch for up to ``SCAN_SMEM_MAX`` slots).  Only the packed
    result — 2 cap + 4 int32 — ever needs to cross device -> host.

    registers: [S, R] int32; idx: [M] int32 flat slot positions in key
    order.  Returns one int32 tensor [2 cap + 4] = vals [cap] | pos [cap]
    (positions into idx) | agg [4] (count/sum/min/max over all
    matches)."""
    return scan_prune_gather_packed(registers.reshape(-1), idx.contiguous(),
                                    lo, hi, cap)


def scan_prune(registers, idx, lo, hi, cap):
    """``scan_prune_packed`` split into (vals [cap], pos [cap], agg [4])."""
    return scan_prune_gather_call(registers.reshape(-1), idx.contiguous(),
                                  lo, hi, cap)


def scan_topk(registers, idx, lo, hi, k):
    """Top-k gather: the k largest in-range values among the hot slots
    (ties toward the lower key position, the ``lax.top_k`` rule the
    reference uses).  Returns (vals [k], pos [k] int32 positions into idx,
    count of all matches); slots past ``count`` hold the int32-min
    sentinel.  Requires k <= len(idx) (callers clamp).

    ``torch.topk`` documents no order among equal keys, so value and
    position go into one int64 key, value * 2^32 + (2^32 - 1 - position),
    whose entries are all distinct: the masked int32-min entries are
    ordered by position too."""
    src = gather_results(registers, idx)
    in_range = (src >= lo) & (src <= hi)
    masked = torch.where(in_range, src, torch.full_like(src, AGG_MAX_EMPTY))
    pos = torch.arange(src.shape[0], dtype=torch.int64, device=src.device)
    key = masked.to(torch.int64) * 2 ** 32 + (2 ** 32 - 1 - pos)
    top = torch.topk(key, k).indices
    return masked[top], top.to(torch.int32), in_range.sum(dtype=torch.int32)
