"""Wrappers over the switch_txn kernels (counterparts of
``repro/kernels/switch_txn/ops.py``): flatten (stage, reg) to a global
slot and restore the [B, K] shapes."""
from __future__ import annotations

import torch

from repro_torch.kernels.switch_txn.switch_txn import (result_gather_call,
                                                       switch_txn_call)


def switch_exec(registers, op, stage, reg, val):
    """registers: [S, R] int32 (contiguous, updated in place); op/stage/
    reg/val: [B, K] int32.

    Returns (registers [S, R], results [B, K], ok [B, K] bool)."""
    S, R = registers.shape
    B, K = op.shape
    if not registers.is_contiguous():
        raise ValueError("registers must be contiguous")
    g = (stage * R + reg).reshape(-1).contiguous()
    _, res, ok = switch_txn_call(registers.view(-1),
                                 op.reshape(-1).contiguous(), g,
                                 val.reshape(-1).contiguous())
    return registers, res.reshape(B, K), ok.reshape(B, K).to(torch.bool)


def gather_results(res, idx):
    """Result compaction: gather the device-only result positions out of
    the full [B, K] plane (or any int32 tensor, read flat).

    res: [B, K] int32; idx: [M] int32 flat row-major positions (clamped).
    Returns [M] int32."""
    return result_gather_call(res.reshape(-1).contiguous(), idx.contiguous())
