"""Oracle for the switch-transaction kernel: a plain serial loop over the
flattened instruction stream (counterpart of
``repro/kernels/switch_txn/ref.py::switch_exec_ref``).  The loop is the
launcher's plain version, ``switch_txn.switch_txn_plain``."""
from __future__ import annotations

import torch

from repro_torch.kernels.switch_txn.switch_txn import switch_txn_plain


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
