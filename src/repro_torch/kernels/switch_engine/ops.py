"""The entry ``core/engine.py`` calls for a ``serial``, ``staged`` or
``affine`` dispatch (the counterpart of the reference's compiled engine
programs, ``repro/core/engine.py::_fused_engine_impl``)."""
from __future__ import annotations

from repro_torch.kernels.switch_engine.switch_engine import (
    switch_walk_gather_call)


def engine_exec_gather(mode, registers, op, stage, reg, val, idx):
    """One dispatch of engine ``mode`` with its result compaction: on the
    card, one launch of the single-CTA walk kernel for up to
    ``WALK_SMEM_MAX`` instructions; a CPU tensor runs the plain version.
    The engine's planes are views of its contiguous staging tensor, so
    nothing is copied.

    registers: [S, R] int32 (contiguous, updated in place); op/stage/
    reg/val: [B, K] int32; idx: [M] int32 flat row-major positions into
    the result plane (clamped).  Returns (registers [S, R], results
    [B, K], ok [B, K] bool, compact [M] int32)."""
    c = lambda t: t if t.is_contiguous() else t.contiguous()
    return switch_walk_gather_call(mode, registers, c(op), c(stage), c(reg),
                                   c(val), c(idx))
