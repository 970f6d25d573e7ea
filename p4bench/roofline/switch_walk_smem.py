"""Bytes one dispatch of the single-CTA walk kernel (``switch_walk_smem``,
any mode) needs, counted from its packets: each live instruction read
once (opcode, stage, register, operand: 16 bytes), each register slot it
touches read once and each it writes written once (4 bytes), and each
answer the host needs written once (4 bytes).  NOP padding, the full
result and ok planes and the gather's index are the program's choices
and are not counted, so the bound stays below any kernel that computes
the dispatch."""
from __future__ import annotations

import numpy as np

from p4bench.traffic.stream import NOP, WRITE


def bytes_of(rec: dict) -> int:
    """``rec``: ``op``, ``stage``, ``reg`` [B, K] of the packets,
    ``regs_per_stage``, ``answers`` (the device-only answers, M)."""
    op = np.asarray(rec["op"])
    live = op != NOP
    slot = (np.asarray(rec["stage"], np.int64) * rec["regs_per_stage"]
            + np.asarray(rec["reg"], np.int64))
    touched = np.unique(slot[live]).size
    written = np.unique(slot[live & (op >= WRITE)]).size
    return int(16 * live.sum() + 4 * touched + 4 * written
               + 4 * rec["answers"])
