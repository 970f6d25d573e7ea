"""Carry a reference cluster's state into the port.

The reference keeps its state as a register file, a hot-index placement
and per-node stores; this module turns their host (numpy / dict) form
into the port's: a register tensor on a given device, a port ``HotIndex``
and plain per-node store dicts.  It is the port's loader of "weights": a
port ``Cluster`` started from the result continues exactly where the
reference left off.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.hotset import HotIndex
from repro_torch.core.layout import Placement


def convert_state(registers: np.ndarray,
                  placement: Mapping[int, Tuple[int, ...]],
                  stores: Sequence[Mapping[int, int]],
                  device=None):
    """registers: [S, R] int32 host array, or the [N, S, R] stack a
    sharded reference engine's ``read_all()`` gives; placement: ``{key:
    (switch, stage, reg)}`` (or legacy ``(stage, reg)``); stores: one
    ``{key: value}`` mapping per node; device: ``None`` -> ``cuda``, which
    must exist (pass ``"cpu"`` explicitly for the plain versions).

    Returns ``(registers [S, R] or [N, S, R] int32 tensor on device,
    HotIndex, [defaultdict(int) per node])``; nothing aliases the
    inputs."""
    device = resolve_device(device)
    regs = np.asarray(registers)
    if regs.ndim not in (2, 3):
        raise ValueError(f"expected an [S, R] register file or an "
                         f"[N, S, R] stack, got {regs.shape}")
    if regs.dtype != np.int32:
        raise TypeError(f"expected int32 registers, got {regs.dtype}")
    regs_t = torch.tensor(regs, dtype=torch.int32, device=device)
    slot = {int(k): tuple(int(x) for x in s) for k, s in placement.items()}
    out_stores: List[Dict[int, int]] = []
    for st in stores:
        d = collections.defaultdict(int)
        d.update({int(k): int(v) for k, v in st.items()})
        out_stores.append(d)
    return regs_t, HotIndex(Placement(slot=slot)), out_stores
