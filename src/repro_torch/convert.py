"""Carry the reference's state into the port.

``convert_state``: the reference cluster keeps its state as a register
file, a hot-index placement and per-node stores; their host (numpy /
dict) form becomes the port's: a register tensor on a given device, a
port ``HotIndex`` and plain per-node store dicts.  A port ``Cluster``
started from the result continues exactly where the reference left off.

``convert_params``: the reference model zoo's parameters (flat numpy
arrays) become the port's model parameters on a given device.

``convert_opt_state``: the reference's ``AdamWState`` (numpy arrays)
becomes the port's on a given device, so that tests carry optimizer state
as well as weights from one package to the other.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.hotset import HotIndex
from repro_torch.core.layout import Placement
from repro_torch.models.lm import build_defs
from repro_torch.models.params import flatten, torch_dtype
from repro_torch.optim.adamw import AdamWState


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


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A host tensor copy of ``a``; a bfloat16 array (``ml_dtypes``, as
    JAX hands out) is carried over bit for bit."""
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(a)


def convert_params(flat: Mapping[str, np.ndarray], cfg, device=None):
    """The reference's model parameters as the port's.

    flat: ``{name: array}`` under ``repro.models.params.flatten`` names
    of any family (``"embed"``, ``"layers/wq"``, ``"layers/tm/wr"``,
    ``"shared/wq"``, ...), e.g. of ``repro.models.lm.init_params``.  The mapping is the identity on names and shapes: the
    port keeps the reference's flat names and its ``layers/*`` tensors
    stacked over layers (``repro_torch.models.lm.LM`` slices them per
    layer without copying).  Each tensor is cast to its ``ParamDef``'s
    dtype (the router's float32) or else ``cfg.dtype``; a float32 or
    bfloat16 input of a bfloat16 parameter converts exactly.  device:
    ``None`` -> ``cuda``, which must exist.  A missing or extra name, or
    a wrong shape, raises."""
    device = resolve_device(device)
    defs = build_defs(cfg)
    missing, extra = set(defs) - set(flat), set(flat) - set(defs)
    if missing or extra:
        raise KeyError(f"parameter names differ from build_defs: missing "
                       f"{sorted(missing)}, extra {sorted(extra)}")
    out = {}
    for name, d in defs.items():
        a = np.asarray(flat[name])
        if a.shape != d.shape:
            raise ValueError(f"{name}: expected shape {d.shape}, got "
                             f"{a.shape}")
        out[name] = _tensor(a).to(device=device,
                                  dtype=torch_dtype(d.dtype or cfg.dtype))
    return out


def convert_opt_state(state, device=None) -> AdamWState:
    """The reference's optimizer state as the port's.

    state: anything with the fields of ``repro.optim.adamw.AdamWState``
    (``step``, ``m``, ``m_scale``, ``v``, ``v_scale``) holding numpy
    arrays, the moment trees nested as the reference's parameters or
    already flat; bfloat16 payloads carry over bit for bit, int8 and
    float32 as they are.  device: ``None`` -> ``cuda``, which must exist.
    The four moment trees must name the same leaves."""
    device = resolve_device(device)
    trees = {f: flatten(getattr(state, f)) for f in
             ("m", "m_scale", "v", "v_scale")}
    names = set(trees["m"])
    if any(set(t) != names for t in trees.values()):
        raise KeyError("the moment trees name different leaves")
    out = {f: {n: _tensor(np.asarray(a)).to(device) for n, a in t.items()}
           for f, t in trees.items()}
    step = torch.tensor(np.asarray(state.step), dtype=torch.int32,
                        device=device)
    return AdamWState(step, out["m"], out["m_scale"], out["v"],
                      out["v_scale"])
