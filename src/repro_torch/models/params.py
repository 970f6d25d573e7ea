"""Parameter definition registry (counterpart of ``repro/models/params.py``).

Every model declares its parameters once as ``ParamDef``s (shape + logical
axes + init style).  The port's parameters are a flat ``{name: tensor}``
dict under the reference's ``flatten`` names (``"layers/wq"``, ...), with
the per-layer tensors stacked over a leading layer axis as in the
reference; ``unflatten`` gives the nested form.  Real init, the dry-run's
meta stand-ins and the sharding specs (``parallel/sharding.py``) all come
from the same defs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

PyTree = dict


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones | fan_in
    scale: float = 0.02
    dtype: Optional[str] = None  # override model dtype (e.g. router in fp32)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a dtype or its name (``"bfloat16"``, ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = getattr(torch, str(dtype), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return dt


def _draw(d: ParamDef, shape, generator, device) -> torch.Tensor:
    """Float32 normal draw of ``shape`` scaled by the def's init style."""
    if d.init == "normal":
        s = d.scale
    elif d.init == "fan_in":
        s = 1.0 / math.sqrt(d.shape[-2] if len(d.shape) >= 2
                            else d.shape[-1])
    else:
        raise ValueError(d.init)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device).mul_(s)


def _init_one(d: ParamDef, generator, dtype, device) -> torch.Tensor:
    dt = torch_dtype(d.dtype) if d.dtype else dtype
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    if d.axes[0] != "layers" or len(d.shape) < 2:
        return _draw(d, d.shape, generator, device).to(dt)
    # one layer at a time: a float32 draw of a whole stacked expert tensor
    # ([4, 128, 4096, 1536] at full width) would take 12.9 GB
    out = torch.empty(d.shape, dtype=dt, device=device)
    for i in range(d.shape[0]):
        out[i] = _draw(d, d.shape[1:], generator, device)
    return out


def init_params(defs: Dict[str, ParamDef], generator: torch.Generator,
                dtype, device) -> Dict[str, torch.Tensor]:
    """Materialize random parameters from ``generator`` (on ``device``),
    in sorted name order.  Returns the flat ``{name: tensor}`` dict.  The
    numbers differ from ``jax.random``'s for the same seed; tests carry
    parameters over with ``repro_torch.convert.convert_params``."""
    dt = torch_dtype(dtype)
    return {n: _init_one(defs[n], generator, dt, device)
            for n in sorted(defs)}


def abstract_params(defs: Dict[str, ParamDef], dtype
                    ) -> Dict[str, torch.Tensor]:
    """Stand-ins on ``torch.device("meta")``: shapes and dtypes, no
    storage (the dry-run path).  The flat ``{name: tensor}`` dict."""
    dt = torch_dtype(dtype)
    return {n: torch.empty(d.shape, dtype=torch_dtype(d.dtype) if d.dtype
                           else dt, device="meta")
            for n, d in defs.items()}


def param_logical_axes(defs: Dict[str, ParamDef]) -> Dict[str, tuple]:
    return {n: d.axes for n, d in defs.items()}


def unflatten(flat: Dict[str, object]) -> PyTree:
    """'a/b/c' keyed dict -> nested dicts."""
    tree: PyTree = {}
    for name, v in flat.items():
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def flatten(tree: PyTree, prefix="") -> Dict[str, object]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, name))
        else:
            out[name] = v
    return out


def count_params(defs: Dict[str, ParamDef]) -> int:
    return sum(int(np.prod(d.shape)) for d in defs.values())
