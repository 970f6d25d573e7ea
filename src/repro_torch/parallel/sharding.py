"""Logical-axis -> mesh-axis resolution (counterpart of
``repro/parallel/sharding.py``).

Parameters/caches/batches carry *logical* axis names (see
models/params.py); this module resolves them to specs for a concrete mesh,
with divisibility guards (an axis that does not divide evenly falls back
to replication — e.g. yi-34b's 56 q-heads on a 16-way model axis).

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry
per array dim, each ``None``, a mesh axis name, or a tuple of names
(major first).  ``placements`` turns it into the ``DTensor`` placements of
a ``torch.distributed`` ``DeviceMesh``, one per mesh dim.  A mesh is a
``DeviceMesh`` with ``mesh_dim_names``, a mapping {axis name: size}, or
``None`` for one device.

Baseline plan:
  batch           -> (pod, data)        [DP]
  embed           -> (pod, data)        [ZeRO-3 / FSDP weight sharding]
  ff/heads/kv/experts/ssm_inner -> model [TP / EP]
  vocab           -> model (if divisible)
  decode kv_seq   -> model              [sequence-sharded KV]
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch.common.types import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.models import decode as Dm

Spec = Tuple[object, ...]

# logical axis -> candidate mesh axes (joined; filtered by mesh + divisibility)
PARAM_RULES: Dict[str, Tuple[str, ...]] = {
    "embed": ("pod", "data"),
    "ff": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("model",),
    "ssm_inner": ("model",),
    "vocab": ("model",),
    "heads_state": ("model",),
    "batch": ("pod", "data"),
    "kv_seq": ("model",),
    "kv_heads_cache": (),
    "layers": (),
    "layers2": (),
}

# logical head-count guards: fused dims may divide evenly while splitting a
# head across devices; these axes are only sharded if the *count* divides.
HEADCOUNT_AXES = {"heads": "n_heads", "kv_heads": "n_kv_heads",
                  "heads_state": None}


def _mesh_sizes(mesh) -> Dict[str, int]:
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def resolve_dim(dim: int, logical: Optional[str], mesh_sizes: Dict[str, int],
                count: Optional[int] = None):
    """Mesh axes for one array dim (or None).  count = head-count guard."""
    if logical is None or logical not in PARAM_RULES:
        return None
    axes = [a for a in PARAM_RULES[logical] if a in mesh_sizes]
    if not axes:
        return None
    total = math.prod(mesh_sizes[a] for a in axes)
    if dim % total != 0:
        # retry with the last axis only (e.g. data without pod)
        axes = axes[-1:]
        total = mesh_sizes[axes[0]]
        if dim % total != 0:
            return None
    if count is not None and count % total != 0:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def spec_for(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
             mesh, cfg: Optional[ModelConfig] = None) -> Spec:
    ms = _mesh_sizes(mesh)
    parts = []
    used = set()
    for dim, ax in zip(shape, axes):
        count = None
        if cfg is not None and ax in HEADCOUNT_AXES and HEADCOUNT_AXES[ax]:
            count = getattr(cfg, HEADCOUNT_AXES[ax])
        r = resolve_dim(dim, ax, ms, count)
        # a mesh axis may appear at most once per spec (e.g. MoE experts
        # take 'model' for EP; the expert ff dim then stays replicated)
        rt = r if isinstance(r, tuple) else (r,) if r else ()
        if any(a in used for a in rt):
            r = None
        else:
            used.update(rt)
        parts.append(r)
    return tuple(parts)


def placements(spec: Spec, mesh):
    """The ``DTensor`` placements of ``spec`` on a ``DeviceMesh``: for each
    mesh dim, ``Shard(d)`` where array dim d names it (``Replicate()``
    on a mesh dim of size 1, the same layout), else ``Replicate()``.  A
    dim over ("pod", "data") is ``Shard(d)`` on both; DTensor splits a dim sharded on several mesh dims in mesh-dim order,
    the first the major one, which is JAX's block order for a spec
    listing the axes in mesh order (the rules always do)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        for a in (part if isinstance(part, tuple) else (part,)):
            if a is None:
                continue
            if a not in names:
                raise ValueError(f"mesh axis {a!r} of spec {spec} is not in "
                                 f"the mesh {names}")
            i = names.index(a)
            if mesh.size(i) > 1:        # a 1-way shard is a replica
                out[i] = Shard(d)
    return out


def lm_defs(cfg):
    from repro_torch.models.lm import build_defs
    return build_defs(cfg)


def param_shardings(cfg: ModelConfig, mesh) -> Dict[str, Spec]:
    """{parameter name: spec} over the flat parameter names."""
    return {n: spec_for(d.shape, d.axes, mesh, cfg)
            for n, d in lm_defs(cfg).items()}


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh
                    ) -> Dict[str, Spec]:
    """Specs for the input batch dict (see launch/specs.py shapes)."""
    b_axes = resolve_dim(shape.global_batch, "batch", _mesh_sizes(mesh))
    if shape.kind in ("train", "prefill"):
        out = {}
        if cfg.frontend == "audio_stub":
            out["frames"] = (b_axes, None, None)
        elif cfg.frontend == "vision_stub":
            out["patches"] = (b_axes, None, None)
            out["tokens"] = (b_axes, None)
        else:
            out["tokens"] = (b_axes, None)
        if shape.kind == "train":
            out["labels"] = (b_axes, None)
        return out
    # decode
    out = {"pos": (b_axes,)}
    if cfg.frontend == "audio_stub":
        out["frames"] = (b_axes, None)
    else:
        out["tokens"] = (b_axes,)
    return out


def cache_shardings(cfg: ModelConfig, batch: int, max_len: int, mesh
                    ) -> Dict[str, Spec]:
    spec = Dm._normalize(Dm.cache_spec(cfg, batch, max_len))
    return {n: spec_for(s, a, mesh, cfg) for n, (s, dt, a) in spec.items()}


# --------------------------------------------------- microbatch heuristic --

FAMILY_ACT_FACTOR = {"dense": 1.0, "vlm": 1.0, "audio": 1.0, "moe": 1.6,
                     "hybrid": 2.5, "rwkv": 2.2}


def auto_microbatch(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    budget_bytes: float = 6e9) -> int:
    """Smallest power-of-two microbatch count s.t. saved layer-boundary
    activations fit the per-device budget (remat='full' keeps one [B,L,D]
    residual per layer for backward)."""
    if shape.kind != "train":
        return 1
    ms = _mesh_sizes(mesh)
    dp = math.prod(v for k, v in ms.items() if k in ("pod", "data"))
    b_local = max(shape.global_batch // dp, 1)
    factor = FAMILY_ACT_FACTOR.get(cfg.family, 1.5)
    per_layer = b_local * shape.seq_len * cfg.d_model * 2 * factor
    total = per_layer * cfg.n_layers
    mb = 1
    while total / mb > budget_bytes and mb < b_local:
        mb *= 2
    return mb


@dataclasses.dataclass(frozen=True)
class Plan:
    """Everything launch/train/dryrun needs for one (arch, shape, mesh)."""
    cfg: ModelConfig
    shape: ShapeConfig
    parallel: ParallelConfig
    microbatch: int

    def describe(self):
        return (f"{self.cfg.name} x {self.shape.name}: microbatch="
                f"{self.microbatch} remat={self.parallel.remat} "
                f"moments={self.parallel.moment_dtype}")


def make_plan(cfg: ModelConfig, shape: ShapeConfig, mesh,
              parallel: Optional[ParallelConfig] = None) -> Plan:
    """``mesh`` None is one device (a data-parallel size of 1)."""
    parallel = parallel or ParallelConfig()
    mb = auto_microbatch(cfg, shape, mesh)
    if parallel.microbatch > 1:
        mb = parallel.microbatch
    # big-model default: quantized moments so optimizer state stays feasible
    moment = parallel.moment_dtype
    if cfg.family == "moe" and moment == "float32":
        moment = "int8"
    parallel = dataclasses.replace(parallel, microbatch=mb, moment_dtype=moment)
    return Plan(cfg, shape, parallel, mb)
