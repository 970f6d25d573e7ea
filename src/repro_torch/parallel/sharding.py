"""Execution plans (counterpart of ``repro/parallel/sharding.py``), the
single-device part: ``Plan``, the microbatch heuristic and ``make_plan``,
with a data-parallel size of 1.

The reference's logical-axis -> mesh-axis resolution (``spec_for``,
``param_shardings``, ``batch_shardings``, ``cache_shardings``) waits for
the sharding and dry-run slice (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.common.types import ModelConfig, ParallelConfig, ShapeConfig

FAMILY_ACT_FACTOR = {"dense": 1.0, "vlm": 1.0, "audio": 1.0, "moe": 1.6,
                     "hybrid": 2.5, "rwkv": 2.2}


def auto_microbatch(cfg: ModelConfig, shape: ShapeConfig,
                    budget_bytes: float = 6e9) -> int:
    """Smallest power-of-two microbatch count s.t. saved layer-boundary
    activations fit the device budget (remat='full' keeps one [B,L,D]
    residual per layer for backward)."""
    if shape.kind != "train":
        return 1
    b_local = max(shape.global_batch, 1)
    factor = FAMILY_ACT_FACTOR.get(cfg.family, 1.5)
    per_layer = b_local * shape.seq_len * cfg.d_model * 2 * factor
    total = per_layer * cfg.n_layers
    mb = 1
    while total / mb > budget_bytes and mb < b_local:
        mb *= 2
    return mb


@dataclasses.dataclass(frozen=True)
class Plan:
    """Everything launch/train needs for one (arch, shape) on one device."""
    cfg: ModelConfig
    shape: ShapeConfig
    parallel: ParallelConfig
    microbatch: int

    def describe(self):
        return (f"{self.cfg.name} x {self.shape.name}: microbatch="
                f"{self.microbatch} remat={self.parallel.remat} "
                f"moments={self.parallel.moment_dtype}")


def make_plan(cfg: ModelConfig, shape: ShapeConfig,
              parallel: Optional[ParallelConfig] = None) -> Plan:
    parallel = parallel or ParallelConfig()
    mb = auto_microbatch(cfg, shape)
    if parallel.microbatch > 1:
        mb = parallel.microbatch
    # big-model default: quantized moments so optimizer state stays feasible
    moment = parallel.moment_dtype
    if cfg.family == "moe" and moment == "float32":
        moment = "int8"
    parallel = dataclasses.replace(parallel, microbatch=mb, moment_dtype=moment)
    return Plan(cfg, shape, parallel, mb)
