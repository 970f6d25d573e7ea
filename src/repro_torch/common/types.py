"""Shared configuration dataclasses (copy of ``repro/common/types.py``)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    n_shared_experts: int = 0          # kimi-k2 style shared expert(s)
    router_dtype: str = "float32"
    # 'switch_engine' uses the P4DB-style prefix arbitration (paper technique),
    # 'cumsum' is the conventional dense one-hot cumsum router.
    arbitration: str = "switch_engine"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    chunk: int = 128


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 (Finch) block configuration."""
    head_dim: int = 64
    chunk: int = 128
    decay_lora: int = 64


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: shared attention block applied every k SSM blocks."""
    attn_every: int = 6


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | rwkv | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    act: str = "silu"                # silu (SwiGLU) | gelu (GeGLU) | relu_sq
    mlp_gated: bool = True           # False -> plain 2-matrix MLP (starcoder2)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    hybrid: Optional[HybridConfig] = None
    frontend: str = "none"           # none | vision_stub | audio_stub
    n_frontend_tokens: int = 256     # patches / audio frames provided by the stub
    dtype: str = "bfloat16"
    # attention chunking (blockwise/online-softmax attention) — perf knobs
    q_chunk: int = 512
    kv_chunk: int = 1024
    # dry-run mode: python-unrolled loops so HLO costs are loop-free/exact
    unroll: bool = False
    # True when the architecture supports O(1)-state decode at 500k ctx
    subquadratic: bool = False

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads


@dataclass(frozen=True)
class ShapeConfig:
    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class ParallelConfig:
    """Logical->mesh axis plan plus memory knobs, chosen per (arch, shape)."""
    data_axes: Tuple[str, ...] = ("pod", "data")   # batch sharding axes
    fsdp_axes: Tuple[str, ...] = ("data",)         # parameter (ZeRO-3) sharding
    tp_axis: Optional[str] = "model"               # tensor parallel axis
    ep_axis: Optional[str] = "model"               # expert parallel axis (MoE)
    seq_axis: Optional[str] = None                 # residual-stream sequence sharding ("model" = megatron-SP style)
    remat: str = "full"                            # none | full | dots
    microbatch: int = 1                            # gradient accumulation steps
    moment_dtype: str = "float32"                  # adam moments: float32|bfloat16|int8
    grad_compress_pod: bool = False                # int8+EF gradient allreduce on pod axis
    moe_token_motion: bool = False                 # EP dispatch moves tokens, not weights
    moe_arbitration_shards: int = 1                # >1: hierarchical per-shard capacity


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    seed: int = 0


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
