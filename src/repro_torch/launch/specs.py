"""Abstract input specs for every (arch, shape) cell (counterpart of
``repro/launch/specs.py``): tensors on ``torch.device("meta")`` in place
of ``ShapeDtypeStruct``s, so nothing is allocated.

Stub frontends per the assignment: [vlm] provides precomputed patch
embeddings, [audio] precomputed frame embeddings — the backbone is what
the dry-run runs."""
from __future__ import annotations

import torch

from repro_torch.common.types import ModelConfig, ShapeConfig
from repro_torch.models import decode as Dm
from repro_torch.models.params import torch_dtype

I32 = torch.int32


def sds(shape, dtype):
    """A meta tensor of ``shape`` and ``dtype`` (a dtype or its name)."""
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype), device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Returns the batch dict of meta tensors."""
    B, L = shape.global_batch, shape.seq_len
    dt = cfg.dtype
    if shape.kind in ("train", "prefill"):
        out = {}
        if cfg.frontend == "audio_stub":
            out["frames"] = sds((B, L, cfg.d_model), dt)
        elif cfg.frontend == "vision_stub":
            Np = cfg.n_frontend_tokens
            out["patches"] = sds((B, Np, cfg.d_model), dt)
            out["tokens"] = sds((B, L - Np), I32)
        else:
            out["tokens"] = sds((B, L), I32)
        if shape.kind == "train":
            out["labels"] = sds((B, L), I32)
        return out
    # decode: one new token against a cache of L entries
    out = {"pos": sds((B,), I32)}
    if cfg.frontend == "audio_stub":
        out["frames"] = sds((B, cfg.d_model), dt)
    else:
        out["tokens"] = sds((B,), I32)
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    if shape.kind != "decode":
        raise ValueError(f"cache specs are for decode shapes, not "
                         f"{shape.kind}")
    return Dm.abstract_cache(cfg, shape.global_batch, shape.seq_len)


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k requires sub-quadratic architectures (SSM/hybrid); the
    pure full-attention archs skip it."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False
    return True
