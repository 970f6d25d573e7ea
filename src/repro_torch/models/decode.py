"""Serving: KV-cache construction and single-token decode (counterpart of
``repro/models/decode.py``, ``moe`` family).

``decode_step`` consumes a cache plus per-row positions and produces the
next-token logits.  It writes the new token's K/V into the cache IN PLACE
(the port's stand-in for the reference's donated cache buffers) and
returns the same cache dict.  The cache layout is the reference's:
``[layers, batch, max_len, kv_heads, head_dim]``.
"""
from __future__ import annotations

import torch

from repro_torch.common.types import ModelConfig
from repro_torch.models.layers import (apply_rope, decode_attention,
                                       rms_norm, rope_cos_sin)
from repro_torch.models.lm import (_require_ported, as_model, embed_inputs,
                                   lm_head)
from repro_torch.models.moe import capacity_for
from repro_torch.models.params import torch_dtype


# ----------------------------------------------------- cache structure ----

def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """Dict of (shape, dtype, logical axes) for the decode cache."""
    _require_ported(cfg)
    dt = torch_dtype(cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim())
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads_cache", None)
    return {"k": (shape, dt, kv_axes), "v": (shape, dt, kv_axes)}


def zero_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    return {n: torch.zeros(s, dtype=d, device=device)
            for n, (s, d, _) in cache_spec(cfg, batch, max_len).items()}


# -------------------------------------------------------- decode bodies ----

def _write_kv(k_cache, v_cache, k_new, v_new, pos):
    """k_cache: [B, Lmax, G, dh]; k_new: [B, G, dh]; pos: [B].  Writes row
    b's K/V at position pos[b], in place."""
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[rows, pos] = k_new
    v_cache[rows, pos] = v_new
    return k_cache, v_cache


def _attn_decode(cfg, lp, x, k_cache, v_cache, pos, cos, sin):
    """x: [B, D] single token.  Returns (x, k_cache, v_cache)."""
    B, dm = x.shape
    H, G, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = apply_rope(q.reshape(B, 1, H, dh), cos, sin)[:, 0]
    k = apply_rope(k.reshape(B, 1, G, dh), cos, sin)[:, 0]
    v = v.reshape(B, G, dh)
    k_cache, v_cache = _write_kv(k_cache, v_cache, k, v, pos)
    o = decode_attention(q, k_cache, v_cache, pos + 1)
    o = o.to(x.dtype).reshape(B, H * dh) @ lp["wo"]
    return x + o, k_cache, v_cache


def decode_step(cfg: ModelConfig, params, cache, batch):
    """One decode step.

    params: an ``lm.LM`` or the flat parameter dict; batch: tokens [B]
    int32, pos [B] int32 — index where the new token's KV is written;
    attends over pos+1.  Returns (logits [B, V] float32, cache), the cache
    updated in place.
    """
    model = as_model(cfg, params)
    top = model.top.weights()
    pos = batch["pos"]
    x = embed_inputs(cfg, top, batch)
    cos, sin = rope_cos_sin(pos[:, None], cfg.resolved_head_dim(),
                            cfg.rope_theta)                  # [B, 1, dh/2]
    capacity = capacity_for(x.shape[0], cfg.moe)
    for i, layer in enumerate(model.layers):
        x, _, _ = _attn_decode(cfg, layer.attn.weights(), x, cache["k"][i],
                               cache["v"][i], pos, cos, sin)
        x, _ = layer.moe(x, capacity)
    return lm_head(cfg, top, x[:, None, :])[:, 0], cache
