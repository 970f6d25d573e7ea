"""Serving: decode-cache construction and single-token decode (counterpart
of ``repro/models/decode.py``), for every family.

``decode_step`` consumes a cache plus per-row positions and produces the
next-token logits.  It writes the new token's K/V and each layer's new
recurrent state into the cache IN PLACE (the port's stand-in for the
reference's donated cache buffers) and returns the same cache dict.  The
cache layouts are the reference's (``cache_spec``): K/V ``[layers, batch,
max_len, kv_heads, head_dim]`` (``[groups, ...]`` for hybrid), RWKV's
``tm_x``/``cm_x`` ``[layers, batch, d_model]`` and float32 ``S``
``[layers, batch, heads, C, C]``, Mamba2's float32 ``ssm`` and its conv
states ``[groups, attn_every, batch, ...]``.
"""
from __future__ import annotations

import torch

from repro_torch.common.types import ModelConfig
from repro_torch.models.layers import (apply_rope, decode_attention,
                                       rms_norm, rope_cos_sin)
from repro_torch.models.lm import as_model, embed_inputs, lm_head
from repro_torch.models.moe import capacity_for
from repro_torch.models.params import torch_dtype


# ----------------------------------------------------- cache structure ----

def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """Dict of (shape, dtype, logical axes) for the decode cache."""
    dt = torch_dtype(cfg.dtype)
    f32 = torch.float32
    dh = cfg.resolved_head_dim()
    G, L = cfg.n_kv_heads, cfg.n_layers
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads_cache", None)
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        shape = (L, batch, max_len, G, dh)
        return {"k": (shape, dt, kv_axes), "v": (shape, dt, kv_axes)}
    if cfg.family == "rwkv":
        dm, H = cfg.d_model, cfg.n_heads
        C = dm // H
        return {
            "tm_x": ((L, batch, dm), dt, ("layers", "batch", None)),
            "cm_x": ((L, batch, dm), dt, ("layers", "batch", None)),
            "S": ((L, batch, H, C, C), f32,
                  ("layers", "batch", "heads_state", None, None)),
        }
    if cfg.family == "hybrid":
        ssm = cfg.ssm
        di = ssm.expand * cfg.d_model
        H = di // ssm.headdim
        ke = cfg.hybrid.attn_every
        groups = cfg.n_layers // ke
        N, K = ssm.d_state, ssm.d_conv
        kv = (groups, batch, max_len, G, dh)
        return {
            "ssm": ((groups, ke, batch, H, N, ssm.headdim), f32,
                    ("layers", "layers2", "batch", "heads_state", None, None)),
            "conv_x": ((groups, ke, batch, K - 1, di), dt,
                       ("layers", "layers2", "batch", None, "ssm_inner")),
            "conv_bc": ((groups, ke, batch, K - 1, 2 * N), dt,
                        ("layers", "layers2", "batch", None, None)),
            "k": (kv, dt, kv_axes),
            "v": (kv, dt, kv_axes),
        }
    raise ValueError(cfg.family)


def _normalize(spec):
    return {name: (tuple(s), torch_dtype(d), a) for name, (s, d, a) in
            spec.items()}


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    """The cache as tensors on ``torch.device("meta")`` (no storage)."""
    spec = _normalize(cache_spec(cfg, batch, max_len))
    return {n: torch.empty(s, dtype=d, device="meta")
            for n, (s, d, _) in spec.items()}


def zero_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    return {n: torch.zeros(s, dtype=d, device=device)
            for n, (s, d, _) in cache_spec(cfg, batch, max_len).items()}


def cache_logical_axes(cfg: ModelConfig):
    spec = _normalize(cache_spec(cfg, 1, 1))
    return {n: a for n, (s, d, a) in spec.items()}


# -------------------------------------------------------- decode bodies ----

def _write_kv(k_cache, v_cache, k_new, v_new, pos):
    """k_cache: [B, Lmax, G, dh]; k_new: [B, G, dh]; pos: [B].  Writes row
    b's K/V at position pos[b], in place.  A sharded (``DTensor``) cache
    takes a masked write, which keeps its shards where they are."""
    if hasattr(k_cache, "device_mesh"):
        hit = (torch.arange(k_cache.shape[1], device=pos.device)[None]
               == pos[:, None])[:, :, None, None]          # [B, Lmax, 1, 1]
        for c, new in ((k_cache, k_new), (v_cache, v_new)):
            out = torch.where(hit, new[:, None].to(c.dtype), c)
            c.copy_(out.redistribute(c.device_mesh, c.placements))
        return k_cache, v_cache
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

    params: an ``lm.LM`` or the flat parameter dict; batch: ``tokens``
    [B] int32 (``frames`` [B, D] for the audio stub) and ``pos`` [B]
    int32 — index where the new token's KV is written; attends over
    pos+1.  Returns (logits [B, V] float32, cache), the cache updated in
    place.
    """
    model = as_model(cfg, params)
    top = model.top.weights()
    pos = batch["pos"]
    x = embed_inputs(cfg, top, batch)                        # [B, D]
    cos, sin = rope_cos_sin(pos[:, None], cfg.resolved_head_dim(),
                            cfg.rope_theta)                  # [B, 1, dh/2]
    fam = cfg.family

    if fam in ("dense", "vlm", "audio", "moe"):
        capacity = capacity_for(x.shape[0], cfg.moe) if fam == "moe" else 0
        for i, layer in enumerate(model.layers):
            x, _, _ = _attn_decode(cfg, layer.attn.weights(), x,
                                   cache["k"][i], cache["v"][i], pos, cos, sin)
            if fam == "moe":
                x, _ = layer.moe(x, capacity)
            else:
                x = layer.mlp(x)
    elif fam == "rwkv":
        for i, layer in enumerate(model.layers):
            x1, (ltm, S) = layer.tm(x[:, None], cache["tm_x"][i],
                                    cache["S"][i])
            x1, lcm = layer.cm(x1, cache["cm_x"][i])
            x = x1[:, 0]
            for n, t in (("tm_x", ltm), ("cm_x", lcm), ("S", S)):
                cache[n][i] = t
    elif fam == "hybrid":
        ke = cfg.hybrid.attn_every
        for g in range(cfg.n_layers // ke):
            for j in range(ke):
                st = {n: cache[n][g, j] for n in ("ssm", "conv_x", "conv_bc")}
                x1, st = model.layers[g * ke + j].mamba(x[:, None], st, False)
                x = x1[:, 0]
                for n, t in st.items():
                    cache[n][g, j] = t
            x, _, _ = _attn_decode(cfg, model.shared.attn.weights(), x,
                                   cache["k"][g], cache["v"][g], pos, cos, sin)
            x = model.shared.mlp(x)
    else:
        raise ValueError(fam)
    return lm_head(cfg, top, x[:, None, :])[:, 0], cache
