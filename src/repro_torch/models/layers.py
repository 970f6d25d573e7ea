"""Core transformer layers (counterpart of ``repro/models/layers.py``):
RMSNorm, RoPE, chunked (online-softmax) causal attention, GQA decode
attention, the gated and the plain (biased) MLP.  Plain functions on
tensors, in the reference's order of casts.  Where the reference asks XLA for a float32 product of
bf16 operands (``preferred_element_type=jnp.float32``), the operands are
cast to float32 first: a bf16 x bf16 product is exact in float32, so the
arithmetic is the same."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x, scale, eps=1e-5):
    """Normalize in float32, cast back to x's dtype, then scale in it."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


# ---------------------------------------------------------------- RoPE ----

def rope_cos_sin(positions, head_dim, theta):
    """positions: int32 [...]. Returns cos/sin of shape [..., head_dim//2]."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: [..., L, H, D]; cos/sin: [..., L, D//2] broadcast over heads.
    Rotates the two halves of the head (not interleaved pairs)."""
    dt = x.dtype
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ---------------------------------------------- chunked causal attention ----

def chunked_causal_attention(q, k, v, q_chunk, kv_chunk, causal_offset=0):
    """Blockwise online-softmax causal attention (flash-style).

    q: [B, Lq, H, D]   k/v: [B, Lk, G, D]  with H = G * rep (GQA).
    causal_offset: position of q[0] minus position of k[0].
    Returns [B, Lq, H, D] float32.  Like the reference, every (q block,
    kv block) pair is computed and masked, none skipped.  The reference's
    ``unroll`` (a loop-free form for its dry-run, equal in value) has no
    counterpart: the port ignores ``cfg.unroll``."""
    B, Lq, H, D = q.shape
    _, Lk, G, _ = k.shape
    rep = H // G
    q_chunk = min(q_chunk, Lq)
    kv_chunk = min(kv_chunk, Lk)
    if Lq % q_chunk or Lk % kv_chunk:
        raise ValueError(f"lengths {Lq}, {Lk} are not multiples of the "
                         f"chunks {q_chunk}, {kv_chunk}")
    nq, nk = Lq // q_chunk, Lk // kv_chunk
    dev = q.device

    qg = q.reshape(B, nq, q_chunk, G, rep, D)
    kg = k.reshape(B, nk, kv_chunk, G, D)
    vg = v.reshape(B, nk, kv_chunk, G, D)
    scale = 1.0 / math.sqrt(D)
    q_pos = (torch.arange(nq, device=dev)[:, None] * q_chunk
             + torch.arange(q_chunk, device=dev)[None, :] + causal_offset)
    k_pos = (torch.arange(nk, device=dev)[:, None] * kv_chunk
             + torch.arange(kv_chunk, device=dev)[None, :])

    outs = []
    for qi in range(nq):
        qb = qg[:, qi].float()                           # [B, qc, G, rep, D]
        m = torch.full((B, G, rep, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, G, rep, q_chunk), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((B, G, rep, q_chunk, D), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kb, vb = kg[:, ki], vg[:, ki]                # [B, kc, G, D]
            s = torch.einsum("bqgrd,bkgd->bgrqk", qb, kb.float()) * scale
            mask = q_pos[qi][:, None] >= k_pos[ki][None, :]  # [qc, kc]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bgrqk,bkgd->bgrqd", p.to(vb.dtype).float(),
                              vb.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))          # [B, qc, G, rep, D]
    return torch.stack(outs, dim=1).reshape(B, Lq, H, D)


def decode_attention(q, k_cache, v_cache, lengths):
    """Single-token attention against a KV cache.

    q: [B, H, D]; k_cache/v_cache: [B, Lmax, G, D]; lengths: [B] int32 —
    number of valid cache entries (the new token's KV must already be
    written at position lengths-1).  Returns [B, H, D] float32.
    """
    B, H, D = q.shape
    _, Lmax, G, _ = k_cache.shape
    rep = H // G
    qg = q.reshape(B, G, rep, D).float()
    s = torch.einsum("bgrd,blgd->bgrl", qg, k_cache.float()) * (
        1.0 / math.sqrt(D))
    valid = (torch.arange(Lmax, device=q.device)[None]
             < lengths[:, None])                         # [B, Lmax]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrl,blgd->bgrd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, D)


# ------------------------------------------------------------------ MLP ----

def _act(x, kind):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default
    if kind == "relu_sq":
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def gated_mlp(x, w_gate, w_up, w_down, act):
    g = _act(x @ w_gate, act)
    u = x @ w_up
    return (g * u.to(g.dtype)).to(x.dtype) @ w_down


def plain_mlp(x, w_up, b_up, w_down, b_down, act):
    """The biased 2-matrix MLP (StarCoder2, MusicGen)."""
    h = _act(x @ w_up + b_up, act)
    return h.to(x.dtype) @ w_down + b_down
