"""RWKV6 (Finch) block (counterpart of ``repro/models/rwkv6.py``):
data-dependent per-channel decay, chunked form.

Per head (key dim c, value dim j), state S in R^{hd x hd}:
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t[j] = sum_c r_t[c] * (S_{t-1}[c,j] + u[c] k_t[c] v_t[j])
The decay w_t is data-dependent (a LoRA on x).  The chunked form builds
the exact [t, i, c] decay tensor per (small) chunk from cumsum
differences.  The reference's ``lax.scan`` over chunks is a Python loop
over chunks here, and its per-token scan (a state is given, or L is no
multiple of the chunk) a loop over tokens.  r, k, v and the decay are
float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm


def token_shift(x, last):
    """x: [B, L, D]; last: [B, D] (previous token, zeros at t=0)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def wkv_chunked(r, k, v, logw, u, chunk):
    """r/k/v: [B, L, H, C] float32; logw: [B, L, H, C] (<0); u: [H, C].

    Returns o: [B, L, H, C] and the final state [B, H, C, C].  The
    intra-chunk mask is strictly lower; it is applied to the exponent
    (-inf, so exp gives the reference's 0) and not after the exp, which
    keeps the backward free of inf * 0 where an unused entry overflows."""
    B, L, H, C = r.shape
    if L % chunk:
        raise ValueError(f"length {L} is not a multiple of the chunk {chunk}")
    nc = L // chunk
    rs, ks, vs, lw = (a.reshape(B, nc, chunk, H, C) for a in (r, k, v, logw))
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=r.device), diagonal=-1)
    S = torch.zeros(B, H, C, C, dtype=r.dtype, device=r.device)
    outs = []
    for c in range(nc):
        rc, kc, vc, lwc = rs[:, c], ks[:, c], vs[:, c], lw[:, c]  # [B,Lc,H,C]
        cum = torch.cumsum(lwc, dim=1)
        # inter-chunk: the decay up to t-1 applied to the carried state
        o_inter = torch.einsum("blhc,bhcj->blhj", rc * torch.exp(cum - lwc),
                               S)
        # intra-chunk, strictly lower: A[t,i] = sum_c r_t exp(cum_{t-1} -
        # cum_i) k_i
        dd = (cum - lwc)[:, :, None] - cum[:, None]          # [B,t,i,H,C]
        e = torch.exp(dd.masked_fill(~tri[None, :, :, None, None],
                                     float("-inf")))
        A = torch.einsum("bthc,btihc,bihc->bthi", rc, e, kc)
        # diagonal bonus term with u
        diag = torch.einsum("blhc,hc,blhc->blh", rc, u, kc)
        o_intra = torch.einsum("bthi,bihj->bthj", A, vc) + diag[..., None] * vc
        # state: S' = diag(prod w) S + sum_i diag(prod_{s>i} w) k_i^T v_i
        tail = torch.exp(cum[:, -1:] - cum)
        S = S * torch.exp(cum[:, -1])[..., None] + torch.einsum(
            "bihc,bihj->bhcj", kc * tail, vc)
        outs.append(o_inter + o_intra)
    return torch.stack(outs, dim=1).reshape(B, L, H, C), S


def _wkv_steps(r, k, v, logw, u, S):
    """The recurrence one token at a time from state S [B, H, C, C]."""
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], logw[:, t]  # [B,H,C]
        outs.append(torch.einsum("bhc,bhcj->bhj", rt, S) + torch.einsum(
            "bhc,hc,bhc,bhj->bhj", rt, u, kt, vt))
        S = S * torch.exp(lwt)[..., None] + kt[..., None] * vt[:, :, None]
    return torch.stack(outs, dim=1), S


def rwkv6_time_mix(x, p, H, chunk, last_x=None, state=None):
    """Time-mix sublayer.  x: [B, L, D]; p: mu_{r,k,v,g,w}, w{r,k,v,g,o},
    w_lora_{a,b}, w0, u, ln_out.  Returns (out, (x's last row, S))."""
    B, L, D = x.shape
    C = D // H
    lx = x.new_zeros(B, D) if last_x is None else last_x
    prev = token_shift(x, lx)

    def mix(mu):
        return x + (prev - x) * mu

    r = mix(p["mu_r"]) @ p["wr"]
    k = mix(p["mu_k"]) @ p["wk"]
    v = mix(p["mu_v"]) @ p["wv"]
    g = mix(p["mu_g"]) @ p["wg"]
    # data-dependent decay (Finch): logw = -exp(w0 + tanh(x A) B) < 0
    lora = torch.tanh(mix(p["mu_w"]) @ p["w_lora_a"]) @ p["w_lora_b"]
    logw = -torch.exp(torch.clamp((p["w0"] + lora).float(), -8.0, 4.0))

    rh, kh, vh = (a.reshape(B, L, H, C).float() for a in (r, k, v))
    lwh = logw.reshape(B, L, H, C)
    u = p["u"].reshape(H, C).float()
    if state is None and L >= chunk and L % chunk == 0:
        o, S = wkv_chunked(rh, kh, vh, lwh, u, chunk)
    else:
        S0 = (torch.zeros(B, H, C, C, dtype=torch.float32, device=x.device)
              if state is None else state)
        o, S = _wkv_steps(rh, kh, vh, lwh, u, S0)

    o = o.reshape(B, L, D)
    o = rms_norm(o, p["ln_out"]) * F.silu(g).to(o.dtype)
    return o.to(x.dtype) @ p["wo"], (x[:, -1, :], S)


def rwkv6_channel_mix(x, p, last_x=None):
    """Channel-mix sublayer (relu^2 FFN with token shift).  Returns (out,
    x's last row)."""
    B, L, D = x.shape
    lx = x.new_zeros(B, D) if last_x is None else last_x
    prev = token_shift(x, lx)
    xk = x + (prev - x) * p["mu_k"]
    xr = x + (prev - x) * p["mu_r"]
    kk = torch.square(F.relu(xk @ p["wk"]))
    vv = kk.to(x.dtype) @ p["wv"]
    rr = torch.sigmoid(xr @ p["wr"])
    return (rr * vv.to(rr.dtype)).to(x.dtype), x[:, -1, :]
