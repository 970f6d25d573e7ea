"""Mamba2 (SSD) block (counterpart of ``repro/models/mamba2.py``): chunked
state-space scan.

Per head h with scalar decay a_t = exp(-dt_t * exp(A_log)):
    h_t = a_t * h_{t-1} + dt_t * B_t (x) x_t          (state: [N, P])
    y_t = C_t . h_t + D * x_t
Chunked form: intra-chunk contributions through an [Lc, Lc] decay-weighted
(C.B) matrix (exponents are cumsum differences), the state carried across
chunks by a Python loop (the reference's ``lax.scan``).  Where the
reference multiplies a bf16 operand by a float32 one, XLA promotes the
bf16 operand to float32; so does this port, explicitly, before each
product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), for every x.
    ``F.softplus`` returns x itself past its threshold (20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def causal_conv1d(x, w, b):
    """Depthwise causal conv.  x: [B, L, C]; w: [C, K]; b: [C]."""
    K, L = w.shape[-1], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pad[:, j:j + L, :] * w[:, j] for j in range(K))
    return out + b


def ssd_chunked(xh, dt, A_log, B_, C_, chunk):
    """xh: [B, L, H, P]; dt: [B, L, H] float32; A_log: [H]; B_/C_: [B, L,
    N].

    Returns y: [B, L, H, P] in xh's dtype and the final state [B, H, N, P]
    float32.  The intra-chunk mask is inclusive (i <= t); it is applied to
    the exponent (-inf) and not after the exp, which gives the same
    values and keeps the backward free of inf * 0."""
    Bsz, L, H, P = xh.shape
    N = B_.shape[-1]
    if L % chunk:
        raise ValueError(f"length {L} is not a multiple of the chunk {chunk}")
    nc = L // chunk
    xs = xh.reshape(Bsz, nc, chunk, H, P)
    dts = dt.reshape(Bsz, nc, chunk, H)
    Bm = B_.reshape(Bsz, nc, chunk, N)
    Cm = C_.reshape(Bsz, nc, chunk, N)
    loga = -dts * torch.exp(A_log.float())                  # [B,nc,Lc,H] <= 0
    cum = torch.cumsum(loga, dim=2)                         # within-chunk
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=xh.device))
    state = torch.zeros(Bsz, H, N, P, dtype=torch.float32, device=xh.device)
    ys = []
    for c in range(nc):
        xc, dtc, bc, cc, lc = xs[:, c], dts[:, c], Bm[:, c], Cm[:, c], cum[:, c]
        xf, bf, cf = xc.float(), bc.float(), cc.float()
        # inter-chunk: y_t += exp(lc_t) * (C_t . S_prev)
        y_inter = torch.einsum("bln,bhnp->blhp", cf, state) * torch.exp(
            lc)[..., None]
        # intra-chunk: M_ti = (C_t.B_i) * exp(lc_t - lc_i) * dt_i, i <= t;
        # C.B is a product of two model-dtype operands, in that dtype
        cb = torch.einsum("btn,bin->bti", cc, bc)           # [B,Lc,Lc]
        dd = lc[:, :, None, :] - lc[:, None, :, :]          # [B,t,i,H]
        m = torch.exp(dd.masked_fill(~tri[None, :, :, None], float("-inf")))
        m = m * cb[..., None] * dtc[:, None, :, :]
        y_intra = torch.einsum("btih,bihp->bthp", m, xf)
        # state: S' = exp(lc_L) S + sum_i exp(lc_L - lc_i) dt_i B_i (x) x_i
        tail = torch.exp(lc[:, -1:, :] - lc)                # [B,Lc,H]
        contrib = torch.einsum("bin,bih,bihp->bhnp", bf, tail * dtc, xf)
        state = state * torch.exp(lc[:, -1])[:, :, None, None] + contrib
        ys.append((y_inter + y_intra).to(xh.dtype))
    return torch.stack(ys, dim=1).reshape(Bsz, L, H, P), state


def mamba2_forward(x, p, cfg, ssm, train=True, state=None):
    """One Mamba2 block.  x: [B, L, D].  Returns (out, new_state): None
    when ``train``, else dict(ssm=[B,H,N,P] float32, conv_x=[B,K-1,di],
    conv_bc=[B,K-1,2N]), the conv states holding the last K-1 PRE-conv
    inputs.  With ``state`` given, x is one token ([B, 1, D]): one
    recurrence step."""
    B, L, D = x.shape
    di = ssm.expand * D
    H = di // ssm.headdim
    P = ssm.headdim

    h = rms_norm(x, p["norm"])                              # default eps
    z = h @ p["wz"]
    xi = h @ p["wx"]
    bc = h @ p["wbc"]                                       # [B,L,2N]
    dt = softplus((h @ p["wdt"] + p["dt_bias"]).float())
    Dp = torch.repeat_interleave(p["D"], P)[None, None, :]

    if state is None:
        xi_pre, bc_pre = xi, bc            # the conv state is PRE-conv
        xi = F.silu(causal_conv1d(xi, p["conv_x_w"], p["conv_x_b"]))
        bc = F.silu(causal_conv1d(bc, p["conv_bc_w"], p["conv_bc_b"]))
        B_, C_ = bc.chunk(2, dim=-1)
        y, new_ssm = ssd_chunked(xi.reshape(B, L, H, P), dt, p["A_log"], B_,
                                 C_, ssm.chunk)
        y = y.reshape(B, L, di) + xi * Dp
        keep = L - (ssm.d_conv - 1)
        new_state = None if train else dict(
            ssm=new_ssm, conv_x=xi_pre[:, keep:, :], conv_bc=bc_pre[:, keep:, :])
    else:
        # single-token decode: roll the conv state, one recurrence step
        cx = torch.cat([state["conv_x"], xi], dim=1)        # [B,K,di]
        cb = torch.cat([state["conv_bc"], bc], dim=1)
        xi1 = F.silu(torch.einsum("bkc,ck->bc", cx, p["conv_x_w"])
                     + p["conv_x_b"])
        bc1 = F.silu(torch.einsum("bkc,ck->bc", cb, p["conv_bc_w"])
                     + p["conv_bc_b"])
        B_, C_ = bc1.chunk(2, dim=-1)                       # [B,N]
        xh = xi1.reshape(B, H, P)
        a = torch.exp(-dt[:, 0] * torch.exp(p["A_log"].float()))   # [B,H]
        s = state["ssm"] * a[:, :, None, None] + torch.einsum(
            "bn,bh,bhp->bhnp", B_.float(), dt[:, 0], xh.float())
        y = torch.einsum("bn,bhnp->bhp", C_.float(), s).to(x.dtype)
        y = y.reshape(B, 1, di) + xi1[:, None, :] * Dp
        new_state = dict(ssm=s, conv_x=cx[:, 1:], conv_bc=cb[:, 1:])

    y = rms_norm(y, p["norm_inner"]) * F.silu(z[:, -y.shape[1]:, :]).to(
        y.dtype)
    return y.to(x.dtype) @ p["wo"], new_state
