"""Causal LM of the ``moe`` family (counterpart of ``repro/models/lm.py``):
GQA attention + MoE FFN with P4DB switch-engine capacity arbitration.

``build_defs`` is the single source of truth for parameters (shapes,
logical axes, init), as in the reference.  The parameters are the flat
``{name: tensor}`` dict of ``models/params.py`` with the ``layers/*``
tensors stacked over layers; ``LM`` is an ``nn.Module`` over them whose
``Attention`` and ``MoE`` submodules hold one layer's slice of each
stacked tensor (a view, no copy).  The block bodies are plain functions on
tensors under the reference's names.  Training runs ``forward`` and
``loss_fn`` on the flat dict itself, with each stacked tensor split per
layer inside the forward, so autograd reaches the tensors that the
optimizer and the checkpoint hold.  The port runs on one device, so the
reference's sharding constraints (``constrain``) are the identity and are
left out.  The other families (dense, vlm, audio, rwkv, hybrid) and
shared experts are not ported yet: ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.common.types import ModelConfig
from repro_torch.models import params as P
from repro_torch.models.layers import (apply_rope, chunked_causal_attention,
                                       rms_norm, rope_cos_sin)
from repro_torch.models.moe import capacity_for, load_balance_loss, moe_ffn

D = P.ParamDef


def _require_ported(cfg: ModelConfig):
    if cfg.family != "moe":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP Queue 1 "
            "item 9); the port serves the 'moe' family")
    if cfg.moe.n_shared_experts:
        raise NotImplementedError(
            "shared experts are not ported yet (ROADMAP Queue 1 item 9)")


# ------------------------------------------------------------- defs ------

def _attn_defs(pre: str, L: int, cfg: ModelConfig) -> Dict[str, D]:
    dm, H, G = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim()
    lead = (L,) if L else ()
    la = ("layers",) if L else ()
    d = {
        f"{pre}attn_norm": D(lead + (dm,), la + ("embed",), "ones"),
        f"{pre}wq": D(lead + (dm, H * dh), la + ("embed", "heads"), "fan_in"),
        f"{pre}wk": D(lead + (dm, G * dh), la + ("embed", "kv_heads"), "fan_in"),
        f"{pre}wv": D(lead + (dm, G * dh), la + ("embed", "kv_heads"), "fan_in"),
        f"{pre}wo": D(lead + (H * dh, dm), la + ("heads", "embed"), "fan_in"),
    }
    if cfg.qkv_bias:
        d[f"{pre}bq"] = D(lead + (H * dh,), la + ("heads",), "zeros")
        d[f"{pre}bk"] = D(lead + (G * dh,), la + ("kv_heads",), "zeros")
        d[f"{pre}bv"] = D(lead + (G * dh,), la + ("kv_heads",), "zeros")
    return d


def _moe_defs(L: int, cfg: ModelConfig):
    m = cfg.moe
    dm, Fe, E = cfg.d_model, m.d_ff_expert, m.n_experts
    return {
        "layers/router": D((L, dm, E), ("layers", "embed", None), "normal", 0.02,
                           dtype="float32"),
        "layers/e_gate": D((L, E, dm, Fe), ("layers", "experts", "embed", "ff"),
                           "fan_in"),
        "layers/e_up": D((L, E, dm, Fe), ("layers", "experts", "embed", "ff"),
                         "fan_in"),
        "layers/e_down": D((L, E, Fe, dm), ("layers", "experts", "ff", "embed"),
                           "fan_in"),
    }


def build_defs(cfg: ModelConfig) -> Dict[str, D]:
    _require_ported(cfg)
    L, dm, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    defs: Dict[str, D] = {"final_norm": D((dm,), ("embed",), "ones"),
                          "embed": D((V, dm), ("vocab", "embed"), "normal",
                                     0.02)}
    if not cfg.tie_embeddings:
        defs["head"] = D((V, dm), ("vocab", "embed"), "fan_in")
    defs.update(_attn_defs("layers/", L, cfg))
    defs["layers/mlp_norm"] = D((L, dm), ("layers", "embed"), "ones")
    defs.update(_moe_defs(L, cfg))
    return defs


def init_params(cfg: ModelConfig, generator: torch.Generator):
    """Random parameters on ``generator``'s device, in ``cfg.dtype``."""
    return P.init_params(build_defs(cfg), generator, cfg.dtype,
                         generator.device)


# -------------------------------------------------------- embeddings ------

def embed_inputs(cfg: ModelConfig, params, batch):
    """Returns x: [B, L, D] token embeddings."""
    return params["embed"][batch["tokens"]].to(P.torch_dtype(cfg.dtype))


def lm_head(cfg: ModelConfig, params, x):
    """x: [B, L, D] -> float32 logits [B, L, V]."""
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return h.float() @ w.float().T


# ------------------------------------------------------- block bodies ----

def _attn_block(cfg, lp, x, cos, sin):
    B, L, dm = x.shape
    H, G, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = apply_rope(q.reshape(B, L, H, dh), cos, sin)
    k = apply_rope(k.reshape(B, L, G, dh), cos, sin)
    v = v.reshape(B, L, G, dh)
    o = chunked_causal_attention(q, k, v, cfg.q_chunk, cfg.kv_chunk)
    o = o.to(x.dtype).reshape(B, L, H * dh) @ lp["wo"]
    return x + o, (k, v)


def _moe_block(cfg, lp, x, capacity):
    """x: [..., D] (prefill [B, L, D] or decode [B, D])."""
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    eparams = dict(router=lp["router"], w_gate=lp["e_gate"], w_up=lp["e_up"],
                   w_down=lp["e_down"])
    y, plan = moe_ffn(h.reshape(-1, x.shape[-1]), eparams, cfg.moe, F.silu,
                      capacity)
    return x + y.reshape(x.shape), plan


# ------------------------------------------------------------ modules ----

class _Weights(nn.Module):
    """A module whose parameters are the given tensors, frozen and not
    copied."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def weights(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters(recurse=False))


class Attention(_Weights):
    """One layer's attention sublayer (``_attn_block``)."""

    def __init__(self, cfg: ModelConfig, lp):
        super().__init__(lp)
        self.cfg = cfg

    def forward(self, x, cos, sin):
        return _attn_block(self.cfg, self.weights(), x, cos, sin)


class MoE(_Weights):
    """One layer's MoE sublayer (``_moe_block``), for prefill and decode."""

    def __init__(self, cfg: ModelConfig, lp):
        super().__init__(lp)
        self.cfg = cfg

    def forward(self, x, capacity: int):
        return _moe_block(self.cfg, self.weights(), x, capacity)


_ATTN = ("attn_norm", "wq", "wk", "wv", "wo", "bq", "bk", "bv")


class Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, lp):
        super().__init__()
        self.attn = Attention(cfg, {n: t for n, t in lp.items()
                                    if n in _ATTN})
        self.moe = MoE(cfg, {n: t for n, t in lp.items() if n not in _ATTN})


class LM(nn.Module):
    """The LM over a flat parameter dict (``init_params`` or
    ``repro_torch.convert.convert_params``)."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor]):
        super().__init__()
        names = set(build_defs(cfg))
        if set(params) != names:
            raise KeyError(f"parameters differ from build_defs: missing "
                           f"{sorted(names - set(params))}, extra "
                           f"{sorted(set(params) - names)}")
        self.cfg = cfg
        self.top = _Weights({n: t for n, t in params.items()
                             if not n.startswith("layers/")})
        per_layer = {n[len("layers/"):]: t for n, t in params.items()
                     if n.startswith("layers/")}
        self.layers = nn.ModuleList(
            Layer(cfg, {n: t[i] for n, t in per_layer.items()})
            for i in range(cfg.n_layers))

    def forward(self, batch, collect_cache: bool = False):
        """Prefill forward.  Returns (logits, cache_or_None, aux)."""
        return _forward(self.cfg, self.top.weights(),
                        [(layer.attn, layer.moe) for layer in self.layers],
                        batch, collect_cache)


def _forward(cfg: ModelConfig, top, layers, batch, collect_cache=False,
             remat="none"):
    """The forward over ``layers``, one (attn(x, cos, sin), moe(x,
    capacity)) pair per layer: the ``Layer`` modules (serving) or the
    block bodies on one layer's tensors (training)."""
    x = embed_inputs(cfg, top, batch)
    B, L, _ = x.shape
    positions = torch.arange(L, dtype=torch.int32, device=x.device)[None]
    cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim(),
                            cfg.rope_theta)
    capacity = capacity_for(B * L, cfg.moe)

    def body(x, attn, moe):
        x, kv = attn(x, cos, sin)
        x, plan = moe(x, capacity)
        lb = load_balance_loss(plan["probs"], plan["ids"], cfg.moe.n_experts)
        return x, lb, kv

    auxl, ks, vs = 0.0, [], []
    for attn, moe in layers:
        if remat == "full":
            x, lb, (k, v) = checkpoint(body, x, attn, moe, use_reentrant=False)
        else:
            x, lb, (k, v) = body(x, attn, moe)
        auxl = auxl + lb
        if collect_cache:
            ks.append(k)
            vs.append(v)
    cache = (dict(k=torch.stack(ks), v=torch.stack(vs))
             if collect_cache else None)
    return lm_head(cfg, top, x), cache, {"moe_aux": auxl / cfg.n_layers}


def as_model(cfg: ModelConfig, params) -> LM:
    """``params`` as an ``LM``: an ``LM`` of ``cfg`` as it is, or a flat
    parameter dict wrapped (no copy)."""
    if isinstance(params, LM):
        if params.cfg != cfg:
            raise ValueError(f"the LM was built for {params.cfg.name}, "
                             f"not {cfg.name}")
        return params
    return LM(cfg, params)


def _remat(parallel) -> str:
    """The parallel plan's remat mode; raises on what the port does not
    run."""
    if parallel is None:
        return "none"
    if getattr(parallel, "moe_token_motion", False) or getattr(
            parallel, "moe_arbitration_shards", 1) > 1:
        raise NotImplementedError(
            "MoE token motion and sharded arbitration are not ported yet "
            "(ROADMAP Queue 1 item 9, sharding and dry-run)")
    remat = getattr(parallel, "remat", "none")
    if remat not in ("none", "full"):
        raise NotImplementedError(
            f"remat={remat!r} is not ported yet (ROADMAP Queue 1 item 9, "
            "sharding and dry-run); the port runs 'none' and 'full'")
    return remat


def forward(cfg: ModelConfig, params, batch, parallel=None,
            collect_cache=False):
    """Prefill / training forward over ``batch["tokens"]`` [B, L].
    Returns (logits [B, L, V] float32, cache {k, v: [L_layers, B, L, G,
    dh]} or None, aux).

    An ``LM`` runs its modules (serving; ``parallel`` does not apply).  A
    flat parameter dict runs the same block bodies on the dict's tensors,
    split per layer here, so the result is differentiable with respect to
    them; ``parallel.remat == "full"`` recomputes each layer in the
    backward (``torch.utils.checkpoint``), as ``jax.checkpoint`` does."""
    if isinstance(params, LM):
        return as_model(cfg, params)(batch, collect_cache)
    _require_ported(cfg)
    per_layer = {n[len("layers/"):]: t.unbind(0) for n, t in params.items()
                 if n.startswith("layers/")}
    lps = [{n: ts[i] for n, ts in per_layer.items()}
           for i in range(cfg.n_layers)]
    layers = [(functools.partial(_attn_block, cfg, lp),
               functools.partial(_moe_block, cfg, lp)) for lp in lps]
    return _forward(cfg, params, layers, batch, collect_cache,
                    _remat(parallel))


def loss_fn(cfg: ModelConfig, params, batch, parallel=None):
    """Next-token cross-entropy over ``batch["labels"]`` [B, L] (entries
    < 0 masked out), plus the reference's z-loss and MoE load-balance
    term.  Returns (total, {"loss", "zloss", "moe_aux"}), float32."""
    logits, _, aux = forward(cfg, params, batch, parallel)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    lse = torch.logsumexp(logits.float(), dim=-1)
    # the gold logit by a gather (the reference's one-hot masked sum gives
    # the same value); a masked label gathers class 0 and is masked below
    gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    nll = lse - gold.float()
    mask = (labels >= 0).float()
    loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    zloss = 1e-4 * torch.mean(lse * lse)
    total = loss + zloss + 0.01 * aux["moe_aux"]
    return total, {"loss": loss, "zloss": zloss, "moe_aux": aux["moe_aux"]}
