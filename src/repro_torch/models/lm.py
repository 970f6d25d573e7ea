"""Unified causal LM (counterpart of ``repro/models/lm.py``) covering every
family of the registry:

  dense   — GQA attention + (gated|plain) MLP
  moe     — GQA attention + MoE FFN (P4DB switch-engine capacity
            arbitration), with optional shared experts (Kimi-K2)
  rwkv    — RWKV6 time-mix / channel-mix (attention-free)
  hybrid  — Zamba2: Mamba2 blocks + one weight-shared attention + MLP
            block after every ``attn_every`` of them
  vlm     — dense backbone, patch-embedding prefix from a stub frontend
  audio   — dense backbone over precomputed frame embeddings (stub
            frontend)

``build_defs`` is the single source of truth for parameters (shapes,
logical axes, init), as in the reference.  The parameters are the flat
``{name: tensor}`` dict of ``models/params.py`` with the ``layers/*``
tensors stacked over layers; ``LM`` is an ``nn.Module`` over them whose
per-layer ``Block`` submodules (``attn``, ``mlp``, ``moe``, ``tm``,
``cm``, ``mamba``) hold one layer's slice of each stacked tensor (a view,
no copy), and whose ``shared`` blocks hold the hybrid family's
``shared/*`` tensors, used by every group.  The block bodies are plain
functions on tensors under the reference's names.  Training runs
``forward`` and ``loss_fn`` on the flat dict itself, with each stacked
tensor split per layer inside the forward, so autograd reaches the
tensors that the optimizer and the checkpoint hold.

Sharding: ``constrain`` is the reference's sharding constraint.  It is the
identity unless a launcher has set mesh axes (``parallel.ctx.mesh_axes``)
and the tensor is a ``DTensor``; then it redistributes the tensor to the
resolved placements.  A sharded step runs on ``DTensor`` parameters (the
dry-run, ``launch/dryrun.py``) under ``implicit_replication`` (the plain
tensors it makes, such as RoPE tables, count as replicated).  The
reference's dry-run ``unroll`` changes no value and is ignored: eager
torch runs every loop as it is written.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from repro_torch.common.types import ModelConfig
from repro_torch.models import params as P
from repro_torch.models.layers import (apply_rope, chunked_causal_attention,
                                       gated_mlp, plain_mlp, rms_norm,
                                       rope_cos_sin)
from repro_torch.models.mamba2 import mamba2_forward
from repro_torch.models.moe import (capacity_for, load_balance_loss, moe_ffn,
                                    moe_ffn_sharded)
from repro_torch.models.rwkv6 import rwkv6_channel_mix, rwkv6_time_mix
from repro_torch.parallel.ctx import current_axes

D = P.ParamDef
_DATA = ("pod", "data")


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


def _mlp_defs(pre: str, L: int, cfg: ModelConfig):
    dm, F_ = cfg.d_model, cfg.d_ff
    lead = (L,) if L else ()
    la = ("layers",) if L else ()
    d = {f"{pre}mlp_norm": D(lead + (dm,), la + ("embed",), "ones")}
    if cfg.mlp_gated:
        d[f"{pre}w_gate"] = D(lead + (dm, F_), la + ("embed", "ff"), "fan_in")
        d[f"{pre}w_up"] = D(lead + (dm, F_), la + ("embed", "ff"), "fan_in")
        d[f"{pre}w_down"] = D(lead + (F_, dm), la + ("ff", "embed"), "fan_in")
    else:
        d[f"{pre}w_up"] = D(lead + (dm, F_), la + ("embed", "ff"), "fan_in")
        d[f"{pre}b_up"] = D(lead + (F_,), la + ("ff",), "zeros")
        d[f"{pre}w_down"] = D(lead + (F_, dm), la + ("ff", "embed"), "fan_in")
        d[f"{pre}b_down"] = D(lead + (dm,), la + ("embed",), "zeros")
    return d


def _mamba_defs(pre: str, L: int, cfg: ModelConfig):
    ssm = cfg.ssm
    dm = cfg.d_model
    di = ssm.expand * dm
    H = di // ssm.headdim
    N, K = ssm.d_state, ssm.d_conv
    return {
        f"{pre}norm": D((L, dm), ("layers", "embed"), "ones"),
        f"{pre}wz": D((L, dm, di), ("layers", "embed", "ssm_inner"), "fan_in"),
        f"{pre}wx": D((L, dm, di), ("layers", "embed", "ssm_inner"), "fan_in"),
        f"{pre}wbc": D((L, dm, 2 * N), ("layers", "embed", None), "fan_in"),
        f"{pre}wdt": D((L, dm, H), ("layers", "embed", "ssm_inner"), "fan_in"),
        f"{pre}dt_bias": D((L, H), ("layers", "ssm_inner"), "zeros"),
        f"{pre}A_log": D((L, H), ("layers", "ssm_inner"), "normal", 0.5),
        f"{pre}D": D((L, H), ("layers", "ssm_inner"), "ones"),
        f"{pre}conv_x_w": D((L, di, K), ("layers", "ssm_inner", None), "normal",
                            0.2),
        f"{pre}conv_x_b": D((L, di), ("layers", "ssm_inner"), "zeros"),
        f"{pre}conv_bc_w": D((L, 2 * N, K), ("layers", None, None), "normal",
                             0.2),
        f"{pre}conv_bc_b": D((L, 2 * N), ("layers", None), "zeros"),
        f"{pre}norm_inner": D((L, di), ("layers", "ssm_inner"), "ones"),
        f"{pre}wo": D((L, di, dm), ("layers", "ssm_inner", "embed"), "fan_in"),
    }


def _rwkv_defs(L: int, cfg: ModelConfig):
    dm, F_ = cfg.d_model, cfg.d_ff
    R = cfg.rwkv.decay_lora
    mus = {f"layers/tm/mu_{n}": D((L, dm), ("layers", "embed"), "normal", 0.1)
           for n in ("r", "k", "v", "g", "w")}
    return {
        "layers/tm_norm": D((L, dm), ("layers", "embed"), "ones"),
        **mus,
        "layers/tm/wr": D((L, dm, dm), ("layers", "embed", "heads"), "fan_in"),
        "layers/tm/wk": D((L, dm, dm), ("layers", "embed", "heads"), "fan_in"),
        "layers/tm/wv": D((L, dm, dm), ("layers", "embed", "heads"), "fan_in"),
        "layers/tm/wg": D((L, dm, dm), ("layers", "embed", "heads"), "fan_in"),
        "layers/tm/w_lora_a": D((L, dm, R), ("layers", "embed", None), "fan_in"),
        "layers/tm/w_lora_b": D((L, R, dm), ("layers", None, "heads"), "fan_in"),
        "layers/tm/w0": D((L, dm), ("layers", "heads"), "normal", 0.3),
        "layers/tm/u": D((L, dm), ("layers", "heads"), "normal", 0.3),
        "layers/tm/ln_out": D((L, dm), ("layers", "heads"), "ones"),
        "layers/tm/wo": D((L, dm, dm), ("layers", "heads", "embed"), "fan_in"),
        "layers/cm_norm": D((L, dm), ("layers", "embed"), "ones"),
        "layers/cm/mu_k": D((L, dm), ("layers", "embed"), "normal", 0.1),
        "layers/cm/mu_r": D((L, dm), ("layers", "embed"), "normal", 0.1),
        "layers/cm/wk": D((L, dm, F_), ("layers", "embed", "ff"), "fan_in"),
        "layers/cm/wv": D((L, F_, dm), ("layers", "ff", "embed"), "fan_in"),
        "layers/cm/wr": D((L, dm, dm), ("layers", "embed", "heads"), "fan_in"),
    }


def _moe_defs(L: int, cfg: ModelConfig):
    m = cfg.moe
    dm, Fe, E = cfg.d_model, m.d_ff_expert, m.n_experts
    d = {
        "layers/router": D((L, dm, E), ("layers", "embed", None), "normal", 0.02,
                           dtype="float32"),
        "layers/e_gate": D((L, E, dm, Fe), ("layers", "experts", "embed", "ff"),
                           "fan_in"),
        "layers/e_up": D((L, E, dm, Fe), ("layers", "experts", "embed", "ff"),
                         "fan_in"),
        "layers/e_down": D((L, E, Fe, dm), ("layers", "experts", "ff", "embed"),
                           "fan_in"),
    }
    if m.n_shared_experts:
        Fs = Fe * m.n_shared_experts
        d["layers/se_gate"] = D((L, dm, Fs), ("layers", "embed", "ff"), "fan_in")
        d["layers/se_up"] = D((L, dm, Fs), ("layers", "embed", "ff"), "fan_in")
        d["layers/se_down"] = D((L, Fs, dm), ("layers", "ff", "embed"), "fan_in")
    return d


def build_defs(cfg: ModelConfig) -> Dict[str, D]:
    L, dm, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    defs: Dict[str, D] = {"final_norm": D((dm,), ("embed",), "ones")}
    if cfg.frontend != "audio_stub":
        defs["embed"] = D((V, dm), ("vocab", "embed"), "normal", 0.02)
    if not cfg.tie_embeddings:
        defs["head"] = D((V, dm), ("vocab", "embed"), "fan_in")
    if cfg.family in ("dense", "vlm", "audio"):
        defs.update(_attn_defs("layers/", L, cfg))
        defs.update(_mlp_defs("layers/", L, cfg))
    elif cfg.family == "moe":
        defs.update(_attn_defs("layers/", L, cfg))
        defs["layers/mlp_norm"] = D((L, dm), ("layers", "embed"), "ones")
        defs.update(_moe_defs(L, cfg))
    elif cfg.family == "rwkv":
        defs.update(_rwkv_defs(L, cfg))
    elif cfg.family == "hybrid":
        defs.update(_mamba_defs("layers/", L, cfg))
        defs.update(_attn_defs("shared/", 0, cfg))
        defs.update(_mlp_defs("shared/", 0, cfg))
    else:
        raise ValueError(cfg.family)
    return defs


def init_params(cfg: ModelConfig, generator: torch.Generator):
    """Random parameters on ``generator``'s device, in ``cfg.dtype``."""
    return P.init_params(build_defs(cfg), generator, cfg.dtype,
                         generator.device)


def abstract_params(cfg: ModelConfig):
    """The parameters as tensors on ``torch.device("meta")`` (no
    storage): the flat dict of ``init_params``' names, shapes and dtypes."""
    return P.abstract_params(build_defs(cfg), cfg.dtype)


# -------------------------------------------------------- embeddings ------

def embed_inputs(cfg: ModelConfig, params, batch):
    """Returns x: [B, L, D]: token embeddings, the vision stub's patches
    before them, or the audio stub's frames."""
    dt = P.torch_dtype(cfg.dtype)
    dev = params["final_norm"].device

    def inp(name):                  # arrays or tensors, on the params' device
        return torch.as_tensor(batch[name], device=dev)

    if cfg.frontend == "audio_stub":
        return inp("frames").to(dt)
    tok = params["embed"][inp("tokens")].to(dt)
    if cfg.frontend == "vision_stub" and "patches" in batch:
        return torch.cat([inp("patches").to(dt), tok], dim=1)
    return tok


def constrain(x, *dims):
    """Best-effort sharding constraint using whatever mesh axes exist.

    dims: per-array-dim tuples of candidate mesh axis names (or None).
    Axis names come from the launcher's parallel.ctx context; outside a
    launcher (every one-device path) this is a no-op, and so it is on a
    plain tensor.  A ``DTensor`` is redistributed to the placements of
    the filtered spec on its own mesh."""
    names = set(current_axes())
    if not names or not hasattr(x, "device_mesh"):
        return x
    from repro_torch.parallel.sharding import placements
    parts = []
    for d in dims:
        cand = d if isinstance(d, tuple) else (d,)
        keep = tuple(a for a in cand if a is not None and a in names)
        parts.append(keep if len(keep) > 1 else (keep[0] if keep else None))
    want = placements(tuple(parts), x.device_mesh)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(x.device_mesh, want)


def lm_head(cfg: ModelConfig, params, x):
    """x: [B, L, D] -> float32 logits [B, L, V]."""
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    # keep logits vocab-sharded: without this the full [tokens, V] fp32
    # tensor may be gathered per device
    return constrain(h.float() @ w.float().T, _DATA, None, "model")


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


def _mlp_block(cfg, lp, x):
    """x: [..., D]; the gated MLP where ``w_gate`` exists, else the plain
    biased one."""
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if "w_gate" in lp:
        o = gated_mlp(h, lp["w_gate"], lp["w_up"], lp["w_down"], cfg.act)
    else:
        o = plain_mlp(h, lp["w_up"], lp["b_up"], lp["w_down"], lp["b_down"],
                      cfg.act)
    return x + o.to(x.dtype)


def _moe_block(cfg, lp, x, capacity, token_motion=False, arb_shards=1):
    """x: [..., D] (prefill [B, L, D] or decode [B, D]).  Returns (x +
    the routed experts [+ the shared experts], the routing plan):
    per-shard arbitration over ``arb_shards`` shards when > 1."""
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    eparams = dict(router=lp["router"], w_gate=lp["e_gate"], w_up=lp["e_up"],
                   w_down=lp["e_down"])
    flat = h.reshape(-1, x.shape[-1])
    if arb_shards > 1:
        y, plan = moe_ffn_sharded(flat, eparams, cfg.moe, F.silu, capacity,
                                  arb_shards)
    else:
        y, plan = moe_ffn(flat, eparams, cfg.moe, F.silu, capacity,
                          token_motion)
    out = x + y.reshape(x.shape)
    if cfg.moe.n_shared_experts:
        s = gated_mlp(h, lp["se_gate"], lp["se_up"], lp["se_down"], "silu")
        out = out + s.to(x.dtype)
    return out, plan


def _tm_block(cfg, lp, x, last_x=None, state=None):
    """RWKV time-mix with its norm.  Returns (x + out, (the normed input's
    last row, S))."""
    h = rms_norm(x, lp["tm_norm"], cfg.norm_eps)
    o, st = rwkv6_time_mix(h, lp, cfg.n_heads, cfg.rwkv.chunk, last_x, state)
    return x + o, st


def _cm_block(cfg, lp, x, last_x=None):
    """RWKV channel-mix with its norm.  Returns (x + out, the normed
    input's last row)."""
    h = rms_norm(x, lp["cm_norm"], cfg.norm_eps)
    o, last = rwkv6_channel_mix(h, lp, last_x)
    return x + o, last


def _mamba_block(cfg, lp, x, state=None, train=True):
    o, st = mamba2_forward(x, lp, cfg, cfg.ssm, train, state)
    return x + o, st


_ATTN = ("attn_norm", "wq", "wk", "wv", "wo", "bq", "bk", "bv")


def _split(tensors, names):
    """(the tensors named in ``names``, the others)."""
    return ({n: t for n, t in tensors.items() if n in names},
            {n: t for n, t in tensors.items() if n not in names})


def _sublayers(cfg: ModelConfig, lp):
    """One layer's tensors (names after ``layers/``) by sublayer, in the
    order the layer runs them: {sublayer: (body, tensors)}.  RWKV's
    ``tm/*`` and ``cm/*`` names lose their prefix."""
    if cfg.family == "rwkv":
        return {s: (body, {n.split("/")[-1]: t for n, t in lp.items()
                           if n.startswith(s)})
                for s, body in (("tm", _tm_block), ("cm", _cm_block))}
    if cfg.family == "hybrid":
        return {"mamba": (_mamba_block, dict(lp))}
    attn, rest = _split(lp, _ATTN)
    if cfg.family == "moe":
        return {"attn": (_attn_block, attn), "moe": (_moe_block, rest)}
    if cfg.family in ("dense", "vlm", "audio"):
        return {"attn": (_attn_block, attn), "mlp": (_mlp_block, rest)}
    raise ValueError(cfg.family)


def _shared_sublayers(sp):
    """The hybrid family's shared block (names after ``shared/``)."""
    attn, mlp = _split(sp, _ATTN)
    return {"attn": (_attn_block, attn), "mlp": (_mlp_block, mlp)}


def _strip(params, pre):
    return {n[len(pre):]: t for n, t in params.items() if n.startswith(pre)}


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


class Block(_Weights):
    """One sublayer over one layer's tensors: ``body(cfg, weights, x,
    *args)`` (``_attn_block``, ``_mlp_block``, ``_moe_block``, ...)."""

    def __init__(self, cfg: ModelConfig, body, tensors):
        super().__init__(tensors)
        self.cfg, self.body = cfg, body

    def forward(self, x, *args):
        return self.body(self.cfg, self.weights(), x, *args)

    def extra_repr(self) -> str:
        return self.body.__name__


def _modules(cfg, subs):
    return nn.ModuleDict({s: Block(cfg, body, w)
                          for s, (body, w) in subs.items()})


def _bound(cfg, subs):
    return {s: functools.partial(body, cfg, w)
            for s, (body, w) in subs.items()}


class LM(nn.Module):
    """The LM over a flat parameter dict (``init_params`` or
    ``repro_torch.convert.convert_params``): ``layers[i]`` holds layer
    i's ``Block`` per sublayer, ``shared`` the hybrid family's shared
    block (None for the others)."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, torch.Tensor]):
        super().__init__()
        names = set(build_defs(cfg))
        if set(params) != names:
            raise KeyError(f"parameters differ from build_defs: missing "
                           f"{sorted(names - set(params))}, extra "
                           f"{sorted(set(params) - names)}")
        self.cfg = cfg
        self.top = _Weights({n: t for n, t in params.items()
                             if "/" not in n})
        per_layer = _strip(params, "layers/")
        self.layers = nn.ModuleList(
            _modules(cfg, _sublayers(cfg, {n: t[i] for n, t in
                                           per_layer.items()}))
            for i in range(cfg.n_layers))
        self.shared = (_modules(cfg, _shared_sublayers(
            _strip(params, "shared/"))) if cfg.family == "hybrid" else None)

    def forward(self, batch, collect_cache: bool = False):
        """Prefill forward.  Returns (logits, cache_or_None, aux)."""
        return _forward(self.cfg, self.top.weights(), list(self.layers),
                        self.shared, batch, collect_cache)


def _dots_saveable(ctx, op, *args, **kwargs):
    """remat="dots": the counterpart of JAX's
    ``dots_with_no_batch_dims_saveable``.  The outputs of ``aten.mm`` and
    ``aten.addmm`` (the projections, the router and the head: products
    with no batch dim once flattened) are saved; everything else is
    recomputed in the backward, ``aten.bmm`` too (attention scores and
    the expert products ``ecd,edf->ecf``, which carry a batch dim in JAX
    as well)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _forward(cfg: ModelConfig, top, layers, shared, batch,
             collect_cache=False, remat="none", seq_ax=None,
             token_motion=False, arb_shards=1):
    """The forward over ``layers`` (one {sublayer: callable} per layer:
    the ``LM``'s ``Block`` modules when serving, the block bodies bound
    to one layer's tensors when training) and the hybrid family's
    ``shared`` block.  ``remat`` "full" checkpoints each layer, and for
    hybrid each group, as the reference's ``maybe_remat`` does; "dots"
    does so keeping the products of ``_dots_saveable``.  Each layer (each
    group) starts by constraining the residual stream to (batch over the
    data axes, sequence over ``seq_ax``); MoE layers arbitrate over
    ``arb_shards`` shards, with ``token_motion``'s buffer layout."""
    x = embed_inputs(cfg, top, batch)
    B, L, _ = x.shape
    positions = torch.arange(L, dtype=torch.int32, device=x.device)[None]
    cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim(),
                            cfg.rope_theta)
    fam = cfg.family

    def run(f, *args):
        if remat == "full":
            return checkpoint(f, *args, use_reentrant=False)
        if remat == "dots":
            return checkpoint(f, *args, use_reentrant=False,
                              context_fn=functools.partial(
                                  create_selective_checkpoint_contexts,
                                  _dots_saveable))
        return f(*args)

    if fam == "hybrid":
        ke = cfg.hybrid.attn_every

        def body(x, *mambas):       # one group: ke Mamba2 blocks + shared
            x = constrain(x, _DATA, seq_ax, None)
            sts = []
            for m in mambas:
                x, st = m(x, None, not collect_cache)
                sts.append(st)
            x, kv = shared["attn"](x, cos, sin)
            return shared["mlp"](x), (sts, kv), None

        steps = [[layers[g * ke + j]["mamba"] for j in range(ke)]
                 for g in range(cfg.n_layers // ke)]
    else:
        capacity = capacity_for(B * L, cfg.moe) if fam == "moe" else 0

        def body(x, blk):           # one layer
            x = constrain(x, _DATA, seq_ax, None)
            if fam == "rwkv":
                x, (ltm, S) = blk["tm"](x)
                x, lcm = blk["cm"](x)
                return x, (ltm, lcm, S), None
            x, kv = blk["attn"](x, cos, sin)
            if fam != "moe":
                return blk["mlp"](x), kv, None
            x, plan = blk["moe"](x, capacity, token_motion, arb_shards)
            return x, kv, load_balance_loss(plan["probs"], plan["ids"],
                                            cfg.moe.n_experts)

        steps = [[blk] for blk in layers]

    auxl = torch.zeros((), dtype=torch.float32, device=x.device)
    states = []
    for step in steps:
        x, st, lb = run(body, x, *step)
        if lb is not None:
            auxl = auxl + lb
        if collect_cache:
            states.append(st)
    aux = {"moe_aux": auxl / cfg.n_layers if fam == "moe" else auxl}
    return lm_head(cfg, top, x), (_cache(cfg, states) if collect_cache
                                  else None), aux


def _cache(cfg: ModelConfig, states):
    """The prefill cache from each step's states, in ``cache_spec``'s
    layout."""
    stack = torch.stack
    if cfg.family == "rwkv":
        return {n: stack([s[j] for s in states])
                for j, n in enumerate(("tm_x", "cm_x", "S"))}
    if cfg.family == "hybrid":
        cache = {n: stack([stack([st[n] for st in sts]) for sts, _ in states])
                 for n in ("ssm", "conv_x", "conv_bc")}
        cache["k"] = stack([kv[0] for _, kv in states])
        cache["v"] = stack([kv[1] for _, kv in states])
        return cache
    return {"k": stack([k for k, _ in states]),
            "v": stack([v for _, v in states])}


def as_model(cfg: ModelConfig, params) -> LM:
    """``params`` as an ``LM``: an ``LM`` of ``cfg`` as it is, or a flat
    parameter dict wrapped (no copy)."""
    if isinstance(params, LM):
        if params.cfg != cfg:
            raise ValueError(f"the LM was built for {params.cfg.name}, "
                             f"not {cfg.name}")
        return params
    return LM(cfg, params)


def _options(parallel):
    """(remat, seq_axis, moe_token_motion, moe_arbitration_shards) of a
    parallel plan (None: the defaults of a plain forward)."""
    if parallel is None:
        return "none", None, False, 1
    remat = getattr(parallel, "remat", "none")
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat={remat!r}: expected none, full or dots")
    return (remat, getattr(parallel, "seq_axis", None),
            getattr(parallel, "moe_token_motion", False),
            getattr(parallel, "moe_arbitration_shards", 1))


def forward(cfg: ModelConfig, params, batch, parallel=None,
            collect_cache=False):
    """Prefill / training forward over ``batch`` (``tokens`` [B, L], with
    ``patches`` [B, Np, D] before them for the vision stub, or ``frames``
    [B, L, D] for the audio stub).  Returns (logits [B, L, V] float32, the
    cache of ``decode.cache_spec`` at max_len L or None, aux).

    An ``LM`` runs its modules (serving; ``parallel`` does not apply).  A
    flat parameter dict runs the same block bodies on the dict's tensors,
    split per layer here, so the result is differentiable with respect to
    them, under ``parallel``'s options: ``remat`` "full" recomputes each
    layer (each group for hybrid) in the backward and "dots" all of it
    but the ``aten.mm``/``addmm`` products (``torch.utils.checkpoint``,
    as ``jax.checkpoint`` and its policy do); ``seq_axis`` shards the
    residual stream's sequence; ``moe_token_motion`` and
    ``moe_arbitration_shards`` as in ``models/moe.py``."""
    if isinstance(params, LM):
        return as_model(cfg, params)(batch, collect_cache)
    remat, seq_ax, motion, shards = _options(parallel)
    per_layer = {n: t.unbind(0) for n, t in _strip(params,
                                                   "layers/").items()}
    layers = [_bound(cfg, _sublayers(cfg, {n: ts[i] for n, ts in
                                           per_layer.items()}))
              for i in range(cfg.n_layers)]
    shared = (_bound(cfg, _shared_sublayers(_strip(params, "shared/")))
              if cfg.family == "hybrid" else None)
    return _forward(cfg, params, layers, shared, batch, collect_cache, remat,
                    seq_ax, motion, shards)


def loss_fn(cfg: ModelConfig, params, batch, parallel=None):
    """Next-token cross-entropy over ``batch["labels"]`` [B, L] (entries
    < 0 masked out), plus the reference's z-loss and MoE load-balance
    term (0 for the other families).  Returns (total, {"loss", "zloss",
    "moe_aux"}), float32."""
    logits, _, aux = forward(cfg, params, batch, parallel)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    lse = torch.logsumexp(logits.float(), dim=-1)
    if hasattr(logits, "device_mesh"):
        # sharded logits: the reference's vocab-sharding-friendly masked
        # reduce (a gather over a sharded vocab dim would gather it)
        V = logits.shape[-1]
        onehot = labels[..., None] == torch.arange(V, device=labels.device)
        gold = torch.where(onehot, logits, 0.0).sum(dim=-1)
    else:
        # the gold logit by a gather (the masked sum gives the same value);
        # a masked label gathers class 0 and is masked below
        gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    nll = lse - gold.float()
    mask = (labels >= 0).float()
    loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    zloss = 1e-4 * torch.mean(lse * lse)
    total = loss + zloss + 0.01 * aux["moe_aux"]
    return total, {"loss": loss, "zloss": zloss, "moe_aux": aux["moe_aux"]}
