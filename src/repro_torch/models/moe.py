"""Mixture-of-Experts layer with P4DB-style capacity arbitration
(counterpart of ``repro/models/moe.py``).

Token->expert admission is the paper's hot-tuple pattern: every token is a
"transaction" incrementing a contended per-expert counter; admission is a
constrained write (admit iff counter < capacity).  The routing plan —
the stable expert sort, the serial-order counter reads and the admission
— comes from ``kernels.moe_route``: on a CUDA tensor one launch of the
hand-written ``moe_plan`` kernel (``moe_route`` after a sort for plans
past its limits), on a CPU tensor the plain version.

Dispatch is sort-based (no dense one-hot [T, E] tensors).  The port runs
on one device, so the reference's sharded arbitration
(``moe_ffn_sharded``) and its layout constraints are not carried over.
"""
from __future__ import annotations

import torch

from repro_torch.common.types import MoEConfig
from repro_torch.kernels.moe_route.ops import route_plan, route_positions


def capacity_for(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(cfg.top_k * n_tokens * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def arbitrate_positions(sorted_ids):
    """Serial-order position of each entry within its (sorted) expert group.

    Equivalent to replaying the P4DB switch: transactions arrive in sorted
    packet order, each reads-and-increments its expert's register.  The
    returned value is the pre-increment counter read.
    """
    return route_positions(sorted_ids)


def route(x, router_w, moe: MoEConfig, capacity: int):
    """Compute routing plan.  x: [T, d] -> plan dict (all [T*k] or scalars).

    ``torch.topk`` documents no order among equal values where
    ``lax.top_k`` takes the lower index first; float32 router
    probabilities of real (or random) inputs practically never tie, so no
    tie-breaking key is built here."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.topk(probs, moe.top_k, dim=-1)            # [T, k]
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    flat_ids = ids.reshape(-1).to(torch.int32)                   # [T*k]
    # a stable sort by expert keeps arrival (packet) order within an
    # expert; each entry reads its expert's switch counter (pos), is
    # admitted iff pos < capacity (the constrained write), and carries
    # its buffer slot and source token row
    order, slot, admit, tok = route_plan(flat_ids, moe.n_experts, capacity,
                                         moe.top_k)
    return dict(order=order, slot=slot, admit=admit, tok=tok,
                ids=flat_ids.view(ids.shape),
                gate=gate.reshape(-1).index_select(0, order), probs=probs)


def moe_ffn(x, params, moe: MoEConfig, act_fn, capacity: int):
    """x: [T, d] -> ([T, d], plan).  params: router [d, E], w_gate/w_up
    [E, d, f], w_down [E, f, d]."""
    T, d = x.shape
    plan = route(x, params["router"], moe, capacity)
    E, C = moe.n_experts, capacity
    slot, tok = plan["slot"].long(), plan["tok"].long()

    # dispatch: admitted rows go to their (unique) slots; every dropped
    # entry carries slot E*C and lands on one spare row past the buffer,
    # which is cut off -- the reference's out-of-bounds ``mode="drop"``
    xb = x.new_zeros(E * C + 1, d)
    xb.index_copy_(0, slot, x[tok])
    xb = xb[:E * C].view(E, C, d)

    g = act_fn(torch.bmm(xb, params["w_gate"]))
    u = torch.bmm(xb, params["w_up"])
    yb = torch.bmm((g * u.to(g.dtype)).to(x.dtype), params["w_down"])
    yb = yb.reshape(E * C, d)

    # combine: gather each admitted row back, weight, scatter-add per
    # token in float32.  index_add_ may sum a token's k rows in another
    # order than XLA's scatter-add: equal to rounding, not bit for bit.
    w = torch.where(plan["admit"], plan["gate"], 0.0)
    contrib = yb[slot.clamp_max(E * C - 1)] * w[:, None].to(yb.dtype)
    y = torch.zeros(T, d, dtype=torch.float32, device=x.device)
    y.index_add_(0, tok, contrib.float())
    return y.to(x.dtype), plan


def load_balance_loss(probs, ids, n_experts):
    """Switch-transformer auxiliary loss (mean prob * mean assignment)."""
    flat = ids.reshape(-1).long()
    assign = torch.zeros(n_experts, dtype=torch.float32, device=probs.device)
    assign.index_add_(0, flat, torch.ones(flat.shape[0], dtype=torch.float32,
                                          device=probs.device))
    frac_tokens = assign / assign.sum().clamp_min(1.0)
    frac_probs = probs.mean(dim=0)
    return n_experts * torch.sum(frac_tokens * frac_probs)
