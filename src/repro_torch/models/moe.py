"""Mixture-of-Experts layer with P4DB-style capacity arbitration
(counterpart of ``repro/models/moe.py``).

Token->expert admission is the paper's hot-tuple pattern: every token is a
"transaction" incrementing a contended per-expert counter; admission is a
constrained write (admit iff counter < capacity).  The routing plan —
the stable expert sort, the serial-order counter reads and the admission
— comes from ``kernels.moe_route``: on a CUDA tensor one launch of the
hand-written ``moe_plan`` kernel (``moe_route`` after a sort for plans
past its limits), on a CPU tensor the plain version.

Dispatch is sort-based (no dense one-hot [T, E] tensors); the expert
buffer [E, C, d] shards E over the EP axis and C over the data axis.
``moe_ffn_sharded`` arbitrates per shard (one batched plan launch for all
shards), and ``token_motion`` constrains the dispatch buffers to the
expert-parallel layout.

On ``DTensor`` inputs (a sharded step; ``parallel/sharding.py``) the
routing plan, the dispatch scatter and the combine, ops that need the
whole plan, run under ``local_map``: on replicated inputs for global
arbitration (the all-gather XLA's partitioner pays too), on each
device's own shards for per-shard arbitration.  On plain tensors they
run as they are.
"""
from __future__ import annotations

import torch

from repro_torch.common.types import MoEConfig
from repro_torch.kernels.moe_route.ops import route_plan, route_positions

_DATA = ("pod", "data")


def _mesh(x):
    """The ``DeviceMesh`` of a ``DTensor``, None for a plain tensor."""
    return getattr(x, "device_mesh", None)


def _local(fn, mesh, ins, outs):
    """``fn`` itself on plain tensors (``mesh`` None); else ``fn`` under
    ``local_map`` on ``mesh`` with its inputs redistributed to ``ins``
    (one spec per input, ``parallel.sharding`` specs) and its outputs
    (a tuple) placed by ``outs``."""
    if mesh is None:
        return fn
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.parallel.sharding import placements
    return local_map(fn, out_placements=tuple(placements(o, mesh)
                                              for o in outs),
                     in_placements=tuple(placements(i, mesh) for i in ins),
                     redistribute_inputs=True, device_mesh=mesh)


def _data_spec(mesh, rank: int):
    """The spec sharding dim 0 over the mesh's data axes."""
    names = getattr(mesh, "mesh_dim_names", ()) or ()
    keep = tuple(a for a in _DATA if a in names)
    lead = keep if len(keep) > 1 else (keep[0] if keep else None)
    return (lead,) + (None,) * (rank - 1)


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
    """Compute routing plan.  x: [T, d] -> plan dict (all [T*k] or
    scalars); x: [S, T, d] -> S independent plans, each field with a
    leading S (the reference's ``vmap`` of route over shards), from one
    batched plan launch.

    ``torch.topk`` documents no order among equal values where
    ``lax.top_k`` takes the lower index first; float32 router
    probabilities of real (or random) inputs practically never tie, so no
    tie-breaking key is built here."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.topk(probs, moe.top_k, dim=-1)            # [.., T, k]
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    lead = ids.shape[:-2]
    flat_ids = ids.reshape(lead + (-1,)).to(torch.int32)        # [.., T*k]
    # a stable sort by expert keeps arrival (packet) order within an
    # expert; each entry reads its expert's switch counter (pos), is
    # admitted iff pos < capacity (the constrained write), and carries
    # its buffer slot and source token row
    order, slot, admit, tok = route_plan(flat_ids, moe.n_experts, capacity,
                                         moe.top_k)
    return dict(order=order, slot=slot, admit=admit, tok=tok,
                ids=flat_ids.view(ids.shape),
                gate=gate.reshape(lead + (-1,)).gather(-1, order.long()),
                probs=probs)


_PLAN = ("order", "slot", "admit", "tok", "ids", "gate", "probs")


def _experts(xb, params, act_fn, dtype):
    """The gated expert FFN over the buffer [E, C, d]."""
    g = act_fn(torch.bmm(xb, params["w_gate"]))
    u = torch.bmm(xb, params["w_up"])
    return torch.bmm((g * u.to(g.dtype)).to(dtype), params["w_down"])


def moe_ffn_sharded(x, params, moe: MoEConfig, act_fn, capacity: int,
                    n_shards: int):
    """Hierarchical (per-shard) capacity arbitration.

    Each data shard arbitrates its local tokens into its own capacity
    slice — the multi-pipeline switch picture: per-pipeline register
    arrays, no cross-pipeline coordination.  The dispatch scatter then
    stays device-local; only the [E, S*C_l, d] activation buffer is
    resharded at the EP boundary.  Capacity is ~C/S per shard: drops
    become per-shard (slightly different semantics than global
    arbitration).  The S plans are one batched ``moe_plan`` launch; each
    plan's ``order`` and ``tok`` are relative to its shard, and the
    returned plan holds the S plans end to end ([S * T/S * k])."""
    from repro_torch.models.lm import constrain
    T, d = x.shape
    E = moe.n_experts
    S = n_shards
    Ts = T // S
    cap_l = max(8, (-(-capacity // S) // 8) * 8 + 8)
    rows = E * cap_l + 1            # + one spare row for dropped entries
    mesh = _mesh(x)

    def plan_and_dispatch(xs, router_w):
        s_l = xs.shape[0]
        plan = route(xs, router_w, moe, cap_l)
        base = torch.arange(s_l, device=xs.device)[:, None]
        slot = (plan["slot"].long() + base * rows).reshape(-1)
        tok = (plan["tok"].long() + base * Ts).reshape(-1)
        xb = xs.new_zeros(s_l * rows, d)
        xb.index_copy_(0, slot, xs.reshape(-1, d)[tok])
        xb = xb.view(s_l, rows, d)[:, :E * cap_l].reshape(s_l, E, cap_l, d)
        return (xb,) + tuple(plan[k] for k in _PLAN)

    def combine(yb, slot, admit, gate, tok):
        s_l = yb.shape[0]
        base = torch.arange(s_l, device=yb.device)[:, None]
        flat = yb.reshape(s_l * E * cap_l, d)
        w = torch.where(admit, gate, 0.0)
        safe = (slot.long().clamp_max(E * cap_l - 1) + base * E * cap_l)
        contrib = flat[safe.reshape(-1)] * w.reshape(-1)[:, None].to(
            flat.dtype)
        ys = torch.zeros(s_l * Ts, d, dtype=torch.float32, device=yb.device)
        ys.index_add_(0, (tok.long() + base * Ts).reshape(-1),
                      contrib.float())
        return (ys.view(s_l, Ts, d),)

    sh = _data_spec(mesh, 2)
    out = _local(plan_and_dispatch, mesh, [_data_spec(mesh, 3), (None,) * 2],
                 [_data_spec(mesh, 4)] + [sh] * 4 + [_data_spec(mesh, 3),
                                                     sh, _data_spec(mesh, 3)]
                 )(x.reshape(S, Ts, d), params["router"])
    xb, plans = out[0], dict(zip(_PLAN, out[1:]))       # [S, E, C_l, d]
    xb = constrain(xb, _DATA, None, None, None)
    xb2 = xb.transpose(0, 1).reshape(E, S * cap_l, d)
    # E over EP, capacity over data: expert flops split over the data axis
    # as a *batch* dim — no partial-sum all-reduce, weights gathered once
    xb2 = constrain(xb2, "model", _DATA, None)
    yb = _experts(xb2, params, act_fn, x.dtype)
    yb = constrain(yb, "model", _DATA, None)
    yb = yb.reshape(E, S, cap_l, d).transpose(0, 1)
    yb = constrain(yb, _DATA, None, None, None)
    ys, = _local(combine, mesh, [_data_spec(mesh, 4)] + [sh] * 4,
                 [_data_spec(mesh, 3)])(
        yb, plans["slot"], plans["admit"], plans["gate"], plans["tok"])
    y = ys.reshape(T, d).to(x.dtype)
    flat_plans = {k: a.reshape((-1,) + tuple(a.shape[2:]))
                  for k, a in plans.items()}
    return y, flat_plans


def moe_ffn(x, params, moe: MoEConfig, act_fn, capacity: int,
            token_motion: bool = False):
    """x: [T, d] -> ([T, d], plan).  params: router [d, E], w_gate/w_up
    [E, d, f], w_down [E, f, d].

    token_motion=True constrains the dispatch buffers to the expert-
    parallel layout (E over the EP axis, capacity over data), so a
    sharded step moves token activations between devices instead of
    gathering expert weights."""
    from repro_torch.models.lm import constrain
    T, d = x.shape
    E, C = moe.n_experts, capacity
    mesh = _mesh(x)
    rep = lambda r: (None,) * r

    def plan_and_dispatch(x, router_w):
        plan = route(x, router_w, moe, capacity)
        # dispatch: admitted rows go to their (unique) slots; every
        # dropped entry carries slot E*C and lands on one spare row past
        # the buffer, which is cut off -- the reference's out-of-bounds
        # ``mode="drop"``
        xb = x.new_zeros(E * C + 1, d)
        xb.index_copy_(0, plan["slot"].long(), x[plan["tok"].long()])
        return (xb[:E * C].view(E, C, d),) + tuple(plan[k] for k in _PLAN)

    def combine(yb, slot, admit, gate, tok):
        # gather each admitted row back, weight, scatter-add per token in
        # float32.  index_add_ may sum a token's k rows in another order
        # than XLA's scatter-add: equal to rounding, not bit for bit.
        w = torch.where(admit, gate, 0.0)
        contrib = yb[slot.long().clamp_max(E * C - 1)] * w[:, None].to(
            yb.dtype)
        y = torch.zeros(T, d, dtype=torch.float32, device=yb.device)
        y.index_add_(0, tok.long(), contrib.float())
        return (y,)

    out = _local(plan_and_dispatch, mesh, [rep(2), rep(2)],
                 [rep(3), rep(1), rep(1), rep(1), rep(1), rep(2), rep(1),
                  rep(2)])(x, params["router"])
    xb, plan = out[0], dict(zip(_PLAN, out[1:]))
    if token_motion:
        xb = constrain(xb, "model", _DATA, None)
    yb = _experts(xb, params, act_fn, x.dtype)
    if token_motion:
        yb = constrain(yb, "model", _DATA, None)
    y, = _local(combine, mesh, [rep(2)] + [rep(1)] * 4, [rep(2)])(
        yb.reshape(E * C, d), plan["slot"], plan["admit"], plan["gate"],
        plan["tok"])
    return y.to(x.dtype), plan


def load_balance_loss(probs, ids, n_experts):
    """Switch-transformer auxiliary loss (mean prob * mean assignment)."""
    def lb(probs, ids):
        flat = ids.reshape(-1).long()
        assign = torch.zeros(n_experts, dtype=torch.float32,
                             device=probs.device)
        assign.index_add_(0, flat, torch.ones(flat.shape[0],
                                              dtype=torch.float32,
                                              device=probs.device))
        frac_tokens = assign / assign.sum().clamp_min(1.0)
        frac_probs = probs.mean(dim=0)
        return (n_experts * torch.sum(frac_tokens * frac_probs),)

    return _local(lb, _mesh(probs), [(None,) * 2] * 2, [()])(probs, ids)[0]
