"""Oracles for moe_route (counterpart of ``repro/kernels/moe_route/
ref.py``): the serial-order position of each entry in a sorted expert-id
stream, i.e. the switch counter each token reads in pipeline order, and
the routing plan built on it.  They are the launchers' plain versions,
``moe_route.moe_route_plain`` and ``moe_route.route_plan_plain``."""
from __future__ import annotations

from repro_torch.kernels.moe_route.moe_route import (moe_route_plain,
                                                     route_plan_plain)


def positions_ref(sorted_ids):
    """sorted_ids: [N] int32 ascending.  Returns [N] int32 positions on
    the input's device (never a kernel launch)."""
    return moe_route_plain(sorted_ids)


def route_plan_ref(flat_ids, n_experts, capacity, top_k):
    """flat_ids: [N] int32 in arrival order.  Returns (order, slot, admit,
    tok) on the input's device (never a kernel launch)."""
    return route_plan_plain(flat_ids, n_experts, capacity, top_k)
