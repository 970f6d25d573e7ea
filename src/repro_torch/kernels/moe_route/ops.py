"""Wrappers over the moe_route kernels (counterpart of
``repro/kernels/moe_route/ops.py``).  The reference pads the stream to a
multiple of its Pallas block with an INT32_MAX sentinel; that constraint
belongs to the TPU's sequential grid, and the CUDA kernels take any N, so
there is no ``block`` argument and no padding here."""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_route.moe_route import (moe_route_call,
                                                     route_plan_call)


def route_positions(sorted_ids):
    """sorted_ids: [N] int32 ascending.  Returns [N] int32 positions."""
    return moe_route_call(sorted_ids.to(torch.int32).contiguous())


def route_plan(flat_ids, n_experts: int, capacity: int, top_k: int):
    """flat_ids: [N] expert ids in arrival order (any integer dtype), or
    [S, N] for S independent plans.  Returns (order, slot, admit, tok),
    each of flat_ids' shape, in stable expert-sorted order per plan
    (``moe_route.route_plan_call``)."""
    return route_plan_call(flat_ids.to(torch.int32).contiguous(), n_experts,
                           capacity, top_k)
