"""Launchers of the moe_route CUDA kernels, and their plain PyTorch
versions.

``moe_route_call`` replaces ``repro/kernels/moe_route/moe_route.py::
moe_route_call`` (Pallas ``_kernel``): for an ascending expert-id stream,
each entry's position within its run of equal ids, i.e. the pre-increment
read of its expert's admission counter in stream order.  ``route_plan_call``
computes the whole routing plan of ``repro/models/moe.py::route`` around
that function — the stable expert sort, the positions and the admission
— in one launch of the ``moe_plan`` kernel for up to ``PLAN_MAX_N`` ids
over up to ``PLAN_MAX_E`` experts; larger plans sort with
``torch.argsort`` and launch ``moe_route``.  A batch of S plans (ids
``[S, n]``, the reference's ``vmap`` of ``route`` over S arbitration
shards) is one launch of the same kernel with one block per plan.  A CUDA tensor always goes to
a hand-written kernel in ``csrc/moe_route.cu`` (built at first use by
``kernels/build.py``) on the card that holds it, a CPU tensor to the
plain versions.  There is no
fallback: a failed build or launch raises.  ``LAUNCHES`` counts kernel
launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (check_int32, library, raise_on,
                                      raw_stream, same_device)

# the largest plan one moe_plan launch takes (kPlanMaxN and kPlanMaxE in
# csrc/moe_route.cu): Qwen3-MoE prefill's 2,048 tokens x top-8 ids, and
# experts up to the 16 KB of offsets in shared memory
PLAN_MAX_N = 16384
PLAN_MAX_E = 4096

LAUNCHES = {"moe_route": 0, "moe_plan": 0}

_I32 = torch.int32
_ROUTE = _PLAN = _PLANS = _STREAM = None   # resolved at the first launch


def _resolve():
    global _ROUTE, _PLAN, _PLANS, _STREAM
    lib = library("moe_route")
    _ROUTE, _PLAN = lib.moe_route_launch, lib.moe_plan_launch
    _PLANS = lib.moe_plan_streams_launch
    _STREAM = raw_stream()


def moe_route_plain(sorted_ids):
    """Plain PyTorch version: ``arange(N) - searchsorted(ids, ids,
    side="left")``."""
    first = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    return (torch.arange(sorted_ids.shape[0], device=sorted_ids.device)
            - first).to(torch.int32)


def moe_route_call(sorted_ids):
    """sorted_ids: [N] int32, ascending (an unsorted stream gives
    unspecified positions).  Returns [N] int32 positions within each run
    of equal ids, in stream order."""
    try:
        fast = (sorted_ids.is_cuda and sorted_ids.dtype is _I32
                and sorted_ids.ndim == 1 and sorted_ids.is_contiguous())
    except AttributeError:
        fast = False
    if not fast:                        # the CPU, or an error to raise
        check_int32("sorted_ids", sorted_ids)
        same_device(sorted_ids)
        return moe_route_plain(sorted_ids)
    n = sorted_ids.shape[0]
    pos = torch.empty_like(sorted_ids)
    if n:
        if _ROUTE is None:
            _resolve()
        d = sorted_ids.get_device()
        err = _ROUTE(d, sorted_ids.data_ptr(), n, pos.data_ptr(), _STREAM(d))
        if err:
            raise_on(err, "moe_route")
        LAUNCHES["moe_route"] += 1
    return pos


def _plan_from_sort(flat_ids, n_experts, capacity, top_k, positions):
    """The routing plan as ``repro/models/moe.py::route`` computes it: a
    stable argsort, the positions of the sorted stream (``positions``),
    then admission, slot and source token."""
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    pos = positions(sorted_ids)
    admit = pos < capacity
    slot = torch.where(admit, sorted_ids * capacity + pos,
                       n_experts * capacity)
    return (order.to(torch.int32), slot, admit,
            (order // top_k).to(torch.int32))


def _per_stream(flat_ids, plan):
    """``plan`` of each row of ``flat_ids`` [S, n] in turn, stacked:
    (order, slot, admit, tok), each [S, n]."""
    rows = [plan(r) for r in flat_ids.unbind(0)]
    return tuple(torch.stack(f) for f in zip(*rows))


def route_plan_plain(flat_ids, n_experts, capacity, top_k):
    """Plain PyTorch version of the routing plan (``moe_route_plain`` for
    the positions); of each stream in turn for ids [S, n]."""
    if flat_ids.ndim == 2:
        return _per_stream(flat_ids, lambda r: route_plan_plain(
            r, n_experts, capacity, top_k))
    return _plan_from_sort(flat_ids, n_experts, capacity, top_k,
                           moe_route_plain)


def _plan_outputs(flat_ids, shape):
    """(order, slot, tok, admit) for a plan of ``shape`` ([n] or [S, n]):
    the rows of one [3, *shape] int32 allocation and a bool one.  (One
    allocation split four ways, admit viewed as the bytes of its tail,
    took more host time on the H100 machine: the views cost more than the
    allocation they save.)"""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    order, slot, tok = flat_ids.new_empty((3,) + shape)
    return order, slot, tok, torch.empty(shape, dtype=torch.bool,
                                         device=flat_ids.device)


def route_plan_call(flat_ids, n_experts: int, capacity: int, top_k: int):
    """flat_ids: [N] int32 expert ids in arrival order (token-major, top_k
    per token), or [S, N] for S independent plans.  Returns (order int32,
    slot int32, admit bool, tok int32), each of flat_ids' shape, each
    plan in its stable expert-sorted order: the arrival position, the
    expert-buffer slot ``id * capacity + pos`` or ``n_experts * capacity``
    when dropped, ``pos < capacity``, and ``order // top_k`` (positions
    relative to the plan's own row).

    On the card, N <= ``PLAN_MAX_N`` and n_experts <= ``PLAN_MAX_E`` is
    one launch of ``moe_plan`` for the whole batch, one block per plan
    (ids outside [0, n_experts) give an unspecified plan, never an access
    out of bounds); a larger plan takes ``torch.argsort`` and
    ``moe_route_call``, plan by plan, chosen by size alone.  A CPU tensor
    takes the plain versions."""
    try:
        fast = (flat_ids.is_cuda and flat_ids.dtype is _I32
                and flat_ids.ndim in (1, 2) and flat_ids.is_contiguous())
    except AttributeError:
        fast = False
    E, C, k = int(n_experts), int(capacity), int(top_k)
    if E < 1 or C < 0 or k < 1 or E * C >= 2 ** 31:
        raise ValueError(f"bad plan sizes: n_experts={E}, capacity={C}, "
                         f"top_k={k}")
    if not fast:                        # the CPU, or an error to raise
        batched = isinstance(flat_ids, torch.Tensor) and flat_ids.ndim == 2
        check_int32("flat_ids", flat_ids.view(-1) if batched and
                    flat_ids.is_contiguous() else flat_ids)
        if batched and flat_ids.shape[0] > 65535:
            raise ValueError(f"{flat_ids.shape[0]} plans: at most 65,535 "
                             "in one batch")
        same_device(flat_ids)
    n = flat_ids.shape[-1]
    if n > PLAN_MAX_N or E > PLAN_MAX_E:
        if flat_ids.ndim == 2:
            return _per_stream(flat_ids, lambda r: _plan_from_sort(
                r, E, C, k, moe_route_call))
        return _plan_from_sort(flat_ids, E, C, k, moe_route_call)
    if not fast:
        return route_plan_plain(flat_ids, E, C, k)
    order, slot, tok, admit = _plan_outputs(flat_ids, flat_ids.shape)
    if flat_ids.numel():
        if _PLAN is None:
            _resolve()
        d = flat_ids.get_device()
        ptrs = (order.data_ptr(), slot.data_ptr(), admit.data_ptr(),
                tok.data_ptr(), _STREAM(d))
        if flat_ids.ndim == 1:
            err = _PLAN(d, flat_ids.data_ptr(), n, E, C, k, *ptrs)
        else:
            err = _PLANS(d, flat_ids.data_ptr(), flat_ids.shape[0], n, E, C,
                         k, *ptrs)
        if err:
            raise_on(err, "moe_plan")
        LAUNCHES["moe_plan"] += 1
    return order, slot, admit, tok
