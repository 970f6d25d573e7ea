"""Launcher of the moe_route CUDA kernel, and its plain PyTorch version.

``moe_route_call`` replaces ``repro/kernels/moe_route/moe_route.py::
moe_route_call`` (Pallas ``_kernel``): for an ascending expert-id stream,
each entry's position within its run of equal ids, i.e. the pre-increment
read of its expert's admission counter in stream order.  A CUDA tensor
always goes to the hand-written kernel in ``csrc/moe_route.cu`` (built at
first use by ``kernels/build.py``), a CPU tensor to the plain version.
There is no fallback: a failed build or launch raises.  ``LAUNCHES``
counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (check_int32, library, raise_on,
                                      same_device)

LAUNCHES = {"moe_route": 0}


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
    check_int32("sorted_ids", sorted_ids)
    dev = same_device(sorted_ids)
    if dev.type == "cpu":
        return moe_route_plain(sorted_ids)
    n = sorted_ids.shape[0]
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return pos
    lib = library("moe_route")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.moe_route_launch(sorted_ids.data_ptr(), n, pos.data_ptr(),
                               stream)
    raise_on(err, "moe_route")
    LAUNCHES["moe_route"] += 1
    return pos
