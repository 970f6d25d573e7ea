"""Oracle for moe_route (counterpart of ``repro/kernels/moe_route/
ref.py``): the serial-order position of each entry in a sorted expert-id
stream, i.e. the switch counter each token reads in pipeline order.  It is
the launcher's plain version, ``moe_route.moe_route_plain``."""
from __future__ import annotations

from repro_torch.kernels.moe_route.moe_route import moe_route_plain


def positions_ref(sorted_ids):
    """sorted_ids: [N] int32 ascending.  Returns [N] int32 positions on
    the input's device (never a kernel launch)."""
    return moe_route_plain(sorted_ids)
