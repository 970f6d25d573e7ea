"""Production mesh builders (counterpart of ``repro/launch/mesh.py``).

FUNCTIONS, not module-level constants: importing this module touches no
distributed state.  Both build a ``torch.distributed`` ``DeviceMesh`` over
the process group that exists (``init_process_group`` first; the dry-run
uses a ``fake`` group of 256 or 512 ranks) and raise when there is none.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group before building a mesh")
    return dist.get_world_size()


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model"); the process group must hold exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = shape[0] * shape[1] * (shape[2] if len(shape) > 2 else 1)
    if _world() != n:
        raise RuntimeError(f"the production mesh {shape} needs {n} ranks, "
                           f"the process group has {_world()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A small ("data", "model") mesh over the group's first ranks
    (tests/examples), clamped to the world size as the reference clamps
    to its device count."""
    n = _world()
    data = min(data, n)
    model = max(min(model, n // data), 1)
    if data * model != n:
        raise RuntimeError(f"a ({data}, {model}) mesh does not cover the "
                           f"{n} ranks of the process group")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
