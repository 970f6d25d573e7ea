"""Fault-tolerant checkpointing (counterpart of ``repro/ckpt/checkpoint.py``),
with the reference's on-disk protocol, so that each package restores the
other's files.

Layout on disk:
  <dir>/step_<N>/manifest.json     tree structure, shapes, dtypes
  <dir>/step_<N>/<leaf-path>.npy   one file per flattened leaf (bfloat16
                                   stored as a uint16 view)
  <dir>/step_<N>/.complete         atomic completion marker

  * atomic visibility — a checkpoint is written under ``step_<N>.tmp``
    and renamed once its ``.complete`` marker exists; restore ignores a
    directory without one (a crashed writer can never corrupt restart);
  * async save — the device -> host snapshot is taken synchronously, the
    file writes run on a background thread so training continues;
  * GC — keep the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models import params as Pm


def _leaf_files(flat):
    return {name: name.replace("/", "__") + ".npy" for name in flat}


def _host(v):
    """(numpy copy, logical dtype name) of a tensor, array or number; a
    bfloat16 tensor becomes its uint16 bits."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.array(v)
    return a, str(a.dtype)


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save --
    def save(self, step: int, tree: Any, blocking: bool = False,
             extra: Optional[dict] = None):
        """Snapshot ``tree`` (nested dicts of tensors, arrays or numbers;
        "a/b" keys name nested leaves) to host memory now; write the
        files in the background."""
        self.wait()
        if not isinstance(tree, dict):
            raise TypeError(f"a checkpoint tree is a dict, got "
                            f"{type(tree).__name__}")
        host, dtypes = {}, {}
        for n, v in Pm.flatten(tree).items():
            host[n], dtypes[n] = _host(v)
        meta = dict(step=step, time=time.time(), extra=extra or {},
                    leaves={n: dict(shape=list(v.shape), dtype=dtypes[n])
                            for n, v in host.items()},
                    files=_leaf_files(host))

        def write():
            path = os.path.join(self.dir, f"step_{step:08d}")
            tmp = path + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            for n, v in host.items():
                np.save(os.path.join(tmp, meta["files"][n]), v)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            open(os.path.join(tmp, ".complete"), "w").close()
            shutil.rmtree(path, ignore_errors=True)
            os.replace(tmp, path)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore --
    def list_steps(self):
        out = []
        for d in sorted(os.listdir(self.dir)):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, d, ".complete")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device=None):
        """Returns (step, tree): nested dicts of tensors on ``device``
        (``None`` -> cuda, which must exist), or (None, None) when there
        is no complete checkpoint."""
        device = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        flat = {n: _tensor(np.load(os.path.join(path, fn)),
                           meta["leaves"][n]["dtype"]).to(device)
                for n, fn in meta["files"].items()}
        return step, Pm.unflatten(flat)
