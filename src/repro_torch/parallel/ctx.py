"""Mesh-axes context (counterpart of ``repro/parallel/ctx.py``).

A sharding constraint needs to know which mesh axis names exist; inside
model code we only know *logical* intentions like "shard batch over
(pod, data)".  The launcher sets this contextvar around the step so models
can emit constraints valid for the active mesh (``models/lm.py::
constrain``)."""
from __future__ import annotations

import contextlib
import contextvars
from typing import Tuple

_AXES: contextvars.ContextVar[Tuple[str, ...]] = contextvars.ContextVar(
    "mesh_axes", default=())


@contextlib.contextmanager
def mesh_axes(names):
    tok = _AXES.set(tuple(names))
    try:
        yield
    finally:
        _AXES.reset(tok)


def current_axes() -> Tuple[str, ...]:
    return _AXES.get()
