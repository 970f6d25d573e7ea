"""AdamW with configurable moment storage (counterpart of
``repro/optim/adamw.py``).

moment_dtype:
  float32  — standard
  bfloat16 — half-size moments
  int8     — block-quantized moments (per last-dim row scale, fp32 scales),
             symmetric linear quantization.

Moments are two flat dicts (payload + scale) under the parameters' names.
The arithmetic is the reference's, in its order: a float32 global grad
norm and clip, bias corrections as float32 powers of the float32 step, no
weight decay on leaves with ``ndim <= 1``.

The update is applied IN PLACE to the parameter and moment tensors, under
``no_grad``, and in slices of whole last-dim rows of at most
``SLICE_ELEMS`` elements: at full width one float32 temporary of the
stacked expert weights alone would take 6.4 GB, and the update makes
about seven.  The update is elementwise and the int8 scale is per row, so
the slices give the same bits as one pass over the leaf.  A ``DTensor``
leaf (the dry-run's sharded state) is updated whole, with no view: each
device holds only its shard, and a view of sharded dims into rows would
make DTensor gather them.

``abstract_state`` gives the state as meta tensors (the dry-run path) and
``state_shardings`` its specs: moments like their params, int8 scales
like their params but the collapsed last dim, other scales replicated.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.common.types import TrainConfig
from repro_torch.optim.compress import quantize_int8 as _q

# elements per slice of the update (whole last-dim rows): the float32
# temporaries of one slice take about 0.5 GB
SLICE_ELEMS = 1 << 24
# elements per chunk of the grad norm's float32 sum of squares; fixed
# apart from SLICE_ELEMS, so that the norm (and the clip) has the same
# bits however the update is sliced
_NORM_ELEMS = 1 << 24


class AdamWState(NamedTuple):
    step: torch.Tensor                  # int32 scalar
    m: Dict[str, torch.Tensor]          # payloads, like the params
    m_scale: Dict[str, torch.Tensor]    # fp32 scales (size-1 unless int8)
    v: Dict[str, torch.Tensor]
    v_scale: Dict[str, torch.Tensor]


def _scale_shape(shape):
    return (tuple(shape[:-1]) + (1,)) if len(shape) else (1,)


def _payload_dtype(moment_dtype):
    return {"int8": torch.int8, "bfloat16": torch.bfloat16,
            "float32": torch.float32}[moment_dtype]


def init_state(params, moment_dtype="float32") -> AdamWState:
    """Zero moments for the flat parameter dict, on its device."""
    pd = _payload_dtype(moment_dtype)
    dev = next(iter(params.values())).device

    def payload():
        return {n: torch.zeros(p.shape, dtype=pd, device=dev)
                for n, p in params.items()}

    def scale():
        return {n: torch.zeros(_scale_shape(p.shape) if moment_dtype ==
                               "int8" else (1,), dtype=torch.float32,
                               device=dev) for n, p in params.items()}

    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      payload(), scale(), payload(), scale())


def abstract_state(params, moment_dtype="float32") -> AdamWState:
    """The state of ``init_state`` as tensors on ``torch.device("meta")``
    for a dict of parameters (or their meta stand-ins)."""
    pd = _payload_dtype(moment_dtype)

    def meta(shape, dt):
        return torch.empty(tuple(shape), dtype=dt, device="meta")

    def payload():
        return {n: meta(p.shape, pd) for n, p in params.items()}

    def scale():
        return {n: meta(_scale_shape(p.shape) if moment_dtype == "int8"
                        else (1,), torch.float32) for n, p in params.items()}

    return AdamWState(meta((), torch.int32), payload(), scale(), payload(),
                      scale())


def state_shardings(param_sh, mesh=None, moment_dtype="float32"
                    ) -> AdamWState:
    """Specs of the state for the parameter specs ``param_sh`` ({name:
    spec}, ``parallel.sharding.param_shardings``): moments like their
    params; int8 scales like their params but the (collapsed) last dim;
    the step and other scales replicated (the empty spec).  ``mesh`` is
    the reference's argument: a spec does not depend on it."""
    if moment_dtype == "int8":
        def scale_spec(spec):
            spec = list(spec[:max(len(spec), 1)]) or [None]
            spec[-1] = None
            return tuple(spec)
        scales = {n: scale_spec(s) for n, s in param_sh.items()}
    else:
        scales = {n: () for n in param_sh}
    return AdamWState((), dict(param_sh), scales, dict(param_sh), scales)


def lr_at(tc: TrainConfig, step):
    warm = torch.clamp_max(step.float() / max(tc.warmup_steps, 1), 1.0)
    return tc.lr * warm


def _width(t) -> int:
    return t.shape[-1] if t.ndim else 1


def _rows(t):
    """``t`` as [rows, last dim] (a view: the update writes through it)."""
    return t.view(-1, _width(t))


def _row_slices(t, elems):
    """Slices of ``t``'s rows, at most ``elems`` elements each (one row
    at least)."""
    width = max(_width(t), 1)
    n_rows = t.numel() // width
    step = max(elems // width, 1)
    return [slice(a, min(a + step, n_rows)) for a in range(0, n_rows, step)]


def _sq_norm(grads) -> torch.Tensor:
    """Sum of squares of every gradient in float32, one slice at a time
    (no float32 copy of a whole gradient), in name order."""
    dev = next(iter(grads.values())).device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for g in (grads[n] for n in sorted(grads)):
        if isinstance(g, DTensor):        # reduced over its shards
            total += torch.sum(torch.square(g.float())).full_tensor()
            continue
        g2 = g.reshape(-1, _width(g))
        for sl in _row_slices(g, _NORM_ELEMS):
            total += torch.sum(torch.square(g2[sl].float()))
    return total


def _adam(p, g, m, ms, v, vs, clip, lr, decay, bc1, bc2, tc, int8):
    """One AdamW step of one leaf (or a slice of its rows) in float32, in
    the reference's order: (new parameter, new m, new v)."""
    def read(val, sc):
        return val.float() * sc if int8 else val.float()

    b1, b2 = tc.beta1, tc.beta2
    g = g.float() * clip
    m_f = b1 * read(m, ms)
    m_f += (1 - b1) * g
    v_f = b2 * read(v, vs)
    v_f += (1 - b2) * g * g
    delta = torch.sqrt(v_f / bc2)
    delta += tc.eps
    delta = (m_f / bc1).div_(delta)
    new_p = p.float() * decay
    new_p -= lr * delta
    return new_p, m_f, v_f


def _put(dst, src):
    """Copy ``src`` into the DTensor ``dst`` in ``dst``'s placements."""
    if src.placements != dst.placements:
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState, tc: TrainConfig,
                  moment_dtype="float32"):
    """One AdamW step over the flat dicts.  Updates ``params`` and the
    moments in place and returns (params, new state, {"grad_norm",
    "lr"}); the new state shares the moment dicts and holds a new step."""
    step = state.step + 1
    t = step.float()
    lr = lr_at(tc, step)
    int8 = moment_dtype == "int8"
    pd = _payload_dtype(moment_dtype)
    f32 = dict(dtype=torch.float32, device=t.device)
    bc1 = 1 - torch.tensor(tc.beta1, **f32) ** t
    bc2 = 1 - torch.tensor(tc.beta2, **f32) ** t

    gnorm = torch.sqrt(_sq_norm(grads))
    clip = torch.clamp_max(tc.grad_clip / torch.clamp_min(gnorm, 1e-12), 1.0)

    for n, p in params.items():
        wd = 0.0 if p.ndim <= 1 else tc.weight_decay
        decay = 1 - lr * wd
        m, v, ms, vs = (state.m[n], state.v[n], state.m_scale[n],
                        state.v_scale[n])
        if isinstance(p, DTensor):
            new_p, m_f, v_f = _adam(p, grads[n], m, ms, v, vs, clip, lr,
                                    decay, bc1, bc2, tc, int8)
            _put(p, new_p.to(p.dtype))
            if int8:
                for val, sc, x in ((m, ms, m_f), (v, vs, v_f)):
                    q, s = _q(x)
                    _put(val, q)
                    _put(sc, s)
            else:
                _put(m, m_f.to(pd))
                _put(v, v_f.to(pd))
            continue
        p2, m2, v2 = _rows(p), _rows(m), _rows(v)
        g2 = grads[n].reshape(p2.shape)
        ms2, vs2 = ms.view(-1, 1), vs.view(-1, 1)
        for sl in _row_slices(p, SLICE_ELEMS):
            new_p, m_f, v_f = _adam(p2[sl], g2[sl], m2[sl],
                                    ms2[sl] if int8 else ms2, v2[sl],
                                    vs2[sl] if int8 else vs2, clip, lr,
                                    decay, bc1, bc2, tc, int8)
            p2[sl] = new_p.to(p.dtype)
            if int8:
                for val, sc, x in ((m2, ms2, m_f), (v2, vs2, v_f)):
                    q, s = _q(x)
                    val[sl] = q
                    sc[sl] = s
            else:
                m2[sl] = m_f.to(pd)
                v2[sl] = v_f.to(pd)
    new_state = AdamWState(step, state.m, state.m_scale, state.v,
                           state.v_scale)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
