"""Step functions (counterpart of ``repro/launch/steps.py``): train_step
(with gradient accumulation), prefill_step and serve_step (single-token
decode)."""
from __future__ import annotations

import torch

from repro_torch.common.types import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.models import lm
from repro_torch.models.decode import decode_step
from repro_torch.optim import adamw


def grads_of(cfg: ModelConfig, parallel, params, batch):
    """(total loss, {name: gradient}) of ``lm.loss_fn`` at ``params``, a
    flat dict; the gradients have their parameters' dtypes.  The
    parameters themselves are not marked: autograd runs on detached
    aliases of them."""
    leaves = {n: t.detach().requires_grad_() for n, t in params.items()}
    total, _ = lm.loss_fn(cfg, leaves, batch, parallel)
    grads = torch.autograd.grad(total, list(leaves.values()))
    return total.detach(), dict(zip(leaves, grads))


def _replicated(v):
    """A sharded (``DTensor``) batch entry gathered whole, once a step, so
    that each microbatch's rows are a local slice (the first layer's
    constraint shards them again); anything else as it is."""
    if not hasattr(v, "device_mesh"):
        return v
    from torch.distributed.tensor import Replicate
    return v.redistribute(v.device_mesh, [Replicate()] * v.device_mesh.ndim)


def make_train_step(cfg: ModelConfig, parallel: ParallelConfig,
                    tc: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics).  ``params`` is the flat parameter dict and is updated IN
    PLACE (the port's stand-in for the reference's donated buffers), so an
    ``lm.LM`` built over it stays current; the returned dict is the same
    object.  ``batch`` holds arrays or tensors; they are moved to the
    parameters' device.

    Gradient accumulation: the batch's leading dim is split into
    parallel.microbatch chunks run in turn; grads are accumulated in fp32
    (bf16 for the ``moe`` family's giants to halve the buffer), then
    divided by the count, as in the reference."""
    mb = max(parallel.microbatch, 1)
    accum_dtype = torch.bfloat16 if cfg.family == "moe" else torch.float32

    def train_step(params, opt_state, batch):
        dev = next(iter(params.values())).device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if mb > 1:
            batch = {k: _replicated(v) for k, v in batch.items()}
        if mb == 1:
            loss, grads = grads_of(cfg, parallel, params, batch)
        else:
            grads = {n: torch.zeros(p.shape, dtype=accum_dtype, device=dev)
                     for n, p in params.items()}
            loss = 0.0
            for i in range(mb):
                part = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                        for k, v in batch.items()}
                l, g = grads_of(cfg, parallel, params, part)
                for n, gn in g.items():
                    grads[n] = grads[n] + gn.to(accum_dtype)
                loss = loss + l
            grads = {n: g / mb for n, g in grads.items()}
            loss = loss / mb
        params, opt_state, om = adamw.apply_updates(
            params, grads, opt_state, tc, parallel.moment_dtype)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, parallel=None):
    def prefill_step(params, batch):
        logits, cache, _ = lm.forward(cfg, params, batch, parallel,
                                      collect_cache=True)
        return logits[:, -1], cache
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, batch):
        return decode_step(cfg, params, cache, batch)
    return serve_step
