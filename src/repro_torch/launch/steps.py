"""Step functions (counterpart of ``repro/launch/steps.py``): prefill_step
and serve_step (single-token decode).  ``make_train_step`` is not ported
yet (ROADMAP Queue 1 item 9)."""
from __future__ import annotations

from repro_torch.common.types import ModelConfig
from repro_torch.models import lm
from repro_torch.models.decode import decode_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        logits, cache, _ = lm.forward(cfg, params, batch, collect_cache=True)
        return logits[:, -1], cache
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, batch):
        return decode_step(cfg, params, cache, batch)
    return serve_step
