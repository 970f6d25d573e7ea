"""Serving launcher: prefill + batched greedy decode with a KV cache
(counterpart of ``repro/launch/serve.py``, ``moe`` family).

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-235b-a22b --smoke --device cpu --batch 4 \
      --prompt-len 32 --gen 16

The device defaults to cuda and raises where there is none.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelConfig
from repro_torch.configs.registry import get as get_config, get_smoke
from repro_torch.core.engine import resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import lm as LM


@dataclass
class Generation:
    tokens: torch.Tensor        # [B, gen] int32 greedy tokens
    logits: torch.Tensor        # [B, gen, V] float32 each token's logits
    prefill_seconds: float      # prefill, cache padding, first argmax
    decode_seconds: float       # the gen - 1 decode steps


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg: ModelConfig, params, prompt_batch, gen: int,
             device=None) -> Generation:
    """Prefill ``prompt_batch["tokens"]`` [B, Lp], pad the KV cache to
    Lp + gen, then decode ``gen - 1`` greedy steps.  ``params``: an
    ``LM`` or the flat parameter dict, on ``device`` (None -> cuda, which
    must exist)."""
    device = resolve_device(device)
    model = LM.as_model(cfg, params)
    prefill = make_prefill_step(cfg)
    step = make_serve_step(cfg)
    tokens = torch.as_tensor(prompt_batch["tokens"], dtype=torch.int32,
                             device=device)
    batch, prompt_len = tokens.shape
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(model, {"tokens": tokens})
        # pad the prefill KV cache out to max_len for decode
        cache = {n: F.pad(a, (0, 0, 0, 0, 0, gen)) for n, a in cache.items()}
        next_tok = logits.argmax(dim=-1).to(torch.int32)
        toks, all_logits = [next_tok], [logits]
        _sync(device)
        t1 = time.perf_counter()
        for i in range(gen - 1):
            pos = torch.full((batch,), prompt_len + i, dtype=torch.int32,
                             device=device)
            logits, cache = step(model, cache, {"tokens": next_tok,
                                                "pos": pos})
            next_tok = logits.argmax(dim=-1).to(torch.int32)
            toks.append(next_tok)
            all_logits.append(logits)
        _sync(device)
        t2 = time.perf_counter()
    return Generation(torch.stack(toks, 1), torch.stack(all_logits, 1),
                      t1 - t0, t2 - t1)


def serve(arch: str, smoke: bool, batch: int, prompt_len: int, gen: int,
          seed: int = 0, device=None):
    """Random parameters from ``seed``, random prompts from numpy's
    ``seed`` stream; returns the [batch, gen] greedy tokens."""
    device = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    rng = np.random.default_rng(seed)
    params = LM.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(seed))
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    out = generate(cfg, params, {"tokens": prompts}, gen, device)
    per_tok = out.decode_seconds / max(gen - 1, 1) / batch * 1e3
    print(f"{arch}: prefill[{batch}x{prompt_len}] + {gen} decode steps on "
          f"{device}; {per_tok:.2f} ms/token/seq")
    return out.tokens.cpu().numpy()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    serve(args.arch, args.smoke, args.batch, args.prompt_len, args.gen,
          device=args.device)


if __name__ == "__main__":
    main()
