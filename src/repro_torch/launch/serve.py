"""Serving launcher: prefill + batched greedy decode with a KV cache
or a recurrent state (counterpart of ``repro/launch/serve.py``), for
every family of the registry.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch rwkv6-7b --smoke --device cpu --batch 4 --prompt-len 32 \
      --gen 16

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


def pad_cache(cache, n: int):
    """The prefill cache with its K/V (where the family has them) padded
    by ``n`` positions along their sequence dim (-3); recurrent states
    (``tm_x``, ``S``, ``ssm``, ``conv_*``) stay as they are."""
    return {name: F.pad(a, (0, 0, 0, 0, 0, n)) if name in ("k", "v") else a
            for name, a in cache.items()}


def prompt_batch(cfg: ModelConfig, rng: np.random.Generator, batch: int,
                 prompt_len: int):
    """Random prompts of ``prompt_len`` positions, as the reference's
    ``serve`` draws them from ``rng``: the audio stub's frames; the
    vision stub's min(n_frontend_tokens, prompt_len // 2) patches, then
    tokens; else tokens."""
    if cfg.frontend == "audio_stub":
        return {"frames": rng.standard_normal(
            (batch, prompt_len, cfg.d_model))}
    out = {}
    if cfg.frontend == "vision_stub":
        npt = min(cfg.n_frontend_tokens, prompt_len // 2)
        out["patches"] = rng.standard_normal((batch, npt, cfg.d_model))
        prompt_len -= npt
    out["tokens"] = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    return out


def generate(cfg: ModelConfig, params, prompt_batch, gen: int,
             device=None, frames=None) -> Generation:
    """Prefill ``prompt_batch`` (``tokens`` [B, Lt], with ``patches``
    [B, Np, D] before them for the vision stub, or ``frames`` [B, Lp, D]
    for the audio stub), pad the KV cache to Lp + gen, then decode
    ``gen - 1`` greedy steps.  The audio stub decodes ``frames`` [B,
    gen - 1, D], one row a step, in place of the greedy token.
    ``params``: an ``LM`` or the flat parameter dict, on ``device`` (None
    -> cuda, which must exist)."""
    device = resolve_device(device)
    model = LM.as_model(cfg, params)
    prefill = make_prefill_step(cfg)
    step = make_serve_step(cfg)
    audio = cfg.frontend == "audio_stub"
    if audio and (frames is None or frames.shape[1] < gen - 1):
        raise ValueError(f"the audio stub decodes frames: pass frames "
                         f"[B, {gen - 1}, d_model]")
    pb = {n: torch.as_tensor(a, device=device)
          for n, a in prompt_batch.items()}
    if "tokens" in pb:
        pb["tokens"] = pb["tokens"].to(torch.int32)
    batch = next(iter(pb.values())).shape[0]
    prompt_len = sum(a.shape[1] for a in pb.values())
    if audio:
        frames = torch.as_tensor(frames, device=device)
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(model, pb)
        cache = pad_cache(cache, gen)
        next_tok = logits.argmax(dim=-1).to(torch.int32)
        toks, all_logits = [next_tok], [logits]
        _sync(device)
        t1 = time.perf_counter()
        for i in range(gen - 1):
            dbatch = {"pos": torch.full((batch,), prompt_len + i,
                                        dtype=torch.int32, device=device)}
            if audio:
                dbatch["frames"] = frames[:, i]
            else:
                dbatch["tokens"] = next_tok
            logits, cache = step(model, cache, dbatch)
            next_tok = logits.argmax(dim=-1).to(torch.int32)
            toks.append(next_tok)
            all_logits.append(logits)
        _sync(device)
        t2 = time.perf_counter()
    return Generation(torch.stack(toks, 1), torch.stack(all_logits, 1),
                      t1 - t0, t2 - t1)


def serve(arch: str, smoke: bool, batch: int, prompt_len: int, gen: int,
          seed: int = 0, device=None):
    """Random parameters from ``seed``; prompts (and the audio stub's
    decode frames, one [batch, d_model] draw a step) from numpy's
    ``seed`` stream, in the reference's order.  Returns the [batch, gen]
    greedy tokens."""
    device = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    rng = np.random.default_rng(seed)
    params = LM.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(seed))
    prompts = prompt_batch(cfg, rng, batch, prompt_len)
    frames = None
    if cfg.frontend == "audio_stub":
        frames = np.stack([rng.standard_normal((batch, cfg.d_model))
                           for _ in range(gen - 1)], 1)
    out = generate(cfg, params, prompts, gen, device, frames)
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
