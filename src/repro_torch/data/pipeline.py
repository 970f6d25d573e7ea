"""Deterministic synthetic token pipeline.

Requirements it satisfies for large-scale training:
  * step-indexed determinism — batch(step) is a pure function, so a restart
    from checkpoint step N reproduces exactly the batches N+1... (no data
    state to checkpoint) and a straggler/failed host can recompute any
    shard without coordination;
  * shard-addressable — each data-parallel rank materializes only its own
    rows (host loader at scale would do the same against a real corpus);
  * packed LM batches with next-token labels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.common.types import ModelConfig, ShapeConfig


def _hash_tokens(step: int, row: int, length: int, vocab: int, seed: int):
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, row]))
    # zipfian-ish token distribution: hot vocab head (mirrors the P4DB
    # hot-tuple story on the embedding table)
    z = rng.zipf(1.3, size=length)
    return (z % vocab).astype(np.int32)


@dataclass
class SyntheticLM:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    dp_rank: int = 0
    dp_size: int = 1

    def batch(self, step: int):
        rows = self.global_batch // self.dp_size
        lo = self.dp_rank * rows
        toks = np.stack([_hash_tokens(step, lo + r, self.seq_len + 1,
                                      self.cfg.vocab_size, self.seed)
                         for r in range(rows)])
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.frontend == "audio_stub":
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, 999]))
            batch = {
                "frames": rng.standard_normal(
                    (rows, self.seq_len, self.cfg.d_model)).astype(
                        np.float32),
                "labels": toks[:, 1:],
            }
        elif self.cfg.frontend == "vision_stub":
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, 998]))
            npt = self.cfg.n_frontend_tokens
            batch = {
                "patches": rng.standard_normal(
                    (rows, npt, self.cfg.d_model)).astype(np.float32),
                "tokens": toks[:, :self.seq_len - npt],
                "labels": toks[:, 1:],
            }
        return batch
