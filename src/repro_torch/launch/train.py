"""Training launcher (counterpart of ``repro/launch/train.py``), for every
family of the registry: checkpoint/restart, deterministic step-indexed
data (the stubs' patches and frames included), straggler detection, async
checkpointing, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch qwen3-moe-235b-a22b --steps 50 --batch 8 --seq 128 --smoke \
      --device cpu

The device defaults to cuda and raises where there is none.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.common.types import ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.configs.registry import get as get_config, get_smoke
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm as LM
from repro_torch.models import params as Pm
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as Sh


def train(arch: str, steps: int, batch: int, seq: int, smoke: bool,
          ckpt_dir: str, ckpt_every: int = 20, resume: bool = True,
          straggler_factor: float = 5.0, device=None):
    """Train ``steps`` steps (from the latest checkpoint in ``ckpt_dir``
    when ``resume``); returns (params, last loss)."""
    device = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    shape = ShapeConfig("custom", "train", seq, batch)
    plan = Sh.make_plan(cfg, shape, None,
                        ParallelConfig(remat="none", microbatch=1))
    tc = TrainConfig(warmup_steps=10)

    params = LM.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    opt = adamw.init_state(params, plan.parallel.moment_dtype)
    ck = Checkpointer(ckpt_dir)
    start = 0
    if resume and ck.latest_step() is not None:
        start, tree = ck.restore(device=device)
        params = Pm.flatten(tree["params"])
        opt_m = {k: Pm.flatten(v) for k, v in tree["opt_m"].items()}
        opt = adamw.AdamWState(
            tree["opt_meta"]["step"], opt_m["m"], opt_m["m_scale"],
            opt_m["v"], opt_m["v_scale"])
        print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, plan.parallel, tc)
    data = SyntheticLM(cfg, seq, batch)
    times = []
    for step in range(start, steps):
        t0 = time.time()
        params, opt, metrics = step_fn(params, opt, data.batch(step))
        loss = float(metrics["loss"])
        dt = time.time() - t0
        # straggler detection: flag steps far beyond the running median
        times.append(dt)
        med = sorted(times)[len(times) // 2]
        flag = " STRAGGLER" if len(times) > 5 and dt > straggler_factor \
            * med else ""
        print(f"step {step:5d} loss {loss:.4f} {dt * 1e3:7.1f}ms{flag}",
              flush=True)
        if not np.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {step}")
        if (step + 1) % ckpt_every == 0 or step + 1 == steps:
            ck.save(step + 1, dict(
                params=params,
                opt_m=dict(m=opt.m, m_scale=opt.m_scale, v=opt.v,
                           v_scale=opt.v_scale),
                opt_meta=dict(step=opt.step)))
    ck.wait()
    return params, float(metrics["loss"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    train(args.arch, args.steps, args.batch, args.seq, args.smoke,
          args.ckpt_dir, args.ckpt_every, resume=not args.no_resume,
          device=args.device)


if __name__ == "__main__":
    main()
