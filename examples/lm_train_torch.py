"""Train a ~100M-param dense LM for a few hundred steps with the port's
full stack (data pipeline, AdamW, checkpointing, fault-tolerant loop): the
counterpart of ``examples/lm_train.py``.  The model trains on ``--device``
(default cuda, which must exist; ``--device cpu`` runs the plain PyTorch
versions).  A second run resumes from the newest checkpoint.

  PYTHONPATH=src python examples/lm_train_torch.py [--steps 200]
  PYTHONPATH=src python examples/lm_train_torch.py --steps 2 --batch 1 \
      --seq 16 --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.common.types import ModelConfig  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402

# ~100M params: 8 layers x d512 (vocab 32k dominates: 32k x 512 x 2 = 33M;
# blocks ~25M; total ~60-100M depending on tying)
CFG_100M = ModelConfig(
    name="demo-100m", family="dense",
    n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=32000, head_dim=64, q_chunk=128, kv_chunk=128,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (default cuda)")
    args = ap.parse_args(argv)

    # register the demo config so the launcher can find it
    mod = type(sys)("repro_torch.configs.demo_100m")
    mod.CONFIG = CFG_100M
    mod.SMOKE = CFG_100M
    sys.modules["repro_torch.configs.demo_100m"] = mod

    from repro_torch.models import lm as LM
    from repro_torch.models.params import count_params
    n = count_params(LM.build_defs(CFG_100M))
    print(f"training {CFG_100M.name}: {n / 1e6:.1f}M params, "
          f"{args.steps} steps")
    return train("demo_100m", steps=args.steps, batch=args.batch,
                 seq=args.seq, smoke=False, ckpt_dir="artifacts/ckpt_demo",
                 ckpt_every=50, device=args.device)


if __name__ == "__main__":
    main()
