"""Serve a (reduced) MoE model with batched requests on the PyTorch port —
the P4DB technique as a first-class LM feature: token->expert capacity
arbitration runs through the switch-engine prefix counters (on the card,
one launch of the hand-written moe_plan kernel per MoE layer a forward).

  PYTHONPATH=src python examples/moe_serving_torch.py               # GPU
  PYTHONPATH=src python examples/moe_serving_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import serve  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="device to serve on (default cuda, which must exist)")
args = ap.parse_args()

toks = serve("kimi-k2-1t-a32b", smoke=True, batch=4, prompt_len=32, gen=16,
             device=args.device)
print("generated token matrix shape:", toks.shape)
print(toks[:2])
