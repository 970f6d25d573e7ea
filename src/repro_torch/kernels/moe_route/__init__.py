"""The MoE capacity-arbitration kernel: CUDA source, launcher, ops, oracle."""
