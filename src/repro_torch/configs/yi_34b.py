"""yi-34b — llama-arch GQA dense. [arXiv:2403.04652; hf]"""
from repro_torch.common.types import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128, rope_theta=5_000_000.0,
)

SMOKE = ModelConfig(
    name="yi-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab_size=256, head_dim=8, q_chunk=16, kv_chunk=16,
)
