"""qwen3-moe-235b-a22b — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B family]"""
from repro_torch.common.types import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=64,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=256, head_dim=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96,
                  capacity_factor=8.0),
    q_chunk=16, kv_chunk=16,
)
