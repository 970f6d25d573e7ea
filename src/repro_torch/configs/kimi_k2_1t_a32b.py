"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8 + 1 shared.
[arXiv:2501.kimi2; unverified paper-table]"""
from repro_torch.common.types import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=112,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1),
)

SMOKE = ModelConfig(
    name="kimi-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab_size=256, head_dim=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96, n_shared_experts=1,
                  capacity_factor=8.0),
    q_chunk=16, kv_chunk=16,
)
