"""zamba2-2.7b — Mamba2 backbone + weight-shared attention blocks.
[arXiv:2411.15242; hf]"""
from repro_torch.common.types import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, headdim=64, chunk=128),
    hybrid=HybridConfig(attn_every=6),
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2, headdim=16, chunk=8),
    hybrid=HybridConfig(attn_every=2),
    subquadratic=True, q_chunk=16, kv_chunk=16,
)
