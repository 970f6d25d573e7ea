"""starcoder2-15b — GQA, RoPE, plain GELU MLP. [arXiv:2402.19173; hf]"""
from repro_torch.common.types import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab_size=49152, head_dim=128,
    act="gelu", mlp_gated=False, qkv_bias=True,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    act="gelu", mlp_gated=False, qkv_bias=True, q_chunk=16, kv_chunk=16,
)
