"""qwen1.5-0.5b — QKV bias, tied embeddings. [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.common.types import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab_size=151936, head_dim=64,
    qkv_bias=True, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    qkv_bias=True, tie_embeddings=True, q_chunk=16, kv_chunk=16,
)
