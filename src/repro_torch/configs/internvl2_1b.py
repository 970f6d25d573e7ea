"""internvl2-1b — InternViT (stub frontend) + Qwen2-0.5B-family LM backbone.
[arXiv:2404.16821; hf]"""
from repro_torch.common.types import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64,
    qkv_bias=True, frontend="vision_stub", n_frontend_tokens=256,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    qkv_bias=True, frontend="vision_stub", n_frontend_tokens=8,
    q_chunk=16, kv_chunk=16,
)
