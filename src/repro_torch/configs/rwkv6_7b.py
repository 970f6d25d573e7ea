"""rwkv6-7b (Finch) — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from repro_torch.common.types import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="rwkv",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
    d_ff=14336, vocab_size=65536, head_dim=64,
    rwkv=RWKVConfig(head_dim=64, chunk=16, decay_lora=64),
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="rwkv",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    rwkv=RWKVConfig(head_dim=16, chunk=8, decay_lora=8),
    subquadratic=True,
)
