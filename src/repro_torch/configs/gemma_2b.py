"""gemma-2b — GeGLU, head_dim=256, MQA (kv=1), tied embeddings.
[arXiv:2403.08295; hf]"""
from repro_torch.common.types import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab_size=256000, head_dim=256,
    act="gelu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=128, vocab_size=512, head_dim=32,
    act="gelu", tie_embeddings=True, q_chunk=16, kv_chunk=16,
)
