"""musicgen-large — decoder-only over EnCodec tokens; frame embeddings come
from the stub audio frontend per the assignment. [arXiv:2306.05284; hf]"""
from repro_torch.common.types import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048, head_dim=64,
    act="gelu", mlp_gated=False, frontend="audio_stub",
)

SMOKE = ModelConfig(
    name="musicgen-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=64, head_dim=16,
    act="gelu", mlp_gated=False, frontend="audio_stub",
    q_chunk=16, kv_chunk=16,
)
