"""whisper-base [audio]: enc-dec; conv frontend STUBBED (frame embeddings in).

pos_table_len is sized for the assigned decode_32k stress shape (the released
model caps at 448 target positions; we scale the learned table, noted in
DESIGN.md).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, encoder_layers=6,
    d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865,
    act="gelu", gated_mlp=False, norm="layernorm", qkv_bias=True,
    rope_theta=0.0, pos_table_len=32768,
    input_mode="embeddings", tie_embeddings=True,
    q_block=1024, k_block=2048,   # §Perf W2: flash carry traffic ∝ 1/k_block
)
