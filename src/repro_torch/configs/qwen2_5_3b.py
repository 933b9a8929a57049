"""qwen2.5-3b [dense]: GQA with QKV bias (hf:Qwen/Qwen2.5 family)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
    d_ff=11008, vocab_size=151936,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
)
