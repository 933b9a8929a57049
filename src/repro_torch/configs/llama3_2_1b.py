"""llama3.2-1b [dense]: small llama3 (hf:meta-llama/Llama-3.2-1B)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=128256,
    rope_theta=500_000.0, tie_embeddings=True,
)
