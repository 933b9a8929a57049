"""internvl2-76b [vlm]: InternViT + InternLM2 backbone (arXiv:2404.16821).

The ViT frontend is a STUB: input_specs provides precomputed patch embeddings
(B, S, d) for train/prefill; decode consumes text tokens.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    rope_theta=1_000_000.0, tie_embeddings=False,
    input_mode="embeddings",
)
