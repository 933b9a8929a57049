"""mixtral-8x7b [moe]: 8 experts top-2 + SWA (arXiv:2401.04088)."""
from .base import ModelConfig
from ..models.moe import MoESpec

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    moe=MoESpec(n_experts=8, top_k=2, capacity_factor=1.25),
    window=4096, layer_group=("local",),
    rope_theta=1_000_000.0, tie_embeddings=False,
)
