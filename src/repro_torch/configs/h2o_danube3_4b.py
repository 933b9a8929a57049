"""h2o-danube-3-4b [dense]: llama+mistral mix with SWA (arXiv:2401.16818)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, vocab_size=32000,
    window=4096, layer_group=("local",),
    rope_theta=10_000.0, tie_embeddings=False,
)
