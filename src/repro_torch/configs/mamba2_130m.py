"""mamba2-130m [ssm]: SSD state-space duality, attention-free (arXiv:2405.21060)."""
from .base import ModelConfig
from ..models.ssm import SSMSpec

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    ssm=SSMSpec(d_model=768, d_state=128, d_conv=4, expand=2, head_dim=64,
                chunk=128),
    tie_embeddings=True,
)
