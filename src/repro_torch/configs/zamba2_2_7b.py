"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention blocks (arXiv:2411.15242).

Shared transformer block (weight-tied) applied after every 6 SSM layers on
proj([hidden ; embedding]); per-application LoRA deltas of the released model
are simplified away (DESIGN.md §Arch-applicability).
"""
from .base import ModelConfig
from ..models.ssm import SSMSpec

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm=SSMSpec(d_model=2560, d_state=64, d_conv=4, expand=2, head_dim=64,
                chunk=128),
    hybrid_period=6,
    rope_theta=10_000.0, tie_embeddings=True,
)
