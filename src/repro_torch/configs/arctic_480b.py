"""arctic-480b [moe]: 128 experts top-2 + parallel dense residual
(hf:Snowflake/snowflake-arctic-base).

param_dtype/optimizer state run in bf16: fp32 m/v for 480B params would
exceed the 256x16 GB single-pod HBM budget (DESIGN.md §Arch-applicability).
"""
from .base import ModelConfig
from ..models.moe import MoESpec

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000,
    moe=MoESpec(n_experts=128, top_k=2, capacity_factor=1.25,
                dense_residual=True),
    rope_theta=10_000.0, tie_embeddings=False,
    param_dtype="bfloat16",
)
