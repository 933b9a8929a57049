"""gemma2-2b [dense]: local/global alternating SWA + logit softcaps (arXiv:2408.00118)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000,
    window=4096, layer_group=("local", "full"),
    attn_softcap=50.0, final_softcap=30.0,
    act="gelu", post_norms=True, embed_scale=True,
    rope_theta=10_000.0, tie_embeddings=True,
)
