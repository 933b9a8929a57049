"""Config dataclasses: model architecture, input shapes, run settings.

A copy of ``repro.configs.base``, field for field: ``MoESpec`` and
``SSMSpec`` come from the port's own ``models.moe`` and ``models.ssm``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.moe import MoESpec
from ..models.ssm import SSMSpec


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    window: Optional[int] = None          # SWA width (tokens)
    layer_group: tuple[str, ...] = ("full",)   # repeating per-layer kinds
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    attn_impl: str = "flash"       # flash | blockwise | packed (§Perf lever)
    q_block: int = 512
    k_block: int = 512
    # ffn
    act: str = "silu"
    gated_mlp: bool = True
    moe: Optional[MoESpec] = None
    # ssm / hybrid
    ssm: Optional[SSMSpec] = None
    hybrid_period: Optional[int] = None   # zamba2: shared attn every N ssm layers
    # enc-dec
    encoder_layers: int = 0
    pos_table_len: int = 0                # learned decoder positions (whisper)
    # embeddings / norm
    input_mode: str = "tokens"            # tokens | embeddings (stub frontend)
    tie_embeddings: bool = True
    embed_scale: bool = False             # multiply embeddings by sqrt(d)
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    norm_eps: float = 1e-5
    post_norms: bool = False              # gemma2 post-attn/post-mlp norms
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"                   # none | full | dots
    ce_chunk: int = 256
    # training
    microbatches: int = 1                 # gradient-accumulation splits

    @property
    def group_size(self) -> int:
        return len(self.layer_group)

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.group_size == 0, (self.n_layers, self.layer_group)
        return self.n_layers // self.group_size

    def n_params(self) -> int:
        """Approximate parameter count (embeddings included once if tied)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        attn = d * self.n_heads * self.head_dim * 2 \
            + d * self.n_kv_heads * self.head_dim * 2
        mlp = d * f * (3 if self.gated_mlp else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "encdec"):
            per_layer += attn
        if self.moe is not None:
            per_layer += d * self.moe.n_experts \
                + self.moe.n_experts * d * f * (3 if self.gated_mlp else 2)
            if self.moe.dense_residual:
                per_layer += mlp
        elif self.family in ("dense", "encdec"):
            per_layer += mlp
        if self.ssm is not None:
            s = self.ssm
            per_layer_ssm = d * (2 * s.d_inner + 2 * s.d_state + s.n_heads) \
                + s.d_inner * d
            if self.family == "hybrid":
                n_ssm = L
                shared = attn + mlp + 2 * d * d
                return n_ssm * per_layer_ssm + shared + self.vocab_size * d
            return L * per_layer_ssm + self.vocab_size * d
        total = L * per_layer + self.vocab_size * d
        if self.family == "encdec":
            total += self.encoder_layers * (attn + mlp) + self.pos_table_len * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.n_params()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        dense = self.n_params() - L * self.moe.n_experts * d * f \
            * (3 if self.gated_mlp else 2)
        active_moe = L * self.moe.top_k * d * f * (3 if self.gated_mlp else 2)
        return dense + active_moe

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        g = self.group_size
        ssm = None
        if self.ssm is not None:
            ssm = SSMSpec(d_model=64, d_state=16, d_conv=4, expand=2,
                          head_dim=16, chunk=16)
        moe = None
        if self.moe is not None:
            moe = MoESpec(n_experts=4, top_k=min(2, self.moe.top_k),
                          capacity_factor=2.0,
                          dense_residual=self.moe.dense_residual)
        return dataclasses.replace(
            self,
            n_layers=2 * g if self.hybrid_period is None else 2 * (self.hybrid_period),
            d_model=64, n_heads=4, n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            head_dim=16, d_ff=128, vocab_size=512,
            window=32 if self.window else None,
            moe=moe, ssm=ssm,
            hybrid_period=self.hybrid_period,
            encoder_layers=2 if self.encoder_layers else 0,
            pos_table_len=128 if self.pos_table_len else 0,
            q_block=32, k_block=32, ce_chunk=32,
            param_dtype="float32", compute_dtype="float32",
            remat="none", microbatches=1,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    def reduced(self) -> "ShapeConfig":
        return dataclasses.replace(
            self, seq_len=min(self.seq_len, 64),
            global_batch=min(self.global_batch, 2))


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
