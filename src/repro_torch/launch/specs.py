"""Abstract inputs of every (arch x shape) cell (port of
``repro.launch.specs``).

The reference builds ``ShapeDtypeStruct``s with ``jax.eval_shape``; the
port builds the same tensors under the dry run's ``FakeTensorMode``,
where they have shapes, dtypes and devices but no storage: call these
inside it.  The caches come from the model's own constructors, so the
dry run traces what the real step would run.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig

WHISPER_ENC_LEN = 1536    # stub frontend frames for decode cells (~30 s audio)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cd(cfg: ModelConfig):
    return _DTYPES[cfg.compute_dtype]


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, device="cpu"):
    """Model inputs for one step of the given kind."""
    B, S = shape.global_batch, shape.seq_len

    def tok(*dims):
        return torch.zeros(dims, dtype=torch.int32, device=device)

    def emb():
        return torch.zeros((B, S, cfg.d_model), dtype=_cd(cfg), device=device)

    if shape.kind == "train":
        if cfg.family == "encdec":
            return {"enc_embeddings": emb(), "tokens": tok(B, S),
                    "labels": tok(B, S)}
        if cfg.input_mode == "embeddings":
            return {"embeddings": emb(), "labels": tok(B, S)}
        return {"tokens": tok(B, S), "labels": tok(B, S)}
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {"enc_embeddings": emb()}
        if cfg.input_mode == "embeddings":
            return {"embeddings": emb()}
        return {"tokens": tok(B, S)}
    if shape.kind == "decode":
        return {"tokens": tok(B, 1)}
    raise ValueError(shape.kind)


def abstract_params(model, cfg: ModelConfig):
    """The model's parameter tree (fake when the model was built under
    ``FakeTensorMode``)."""
    return model.params.as_dict(lambda t: t)


def abstract_cache(model, cfg: ModelConfig, shape: ShapeConfig):
    """The decode cache of a decode cell."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        return model.init_cache(B)
    if cfg.family == "hybrid":
        return model.init_cache(B, S)
    if cfg.family == "encdec":
        return model.init_cache(B, S, WHISPER_ENC_LEN)
    return model.cache_spec(B, S)


def abstract_state(model, cfg: ModelConfig):
    from ..train.train_step import init_train_state
    return init_train_state(model)
