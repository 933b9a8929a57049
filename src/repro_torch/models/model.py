"""Model factory: family -> model class (port of ``repro.models.model``).

The port builds the ``dense`` and ``moe`` families (``DecoderModel``).  The
``ssm``, ``hybrid`` and ``encdec`` families (``SSMModel``, ``HybridModel``,
``EncDecModel``) are still to be ported (ROADMAP, queue A, A13b).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from .transformer import Constrain, DecoderModel, _noop

if TYPE_CHECKING:  # hints only
    from ..configs.base import ModelConfig


def build_model(cfg: ModelConfig, constrain: Constrain = _noop, *,
                device=None, seed: int = 0):
    """The model of ``cfg.family`` with parameters drawn on ``device``
    (``None`` = the GPU) from generator seed ``seed``."""
    if cfg.family in ("dense", "moe"):
        return DecoderModel(cfg, constrain, device=device, seed=seed)
    if cfg.family in ("ssm", "hybrid", "encdec"):
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet "
            f"(ROADMAP, queue A, A13b)")
    raise KeyError(f"unknown model family {cfg.family!r}")
