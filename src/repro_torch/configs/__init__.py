"""Config registry: --arch <id> -> ModelConfig; shapes (a copy of
``repro.configs``, pure data).  All ten architectures are registered; the
port builds the ``dense`` and ``moe`` families (``models.build_model``)."""
from .base import ModelConfig, ShapeConfig, SHAPES  # noqa: F401

ARCH_IDS = [
    "internvl2-76b", "gemma2-2b", "qwen2.5-3b", "llama3.2-1b",
    "h2o-danube-3-4b", "whisper-base", "zamba2-2.7b", "mixtral-8x7b",
    "arctic-480b", "mamba2-130m",
]

_MODULES = {
    "internvl2-76b": "internvl2_76b",
    "gemma2-2b": "gemma2_2b",
    "qwen2.5-3b": "qwen2_5_3b",
    "llama3.2-1b": "llama3_2_1b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "whisper-base": "whisper_base",
    "zamba2-2.7b": "zamba2_2_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "arctic-480b": "arctic_480b",
    "mamba2-130m": "mamba2_130m",
}


def get_config(arch: str) -> ModelConfig:
    import importlib
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


# (arch, shape) cells skipped per the sub-quadratic rule; see DESIGN.md §6.
LONG_CONTEXT_SKIPS = {
    "internvl2-76b", "qwen2.5-3b", "llama3.2-1b", "arctic-480b",
    "whisper-base",
}


def cell_is_runnable(arch: str, shape: str) -> bool:
    if shape == "long_500k" and arch in LONG_CONTEXT_SKIPS:
        return False
    return True
