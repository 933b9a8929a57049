"""The one rule for where the port runs.

Entry points take ``device=None`` and mean the GPU by it.  Without CUDA
they raise instead of carrying on quietly on the CPU: a caller who wants
the CPU (the tests, a laptop) says ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; raise if CUDA is absent.

    A bare ``"cuda"`` gets the current device's index, so that it compares
    equal to the device of the tensors made on it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!r} (cuda or cpu)")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU by default, but CUDA is not "
                "available here; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
