"""Optimizers and gradient utilities (port of ``repro.optim``)."""
from .adamw import AdamWConfig, global_norm, init, lr_schedule, update  # noqa: F401
from . import grad  # noqa: F401
