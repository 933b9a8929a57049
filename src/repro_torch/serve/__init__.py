"""Serving: continuous batching engine with Δ-window lane synchronization
(port of ``repro.serve``).

Sibling of :mod:`repro_torch.service` (the batched *sweep* front end):
both reuse the paper's Eq. (3) as an admission rule via the shared
:func:`repro_torch.service.scheduler.window_admission` predicate — decode
lanes here, requester fairness there, DP workers in
``repro_torch.distributed.delta_sync``.
"""
from ..service.scheduler import window_admission  # noqa: F401  (shared gate)
from .engine import Request, Result, ServeEngine  # noqa: F401
