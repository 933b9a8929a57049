"""Distribution layer of the port: the Δ-window bounded-asynchrony
scheduler (``delta_sync``).  The sharding rules of ``repro.distributed``
belong to the language-model stack's training slice (ROADMAP, queue A,
A13c)."""
from .delta_sync import (DeltaScheduler, DeltaSyncConfig,  # noqa: F401
                         gated_microbatch_weights, predicted_utilization)
