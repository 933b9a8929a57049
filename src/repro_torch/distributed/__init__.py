"""Distribution layer of the port: the Δ-window bounded-asynchrony
scheduler (``delta_sync``) and the sharding rules (``sharding``: the
reference's specs as DTensor placements)."""
from .delta_sync import (DeltaScheduler, DeltaSyncConfig,  # noqa: F401
                         gated_microbatch_weights, predicted_utilization)
