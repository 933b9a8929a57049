"""Distribution layer of the port: the Δ-window bounded-asynchrony
scheduler (``delta_sync``).  The sharding rules of ``repro.distributed``
(``sharding.py``) go with the dry run that reads them (ROADMAP, queue A,
A14); training runs on one device."""
from .delta_sync import (DeltaScheduler, DeltaSyncConfig,  # noqa: F401
                         gated_microbatch_weights, predicted_utilization)
