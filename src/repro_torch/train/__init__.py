"""Training substrate of the port (port of ``repro.train``): the step
factories (sharded with a ``Parallelism``; ``state_pspecs``),
checkpointing with elastic restore, fault tolerance."""
from .train_step import (init_train_state, make_decode_step,  # noqa: F401
                         make_prefill_step, make_train_step)
from . import checkpoint, fault  # noqa: F401
