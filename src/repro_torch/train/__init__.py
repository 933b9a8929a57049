"""Training substrate of the port (port of ``repro.train``): the step
factory, checkpointing, fault tolerance.  One device; the sharded state
(``state_pspecs``) goes with A14."""
from .train_step import (init_train_state, make_decode_step,  # noqa: F401
                         make_prefill_step, make_train_step)
from . import checkpoint, fault  # noqa: F401
