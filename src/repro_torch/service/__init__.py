"""repro_torch.service — batched sweep serving on the port's engine.

Port of ``repro.service``: many requesters' ``WindowSweep`` specs packed
into shared engine passes, every response bit-identical to a direct
``run_window_sweep`` of its spec.

Modules:
  ``api``          request/response core (``SweepService.submit``/``drain``)
  ``scheduler``    compatibility keying, Δ-grid union packing, admission
                   control, Eq. (3) requester fairness, per-round quotas
  ``state_cache``  row-granular LRU of burned-in states, kept on the
                   service's device in front of a host tier (same npz
                   format)
  ``wire``         versioned JSON schema + fault-tolerant JSONL intake
  ``daemon``       long-running watch-directory serve loop (SIGTERM-clean;
                   on a mesh, rank 0 decides each round for every rank)
  ``launch``       ``--mesh`` as process ranks: starts, joins and brings
                   down one process per mesh position

Run ``python -m repro_torch.service queue.jsonl`` to drain a queue, or
``python -m repro_torch.service serve --intake DIR`` for the daemon (see
``__main__``).
"""
from .api import (ServiceStats, SweepRequest, SweepResponse, SweepService,
                  canonicalize_spec, spec_fingerprint)
from .scheduler import (BatchScheduler, CompatKey, GridJob, PackedPass,
                        window_admission)
from .daemon import DaemonConfig, serve_daemon
from .state_cache import CACHE_FORMAT_VERSION, StateCache
from .wire import (SCHEMA_VERSION, SUPPORTED_VERSIONS, QueueItem, WireError,
                   decode_request, decode_response, encode_error,
                   encode_request, encode_response, read_queue, serve_queue)

__all__ = ["BatchScheduler", "CACHE_FORMAT_VERSION", "CompatKey",
           "DaemonConfig", "GridJob",
           "PackedPass", "QueueItem", "SCHEMA_VERSION", "SUPPORTED_VERSIONS",
           "ServiceStats", "StateCache", "SweepRequest", "SweepResponse",
           "SweepService", "WireError", "canonicalize_spec",
           "decode_request", "decode_response", "encode_error",
           "encode_request", "encode_response", "read_queue", "serve_daemon",
           "serve_queue", "spec_fingerprint", "window_admission"]
