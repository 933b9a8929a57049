"""repro_torch.service — batched sweep serving on the port's engine.

Port of ``repro.service``: many requesters' ``WindowSweep`` specs packed
into shared engine passes, every response bit-identical to a direct
``run_window_sweep`` of its spec.

Modules:
  ``api``          request/response core (``SweepService.submit``/``drain``)
  ``scheduler``    compatibility keying, Δ-grid union packing, admission
                   control, Eq. (3) requester fairness, per-round quotas
  ``state_cache``  row-granular LRU of burned-in states (same npz format)
  ``wire``         versioned JSON schema + fault-tolerant JSONL intake

Run ``python -m repro_torch.service queue.jsonl`` to drain a queue.
"""
from .api import (ServiceStats, SweepRequest, SweepResponse, SweepService,
                  canonicalize_spec, spec_fingerprint)
from .scheduler import (BatchScheduler, CompatKey, GridJob, PackedPass,
                        window_admission)
from .state_cache import CACHE_FORMAT_VERSION, StateCache
from .wire import (SCHEMA_VERSION, SUPPORTED_VERSIONS, QueueItem, WireError,
                   decode_request, decode_response, encode_error,
                   encode_request, encode_response, read_queue, serve_queue)

__all__ = ["BatchScheduler", "CACHE_FORMAT_VERSION", "CompatKey", "GridJob",
           "PackedPass", "QueueItem", "SCHEMA_VERSION", "SUPPORTED_VERSIONS",
           "ServiceStats", "StateCache", "SweepRequest", "SweepResponse",
           "SweepService", "WireError", "canonicalize_spec",
           "decode_request", "decode_response", "encode_error",
           "encode_request", "encode_response", "read_queue", "serve_queue",
           "spec_fingerprint", "window_admission"]
