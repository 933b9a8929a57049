"""Core PDES dynamics of the port: events, horizon, engine, measurement.

Exports what ``repro.core`` does, plus the threefry stream ``prng``.  The
sharded runtime is ``core.distributed`` on a ``core.mesh.ProcessMesh``,
reached through ``PDESEngine(backend="sharded", mesh=...)``.
"""
from .horizon import (  # noqa: F401
    PDESConfig,
    SimState,
    StepStats,
    burn_in,
    decode_events,
    event_bits,
    init_state,
    measure,
    run,
    run_mean,
    step_core,
)
from .measurement import (  # noqa: F401
    GroupStats,
    extreme_fluctuations,
    group_decomposition,
    progress_rate,
    recombine_w2,
    recombine_wa,
    spread,
    width,
    width_abs,
)
from . import ensemble, prng, scaling, theory  # noqa: F401
from .engine import EngineConfig, PDESEngine  # noqa: F401
