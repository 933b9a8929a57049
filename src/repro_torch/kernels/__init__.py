"""Hand-written Hopper kernels of the port, each beside its plain version.

``pdes_multistep.pdes_multistep_counter`` (B1, CUDA) serves the engine's
``pallas_multistep`` backend, ``pdes_step.pdes_step`` (B2, CUDA) its
``pallas`` backend and ``pdes_multistep.pdes_multistep`` (B3, CUDA)
``ops.simulate``, whose threefry words come from ``threefry.threefry_bits``
(CUDA, no TPU counterpart); the sources are in ``csrc/``.  ``ops`` wraps
the kernels for full rings; ``ref`` holds the plain PyTorch oracles;
``_build`` compiles the CUDA sources at first use.

Exports what ``repro.kernels`` does, except ``pick_block_b`` (a TPU tile
size) and the names ``pdes_multistep`` and ``pdes_step``, which here stay
the modules that hold those kernels and their launch counts (the functions
are ``ops.pdes_multistep`` and ``ops.pdes_step``).
"""
from .ops import (  # noqa: F401
    pdes_multistep_counter,
    ring_halo,
    simulate,
    step_ring,
    threefry_bits,
)
