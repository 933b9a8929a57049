"""Hand-written Hopper kernels of the port, each beside its plain version.

``pdes_multistep.pdes_multistep_counter`` (CUDA, ``csrc/``) serves the
engine's ``pallas_multistep`` backend and ``pdes_step.pdes_step`` (CUDA,
``csrc/``) its ``pallas`` backend; ``ops`` wraps the one-step kernel for
full rings; ``ref`` holds the plain PyTorch oracles; ``_build`` compiles
the CUDA sources at first use.
"""
