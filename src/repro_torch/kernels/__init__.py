"""Hand-written Hopper kernels of the port, each beside its plain version.

``pdes_multistep.pdes_multistep_counter`` (CUDA, ``csrc/``) serves the
engine's ``pallas_multistep`` backend; ``ref`` holds the plain PyTorch
oracle; ``_build`` compiles the CUDA sources at first use.
"""
