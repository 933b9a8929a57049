"""repro_torch — the PyTorch/CUDA port of ``repro``, beside the JAX package.

The same Δ-window constrained conservative PDES (Kolakowska & Novotny,
PRE 67, 046703) and the same sweep service, written in PyTorch, with the
engine's fused path served by a CUDA kernel written for Hopper
(``kernels/csrc/pdes_multistep_counter.cu``).  The layout mirrors
``repro``: each module sits at the same relative path as its JAX
counterpart.  The package imports ``torch`` and numpy only, never ``jax``
or ``repro``.

Entry points run on the GPU unless the caller passes ``device="cpu"``
(see :func:`repro_torch.device.resolve_device`); on the CPU every kernel
wrapper runs its plain PyTorch version instead.

Sub-packages are imported on use, so ``import repro_torch`` stays cheap.
"""
