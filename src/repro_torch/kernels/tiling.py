"""Block sizing for the Hopper kernels (port of ``repro.kernels.tiling``).

The TPU kernels budget 8 MiB of VMEM per tile; on Hopper the scarce
resource is a block's shared memory.  The multistep kernel runs one block
per ring and keeps the ring double-buffered in shared memory (``tau`` and
``tau'``, 8 bytes per PE), so the ring length is bounded by what one block
may hold.  Rings longer than :data:`MAX_RING_L` would need a split across a
thread-block cluster (ROADMAP, later work).
"""
from __future__ import annotations

#: Dynamic shared memory one H100 block may use (227 KB, 232,448 bytes).
SMEM_PER_BLOCK = 232_448
#: Static shared memory the kernel keeps for its block reductions (bound).
SMEM_STATIC = 1024
#: Longest ring the multistep kernel takes: 8 * L + static <= 227 KB.
MAX_RING_L = (SMEM_PER_BLOCK - SMEM_STATIC) // 8


def pick_divisor_block(B: int, block_b: int) -> int:
    """Largest divisor of ``B`` that is <= ``block_b`` (at least 1)."""
    bb = max(1, min(block_b, B))
    while B % bb:
        bb -= 1
    return bb


def ring_smem_bytes(L: int) -> int:
    """Dynamic shared memory of one multistep block: two fp32 ring buffers."""
    return 8 * L


def check_ring_fits(L: int) -> None:
    """Raise if a ring of ``L`` PEs does not fit one block's shared memory."""
    if L > MAX_RING_L:
        raise ValueError(
            f"ring of L={L} PEs needs {ring_smem_bytes(L)} bytes of shared "
            f"memory; one block holds rings up to L={MAX_RING_L}")
