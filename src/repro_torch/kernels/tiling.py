"""Block sizing for the Hopper kernels (port of ``repro.kernels.tiling``).

The TPU kernels budget 8 MiB of VMEM per tile; on Hopper the scarce
resource is a block's shared memory.  The multistep kernels (B1, B3) run
one block per ring and keep the ring in shared memory for all K steps,
updated in place: 4 bytes per PE (``csrc/pdes_ring.cuh``), beside a
static 2.5 KB (the per-warp partials and the decode's log table).  So a ring of ``L`` PEs asks for
``4 * L`` bytes of dynamic shared memory, and rings longer than
:data:`MAX_RING_L` would need a split across a thread-block cluster
(ROADMAP, later work).  At L = 10,000 a ring takes 40 KB, so four or
five rings share an SM.

The block's warps come from :func:`ring_warps`, a function of ``L``
alone: the order in which a ring's sums are reduced follows the warps, so
it must not depend on the batch the ring runs in.
"""
from __future__ import annotations

#: Dynamic shared memory one H100 block may use (227 KB, 232,448 bytes).
SMEM_PER_BLOCK = 232_448
#: Static shared memory of a ring block: the per-warp partials (512 bytes)
#: and the decode's log table (2048 bytes), rounded up.
SMEM_STATIC = 3072
#: Longest ring the multistep kernel takes: 4 * L + static <= 227 KB.
MAX_RING_L = (SMEM_PER_BLOCK - SMEM_STATIC) // 4
#: Most warps of a ring's block (``kRingMaxWarps`` in ``csrc/pdes_ring.cuh``).
RING_MAX_WARPS = 8


def pick_divisor_block(B: int, block_b: int) -> int:
    """Largest divisor of ``B`` that is <= ``block_b`` (at least 1)."""
    bb = max(1, min(block_b, B))
    while B % bb:
        bb -= 1
    return bb


def ring_smem_bytes(L: int) -> int:
    """Dynamic shared memory of one multistep block: one fp32 ring."""
    return 4 * L


def ring_warps(L: int) -> int:
    """Warps of the block that runs a ring of ``L`` PEs.

    The largest power of two up to :data:`RING_MAX_WARPS` that gives every
    warp at least one row of 32 PEs; warp ``w`` of ``W`` owns rows
    ``[w R // W, (w + 1) R // W)`` of the ``R = ceil(L / 32)``.
    """
    if L < 1:
        raise ValueError(f"a ring has at least one PE, got L={L}")
    rows = -(-L // 32)
    w = 1
    while 2 * w <= min(RING_MAX_WARPS, rows):
        w *= 2
    return w


def check_ring_fits(L: int) -> None:
    """Raise if a ring of ``L`` PEs does not fit one block's shared memory."""
    if L > MAX_RING_L:
        raise ValueError(
            f"ring of L={L} PEs needs {ring_smem_bytes(L)} bytes of shared "
            f"memory; one block holds rings up to L={MAX_RING_L}")
