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

The one-step kernel (B2) keeps nothing of a row between launches, so a
row of any length runs; how its work is spread comes from
:func:`step_plan`, a function of the row length ``Lc`` alone for the same
reason: a long row is cut into segments, one block each, the blocks of a
row one thread-block cluster; short rows share a block.
"""
from __future__ import annotations

import dataclasses
import functools

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


#: Most threads of a B2 block (``kMaxThreads`` in ``csrc/pdes_step.cu``):
#: a segment's group where 8 blocks of ``STEP_SEG_THREADS`` would not
#: cover the row.
STEP_THREADS = 512
#: Threads of a B2 segment's group on rows that take a cluster.
STEP_SEG_THREADS = 256
#: Threads of a B2 block whose short rows share it.
STEP_SHARED_THREADS = 128
#: Pairs of PEs a B2 thread takes from a tile (``kPairs``): a group of
#: ``G`` threads walks its segment in tiles of ``2 * STEP_PAIRS * G`` PEs,
#: and keeps τ′ on chip where the segment is one tile, which a row of up
#: to ``2 * STEP_PAIRS * STEP_THREADS * STEP_MAX_CLUSTER`` = 81,920 PEs is.
STEP_PAIRS = 10
#: Most blocks of a row's cluster: the portable cluster size.
STEP_MAX_CLUSTER = 8


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """How B2 spreads a row of ``Lc`` PEs (``csrc/pdes_step.cu``).

    A row is cut into ``cluster`` segments of ``seg`` PEs (even; the last
    one shorter), one block each; the blocks of a row are one cluster.  A
    block of ``threads`` threads holds ``rows`` rows (more than one only
    for short rows, which then take one segment), one group of
    ``threads // rows`` threads a row.  A group walks its segment in tiles
    of ``tile`` PEs; where ``keep`` (one tile a segment) its τ′ stays in
    shared memory for the sumabs pass.  ``smem`` is the block's dynamic
    shared memory in bytes.
    """
    cluster: int
    threads: int
    rows: int
    seg: int
    tile: int
    keep: bool
    smem: int

    @property
    def group(self) -> int:
        """Threads of a row's group."""
        return self.threads // self.rows


def step_group_floats(seg: int, keep: bool) -> int:
    """Floats of shared memory one group of B2 takes: the kept τ′ of its
    segment, in whole 16-byte granules, where ``keep``."""
    return (seg + 3) // 4 * 4 if keep else 0


@functools.lru_cache(maxsize=1024)
def step_plan(Lc: int) -> StepPlan:
    """The launch shape of B2 on rows of ``Lc`` PEs, for any batch.

    A row that :data:`STEP_SEG_THREADS` threads cover at ``2 *
    STEP_PAIRS`` PEs a thread takes one group of the least power of two of
    warps that does (at least one warp), and groups under
    :data:`STEP_SHARED_THREADS` threads share a block.  A longer row takes
    the least power of two of ``STEP_SEG_THREADS``-thread blocks that
    does, up to :data:`STEP_MAX_CLUSTER`, as one cluster, and blocks of
    :data:`STEP_THREADS` where 8 of those would not; past that its
    segments are walked tile by tile and no longer keep τ′ on chip.  Small
    blocks let a whole batch of the main path's rows (448 of 10,000 PEs)
    sit on the card at once, 8 an SM.  The order of a row's sums follows
    this plan, so it must not depend on the batch: a row gives the same
    moments, bit for bit, in any launch.
    """
    if Lc < 1:
        raise ValueError(f"a row has at least one PE, got Lc={Lc}")
    per = 2 * STEP_PAIRS
    need = -(-Lc // per)                  # threads at 2 * STEP_PAIRS PEs each
    if need <= STEP_SEG_THREADS:
        group, cluster = 32, 1
        while group < need:
            group *= 2
    else:
        group = (STEP_SEG_THREADS if need <= STEP_MAX_CLUSTER
                 * STEP_SEG_THREADS else STEP_THREADS)
        cluster = 1
        while cluster < min(STEP_MAX_CLUSTER, -(-need // group)):
            cluster *= 2
    threads = max(group, STEP_SHARED_THREADS)
    rows = threads // group
    seg = 2 * -(-Lc // (2 * cluster))     # even, so segments start aligned
    tile = min(seg, per * group)
    keep = tile == seg
    smem = 4 * rows * step_group_floats(seg, keep)
    return StepPlan(cluster, threads, rows, seg, tile, keep, smem)
