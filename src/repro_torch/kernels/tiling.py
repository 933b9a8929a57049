"""Block sizing for the Hopper kernels (port of ``repro.kernels.tiling``).

The TPU kernels budget 8 MiB of VMEM per tile; on Hopper the scarce
resource is a block's shared memory.  The multistep kernels (B1, B3) keep
a ring in shared memory for all K steps, updated in place: 4 bytes per PE
(``csrc/pdes_ring.cuh``).  :func:`ring_plan`, a function of ``L`` alone,
says how:

* up to :data:`MAX_RING_L` PEs (4 L bytes beside a static 2.5 KB of
  per-warp partials and the decode's log table) one block holds the whole
  ring, with :func:`ring_warps` warps.  At L = 10,000 a ring takes 40 KB,
  so four or five rings share an SM;
* a longer ring is cut into segments of ``seg`` PEs (a multiple of 32;
  the last one shorter) that each fit one block (at least
  :func:`ring_blocks` of them), one block each of
  :data:`RING_SPLIT_WARPS` warps, which takes most of an SM's shared
  memory, and the blocks of a ring are ordinary blocks of one
  cooperative launch (the grid tier): each keeps
  its segment in shared memory for all K steps, and they exchange their
  edge PEs and step partials through global memory (L2) and meet once a
  step at a barrier in global memory.  All blocks of a cooperative launch
  are resident at once, so a ring takes at most the card's resident
  blocks, one an SM: :data:`MAX_GRID_RING_L` PEs on an H100.  As many
  whole rings as fit run at once, and the kernel walks the batch in
  waves.  A ring takes the most blocks that keep as many rings at once
  as its least count does, so each wave fills the card with shorter
  segments (the paper's production ring of 2^20 PEs: at least 19 blocks,
  so 6 rings at once, and so 22 blocks a ring on all 132 SMs);
* B1 alone goes further (the stream tier): a ring longer still is cut
  into :data:`RING_MAX_GRID_BLOCKS` segments of one cooperative launch as
  before, each block keeps the first :data:`MAX_RING_SEG` PEs of its
  segment in shared memory and the rest in device memory (its part of
  the output ring, updated in place), and the warps that own those rows
  walk them there each step.  That reaches :data:`MAX_STREAM_RING_L`
  PEs, the longest ring whose PE indices a 32-bit int holds.  B3 stops
  at :data:`MAX_GRID_RING_L`.

The order in which a ring's sums are reduced follows the plan (warps, then
blocks in rank order), so it must not depend on the batch the ring runs
in, nor on how many rings the card holds at once.

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


#: Warps of a block of a ring split over blocks: one such block fills an
#: SM's shared memory, so it brings the warps of four one-block rings
#: (``kRingSplitWarps`` in ``csrc/pdes_ring.cuh`` sizes its partials).
RING_SPLIT_WARPS = 32
#: Static shared memory of a block of a split ring: the per-warp partials
#: of up to 32 warps (2048 bytes) and the decode's log table (2048 bytes),
#: rounded up.
SMEM_STATIC_SPLIT = 4608
#: Longest segment of a block of a split ring: a multiple of 32 PEs with
#: 4 * seg + static <= 227 KB.
MAX_RING_SEG = (SMEM_PER_BLOCK - SMEM_STATIC_SPLIT) // 128 * 32
#: Most blocks of a ring over a cooperative grid: the H100 SXM's 132 SMs,
#: at one such block an SM.  A static figure, for the linter and the CPU
#: tests; the launch asks the card how many blocks it holds at once
#: (``pdes_multistep.resident_rings``) and refuses a ring that needs more.
RING_MAX_GRID_BLOCKS = 132
#: Longest ring of the grid tier, and of B3: :data:`RING_MAX_GRID_BLOCKS`
#: segments that each fit a block's shared memory.
MAX_GRID_RING_L = RING_MAX_GRID_BLOCKS * MAX_RING_SEG
#: Longest segment of a block of B1's stream tier: a multiple of 32 PEs
#: with :data:`RING_MAX_GRID_BLOCKS` of them under 2^31, so that every PE
#: index of the ring is a 32-bit int in the kernel.
MAX_STREAM_SEG = (2**31 - 1) // RING_MAX_GRID_BLOCKS // 32 * 32
#: Longest ring B1 takes: :data:`RING_MAX_GRID_BLOCKS` segments of the
#: stream tier (2,147,481,600 PEs, 8 GiB of tau a row).
MAX_STREAM_RING_L = RING_MAX_GRID_BLOCKS * MAX_STREAM_SEG


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """How B1 and B3 lay out a ring of ``L`` PEs (``csrc/pdes_ring.cuh``).

    ``grid`` blocks a ring of one cooperative launch (1: the whole ring
    in one block), block rank ``j`` owning PEs
    ``[j seg, min((j + 1) seg, L))``; ``warps`` warps a block;
    ``dynamic_smem`` bytes of the ring kept in shared memory (4 a PE: the
    ``keep`` first PEs of the segment, all of it but on the stream tier)
    and ``static_smem`` bytes of partials and table a block.
    """
    grid: int
    seg: int
    warps: int
    dynamic_smem: int
    static_smem: int

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def blocks(self) -> int:
        """Blocks of one ring."""
        return self.grid

    @property
    def fits(self) -> bool:
        """Whether a block's shared memory holds its part of the ring."""
        return self.dynamic_smem + self.static_smem <= SMEM_PER_BLOCK

    @property
    def keep(self) -> int:
        """PEs of a block's segment held in shared memory (the first ones)."""
        return self.dynamic_smem // 4

    @property
    def offchip_seg(self) -> int:
        """PEs of a whole segment that its block keeps in device memory:
        ``seg - keep`` on the stream tier, else 0."""
        return max(0, self.seg - self.keep)

    @property
    def tier(self) -> str:
        """``block``, ``grid`` or ``stream``."""
        if self.grid > 1:
            return "stream" if self.offchip_seg else "grid"
        return "block"

    def offchip_pes(self, L: int) -> int:
        """PEs of a ring of ``L`` that its blocks keep in device memory:
        each block's segment past its first ``keep`` PEs (the last
        segment is shorter)."""
        if not self.offchip_seg:
            return 0
        last = L - (self.blocks - 1) * self.seg
        return (self.blocks - 1) * self.offchip_seg + max(0, last - self.keep)


def _ring_seg(L: int, n: int) -> int:
    """PEs of each segment but the last: ``ceil(L / n)`` rounded up to
    whole rows of 32."""
    return 32 * -(-L // (32 * n))


def ring_blocks(L: int) -> int:
    """Blocks of a ring of ``L`` PEs: 1 up to :data:`MAX_RING_L`; above it
    the least number, at least 2 and at most :data:`RING_MAX_GRID_BLOCKS`,
    whose segments fit one block of :data:`RING_SPLIT_WARPS` warps."""
    if L <= MAX_RING_L:
        return 1
    n = 2
    while n < RING_MAX_GRID_BLOCKS and _ring_seg(L, n) > MAX_RING_SEG:
        n += 1
    return n


@functools.lru_cache(maxsize=1024)
def ring_plan(L: int, *, stream: bool = True) -> RingPlan:
    """The layout of a ring of ``L`` PEs, for any batch.

    One block up to :data:`MAX_RING_L` (as :func:`ring_warps` and
    :func:`ring_smem_bytes` say); above it blocks of a cooperative grid,
    of :data:`RING_SPLIT_WARPS` warps each: the least number whose
    segments fit one block (:func:`ring_blocks`), raised to the most
    blocks of which the card holds as many rings at once.  Above
    :data:`MAX_GRID_RING_L`, B1's plan (``stream``) is the stream tier:
    :data:`RING_MAX_GRID_BLOCKS` blocks whose segments pass
    :data:`MAX_RING_SEG`, each keeping that many PEs in shared memory, up
    to :data:`MAX_STREAM_RING_L`.  Past its kernel's limit (B3's,
    ``stream=False``: :data:`MAX_GRID_RING_L`) the plan of
    :data:`RING_MAX_GRID_BLOCKS` blocks that hold their whole segments
    does not fit (``fits`` is False): :func:`check_ring_fits` raises, and
    the linter's ``vmem-budget`` rule fires on it.
    """
    if L <= MAX_RING_L:
        return RingPlan(1, L, ring_warps(L), ring_smem_bytes(L), SMEM_STATIC)
    # The card holds RING_MAX_GRID_BLOCKS // n rings of the least count n
    # at once, one block an SM; the most blocks a ring that keep that many
    # leave the fewest SMs idle in a full wave and add no wave to a batch.
    n = RING_MAX_GRID_BLOCKS // (RING_MAX_GRID_BLOCKS // ring_blocks(L))
    seg = _ring_seg(L, n)
    keep = seg
    if stream and MAX_RING_SEG < seg <= MAX_STREAM_SEG:
        keep = MAX_RING_SEG
    return RingPlan(n, seg, RING_SPLIT_WARPS, 4 * keep, SMEM_STATIC_SPLIT)


def check_ring_fits(L: int, *, stream: bool = True) -> None:
    """Raise if B1 (B3 where not ``stream``) cannot lay out a ring of
    ``L`` PEs: past :data:`MAX_STREAM_RING_L` (:data:`MAX_GRID_RING_L`)."""
    if not ring_plan(L, stream=stream).fits:
        raise ValueError(
            f"ring of L={L} PEs needs {ring_smem_bytes(L)} bytes of shared "
            f"memory; one block holds rings up to L={MAX_RING_L}, "
            f"{RING_MAX_GRID_BLOCKS} blocks of a cooperative grid up to "
            f"L={MAX_GRID_RING_L}"
            + (f", and {RING_MAX_GRID_BLOCKS} blocks that keep all but "
               f"{MAX_RING_SEG} PEs of each segment in device memory up to "
               f"L={MAX_STREAM_RING_L}" if stream else " (this kernel takes "
               f"no ring past shared memory)"))


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
