"""What the CPU can check of the kernels' design (B1, B2, B3).

The kernels themselves run only on a card (``tests/test_torch_cuda.py``);
here are the pieces of them that are plain arithmetic: the launch shapes
that ``kernels/tiling.py`` picks from L (the rings' warps, B2's plan),
the division-free site pick and the table-driven η decode, each repeated
in Python the way the kernels compute them and held against ``%`` and
the plain decode rule.
"""
import re

import numpy as np
import pytest

from repro_torch.kernels import (_build, pdes_multistep, pdes_step, ref,
                                 tiling)

#: n_v values whose multiply-high constants take every shape: 1 (no shift),
#: powers of two, small odd, the paper's 10, and the two largest classes.
N_VS = (1, 2, 3, 10, 1000, 2**31 + 1, 2**32 - 1)


def test_ring_launch_shape_for_every_ring_length():
    """For every L a block can hold: each PE owned by exactly one warp, at
    most 1024 threads, shared memory within the block's, from L alone."""
    Ls = np.arange(1, tiling.MAX_RING_L + 1)
    warps = np.array([tiling.ring_warps(int(L)) for L in Ls])
    rows = (Ls + 31) // 32
    assert set(np.unique(warps)) <= {1, 2, 4, 8}
    assert (warps <= tiling.RING_MAX_WARPS).all()
    assert (32 * warps <= 1024).all()
    assert (warps <= rows).all()          # every warp has a row
    assert (warps[rows >= 8] == 8).all()
    for w in range(tiling.RING_MAX_WARPS):
        live = w < warps
        r0 = w * rows // warps
        r1 = (w + 1) * rows // warps
        assert (r1[live] > r0[live]).all()
        first, last = 32 * r0, np.minimum(32 * r1, Ls) - 1
        assert (first[live] <= last[live]).all()
        if w == 0:
            assert (first == 0).all()
        else:                              # starts where warp w - 1 ended
            prev_last = np.minimum(32 * (w * rows // warps), Ls) - 1
            assert (first[live] == prev_last[live] + 1).all()
        end = live & (w == warps - 1)
        assert (last[end] == Ls[end] - 1).all()
    smem = np.array([tiling.ring_smem_bytes(int(L)) for L in Ls[::997]])
    assert (smem + tiling.SMEM_STATIC <= tiling.SMEM_PER_BLOCK).all()
    assert tiling.ring_smem_bytes(tiling.MAX_RING_L + 1) + \
        tiling.SMEM_STATIC > tiling.SMEM_PER_BLOCK


@pytest.mark.parametrize("L,warps", [(1, 1), (31, 1), (33, 2), (100, 4),
                                     (255, 8), (1000, 8), (10_000, 8),
                                     (tiling.MAX_RING_L, 8)])
def test_ring_warps(L, warps):
    assert tiling.ring_warps(L) == warps


def test_ring_warps_rejects_an_empty_ring():
    with pytest.raises(ValueError, match="at least one PE"):
        tiling.ring_warps(0)


#: The longest ring of 16 blocks (911,360 PEs), chip_smoke.py phase 17's.
L16 = 16 * tiling.MAX_RING_SEG
#: Ring lengths of the ring plan's rules: short rings, the main path, the
#: longest one-block ring and one past it, the long-ring shapes of
#: chip_smoke.py phase 17, the JAX package's one-row VMEM budget edge, the
#: longest ring of 16 blocks and one past it, the paper's production ring
#: (phase 18), 2^22, the cap.
RING_LS = (1, 31, 32, 10_000, tiling.MAX_RING_L, tiling.MAX_RING_L + 1,
           65_536, 131_072, 524_285, 524_288, L16, L16 + 1, 1 << 20, 1 << 22,
           tiling.MAX_GRID_RING_L)


@pytest.mark.parametrize("L", RING_LS)
def test_ring_plan(L):
    """B1's and B3's layout, from L alone: one block as before up to
    MAX_RING_L; above it blocks of a cooperative grid whose segments,
    whole rows but the last, tile the ring and each fit one block with a
    row a warp: the least number that fits, raised to the most that keep
    as many rings on the card at once."""
    p = tiling.ring_plan(L)
    lp = pdes_multistep.launch_plan(7, L)
    assert lp == {"grid": (7 * p.grid,), "ring_grid": p.grid,
                  "threads": 32 * p.warps,
                  "seg": p.seg, "dynamic_smem": p.dynamic_smem,
                  "static_smem": p.static_smem, "tier": p.tier,
                  "offchip_seg": 0}
    assert lp == pdes_multistep.launch_plan(7, L, bits=True)   # B3's too
    assert p == tiling.ring_plan(L, stream=False)
    assert p.tier == ("block" if L <= tiling.MAX_RING_L else "grid")
    assert p.fits and p.dynamic_smem == 4 * p.seg and p.keep == p.seg
    assert p.offchip_pes(L) == 0
    assert p.dynamic_smem + p.static_smem <= tiling.SMEM_PER_BLOCK
    if L <= tiling.MAX_RING_L:
        assert p == tiling.RingPlan(1, L, tiling.ring_warps(L),
                                    tiling.ring_smem_bytes(L),
                                    tiling.SMEM_STATIC)
        return
    assert 2 <= p.grid == p.blocks <= tiling.RING_MAX_GRID_BLOCKS
    assert p.warps == tiling.RING_SPLIT_WARPS
    assert p.static_smem == tiling.SMEM_STATIC_SPLIT
    starts = [j * p.seg for j in range(p.blocks)]
    ends = [min(s + p.seg, L) for s in starts]
    assert starts[0] == 0 and ends[-1] == L
    assert all(e == s for e, s in zip(ends, starts[1:]))
    lens = [e - s for s, e in zip(starts, ends)]
    assert all(n % 32 == 0 for n in lens[:-1]) and 0 < lens[-1] <= p.seg
    assert -(-lens[-1] // 32) >= p.warps          # a row for every warp
    # the least number of blocks that fits, and the most of as many rings
    # at once
    n = tiling.ring_blocks(L)
    fewer = n - 1
    assert (L > tiling.MAX_RING_L if fewer == 1 else
            4 * 32 * -(-L // (32 * fewer)) + p.static_smem
            > tiling.SMEM_PER_BLOCK)
    assert 4 * 32 * -(-L // (32 * n)) + p.static_smem \
        <= tiling.SMEM_PER_BLOCK
    assert 132 // p.blocks == 132 // n and 132 // (p.blocks + 1) < 132 // n


#: One ring length for each block count n from 2 to 16 (n full segments,
#: at n = 10 the cell exact_mix.ring512k's 2^19), and the edges of the
#: 2-block range.
ROUTE_LS = tuple(524_288 if n == 10 else n * tiling.MAX_RING_SEG
                 for n in range(2, 17)) + (
    tiling.MAX_RING_L + 1, 2 * tiling.MAX_RING_SEG + 1)


@pytest.mark.parametrize("L", ROUTE_LS)
def test_ring_plan_routes_by_block_count(L):
    """Every ring of 2 blocks or more takes the cooperative grid, at least
    the least number of blocks whose segments (whole rows, ceil(L / n)
    rounded up to 32) fit one block of 32 warps, and the most that keep
    as many rings at once: the least count from 2 to 14 and 16, 16 for
    15; B1's plan is B3's."""
    n = tiling.ring_blocks(L)
    assert (n - 1) * tiling.MAX_RING_SEG < L <= n * tiling.MAX_RING_SEG
    assert n >= 2
    g = 16 if n == 15 else n
    p = tiling.ring_plan(L)
    assert p == tiling.ring_plan(L, stream=False)
    seg = tiling._ring_seg(L, g)
    assert p.tier == "grid" and p.fits
    assert p == tiling.RingPlan(g, seg, tiling.RING_SPLIT_WARPS, 4 * seg,
                                tiling.SMEM_STATIC_SPLIT)
    for bits in (False, True):
        lp = pdes_multistep.launch_plan(28, L, bits=bits)
        assert lp["grid"] == (28 * g,) and lp["tier"] == p.tier
    if L == 524_288:              # the cell exact_mix.ring512k
        assert (p.tier, p.grid, p.seg) == ("grid", 10, 52_448)
    if L == 15 * tiling.MAX_RING_SEG:   # 8 rings at once either way
        assert (p.grid, p.seg) == (16, 53_408)


@pytest.mark.parametrize("L,seg", [(tiling.MAX_RING_L + 1, 28_704),
                                   (65_600, 32_800),
                                   (2 * tiling.MAX_RING_SEG, 56_960)])
def test_two_block_rings_keep_their_segments(L, seg):
    """A ring of 2 blocks (57,345 to 113,920 PEs) keeps the segments it
    had before it took the grid, so the same sums in the same rank order
    and the same bits."""
    p = tiling.ring_plan(L)
    assert (p.grid, p.seg) == (2, seg)
    assert (p.warps, p.dynamic_smem, p.static_smem) == (32, 4 * seg, 4608)


@pytest.mark.parametrize("L", [L16 + 1, 1 << 20, 1 << 22,
                               tiling.MAX_GRID_RING_L])
def test_ring_plan_over_the_grid(L):
    """The grid tier: at least ceil(L / MAX_RING_SEG) blocks, raised to the
    most that keep as many rings at once, a function of L alone (the same
    for every batch), segments of whole rows and a non-empty last one; the
    shortest ring of 17 blocks takes 18, the paper's production ring 22
    (19 at the least), 2^22 all 132."""
    p = tiling.ring_plan(L)
    n = -(-L // tiling.MAX_RING_SEG)
    assert p.grid == 132 // (132 // n)
    assert p.grid == {L16 + 1: 18, 1 << 20: 22, 1 << 22: 132,
                      tiling.MAX_GRID_RING_L: 132}[L]
    assert p.seg % 32 == 0 and p.seg <= tiling.MAX_RING_SEG
    assert 0 < L - (p.grid - 1) * p.seg <= p.seg
    for B in (1, 6, 8, 448):
        lp = pdes_multistep.launch_plan(B, L)
        assert lp["ring_grid"] == p.grid and lp["seg"] == p.seg
        assert lp["grid"] == (B * p.grid,)
    if L == 1 << 20:
        assert (p.grid, p.seg) == (22, 47_680)
    if L == tiling.MAX_GRID_RING_L:
        assert (p.grid, p.seg) == (tiling.RING_MAX_GRID_BLOCKS,
                                   tiling.MAX_RING_SEG)


#: (least count, L, the plan's blocks) of one ring length of each range of
#: least counts that the plan fills: n whole segments, at 19 the paper's
#: production ring.
FILL_CASES = ((15, 15 * tiling.MAX_RING_SEG, 16),
              (17, 17 * tiling.MAX_RING_SEG, 18), (19, 1 << 20, 22),
              (23, 23 * tiling.MAX_RING_SEG, 26),
              (27, 27 * tiling.MAX_RING_SEG, 33),
              (34, 34 * tiling.MAX_RING_SEG, 44),
              (45, 45 * tiling.MAX_RING_SEG, 66),
              (67, 67 * tiling.MAX_RING_SEG, 132),
              (131, 131 * tiling.MAX_RING_SEG, 132))


@pytest.mark.parametrize("n,L,grid", FILL_CASES)
def test_grid_plan_fills_the_card(n, L, grid):
    """A grid-tier ring takes the most blocks whose rings the card holds as
    many of at once (132 // grid) as of the least count's: the waves stay,
    and each block's segment shortens; segments of whole rows, the last
    one a row for every warp; B1's plan is B3's."""
    assert tiling.ring_blocks(L) == n
    p = tiling.ring_plan(L)
    assert p.grid == grid == max(g for g in range(n, 133)
                                 if 132 // g == 132 // n)
    assert p.tier == "grid" and p.fits
    assert p.seg % 32 == 0 and p.seg == tiling._ring_seg(L, grid)
    last = L - (p.grid - 1) * p.seg
    assert 32 * p.warps <= last <= p.seg
    assert p == tiling.ring_plan(L, stream=False)
    assert p == tiling.RingPlan(grid, p.seg, tiling.RING_SPLIT_WARPS,
                                4 * p.seg, tiling.SMEM_STATIC_SPLIT)
    if L == 1 << 20:
        assert (p.grid, p.seg, last) == (22, 47_680, 47_296)


#: (L, (grid, seg)) of plans that already filled the card and stay as
#: they were: the block tier, least counts 2 to 14 (2^19 included), the
#: stream tier.
KEPT_PLANS = ((10_000, (1, 10_000)), (tiling.MAX_RING_L, (1, 57_344)),
              (tiling.MAX_RING_L + 1, (2, 28_704)), (1 << 19, (10, 52_448))
              ) + tuple((n * tiling.MAX_RING_SEG, (n, 56_960))
                        for n in range(2, 15)) + (
    (tiling.MAX_GRID_RING_L, (132, 56_960)),
    (tiling.MAX_GRID_RING_L + 32, (132, 56_992)), (1 << 23, (132, 63_552)))


@pytest.mark.parametrize("L,plan", KEPT_PLANS)
def test_plans_that_fill_the_card_are_kept(L, plan):
    """Least counts of 2 to 14 already fill the card in whole rings, so the
    grid tier keeps their plans, as do the block tier and the stream
    tier (132 blocks already): pinned by value."""
    p = tiling.ring_plan(L)
    assert (p.grid, p.seg) == plan
    if p.grid == 1:
        assert (p.warps, p.dynamic_smem, p.static_smem) == (
            8, 4 * L, tiling.SMEM_STATIC)
    else:
        assert (p.warps, p.dynamic_smem, p.static_smem) == (
            32, 4 * min(p.seg, tiling.MAX_RING_SEG), tiling.SMEM_STATIC_SPLIT)
        assert p.grid == tiling.ring_blocks(L)


def test_ring_plan_raises_above_the_cap():
    """B1's cap is the stream tier's: past the grid's, B1 lays a ring out
    up to MAX_STREAM_RING_L and raises only past it, naming all three
    limits (B3 keeps the grid's cap: the next test)."""
    cap = tiling.MAX_STREAM_RING_L
    assert tiling.MAX_GRID_RING_L >= 1 << 22
    assert tiling.MAX_GRID_RING_L == \
        tiling.RING_MAX_GRID_BLOCKS * tiling.MAX_RING_SEG
    assert cap == tiling.RING_MAX_GRID_BLOCKS * tiling.MAX_STREAM_SEG
    assert cap < 2**31 <= cap + tiling.RING_MAX_GRID_BLOCKS * 32
    tiling.check_ring_fits(cap)
    tiling.check_ring_fits(tiling.MAX_GRID_RING_L + 1)
    tiling.check_ring_fits(L16 + 1)
    assert not tiling.ring_plan(cap + 1).fits
    with pytest.raises(ValueError, match=f"L={tiling.MAX_RING_L}, "
                       f"132 blocks of a cooperative grid up to "
                       f"L={tiling.MAX_GRID_RING_L}, and 132 blocks that "
                       f"keep all but {tiling.MAX_RING_SEG} PEs of each "
                       f"segment in device memory up to L={cap}"):
        tiling.check_ring_fits(cap + 1)
    # a split block's static shared memory holds two parity slots of 8
    # per-warp words for its most warps, and the 2 KB log table
    src = (_build.CSRC / "pdes_ring.cuh").read_text()
    assert (f"constexpr int kRingSplitWarps = "
            f"{tiling.RING_SPLIT_WARPS};") in src
    assert 2 * 8 * 4 * tiling.RING_SPLIT_WARPS + 2048 <= \
        tiling.SMEM_STATIC_SPLIT
    # the workspace the wrapper makes is the launcher's: a 128-byte counter
    # line a ring slot and two parities of a 32-byte part a block
    assert "(size_t)rings * 128 + (size_t)rings * 2 * g * sizeof(GridPart)" \
        in src
    assert pdes_multistep.GRID_SLOT_BYTES == 128
    assert pdes_multistep.GRID_PART_BYTES == 8 * 4


def test_b3_raises_above_the_grid_cap():
    """B3 has no stream tier: its plan past MAX_GRID_RING_L is the grid's
    132 blocks holding whole segments, which do not fit, and its check
    raises there, naming the three limits of shared memory."""
    cap = tiling.MAX_GRID_RING_L
    tiling.check_ring_fits(cap, stream=False)
    for L in (cap + 1, 1 << 23):
        p = tiling.ring_plan(L, stream=False)
        assert not p.fits and p.tier == "grid" and p.offchip_seg == 0
        assert p.dynamic_smem == 4 * p.seg
        assert p.dynamic_smem + p.static_smem > tiling.SMEM_PER_BLOCK
        lp = pdes_multistep.launch_plan(4, L, bits=True)
        assert lp["dynamic_smem"] == p.dynamic_smem and lp["tier"] == "grid"
        with pytest.raises(ValueError, match=f"132 blocks of a cooperative "
                           f"grid up to L={cap} \\(this kernel takes no "
                           f"ring past shared memory\\)"):
            tiling.check_ring_fits(L, stream=False)


#: The stream tier's rings: one row past the grid's cap, the cell
#: exact_mix.ring8m's 2^23, twice that, and the tier's own limit.
STREAM_LS = (tiling.MAX_GRID_RING_L + 32, 1 << 23, 1 << 24,
             tiling.MAX_STREAM_RING_L)


@pytest.mark.parametrize("L", STREAM_LS)
def test_ring_plan_on_the_stream_tier(L):
    """Past the grid's cap B1 keeps the grid's 132 blocks of whole-row
    segments, and each keeps its first MAX_RING_SEG PEs in shared memory
    and the rest in device memory: a function of L alone, which
    launch_plan reports for every batch."""
    p = tiling.ring_plan(L)
    assert p.tier == "stream" and p.fits
    assert p.grid == tiling.RING_MAX_GRID_BLOCKS
    assert p.seg == 32 * -(-L // (32 * tiling.RING_MAX_GRID_BLOCKS))
    assert tiling.MAX_RING_SEG < p.seg <= tiling.MAX_STREAM_SEG
    assert p.keep == tiling.MAX_RING_SEG and p.dynamic_smem == 4 * p.keep
    assert p.warps == tiling.RING_SPLIT_WARPS
    assert p.static_smem == tiling.SMEM_STATIC_SPLIT
    assert p.offchip_seg == p.seg - p.keep
    last = L - (p.grid - 1) * p.seg
    assert 0 < last <= p.seg
    assert p.offchip_pes(L) == (p.grid - 1) * p.offchip_seg + max(
        0, last - p.keep)
    # a row for every warp: each part of a segment holds the warps its
    # stream_warps split gives it (csrc/pdes_ring.cuh)
    assert p.keep // 32 >= p.warps and -(-last // 32) >= p.warps
    tiling.ring_plan.cache_clear()
    assert tiling.ring_plan(L) == p
    for B in (1, 3, 14):
        lp = pdes_multistep.launch_plan(B, L)
        assert lp == {"grid": (B * p.grid,), "ring_grid": p.grid,
                      "threads": 32 * p.warps,
                      "seg": p.seg, "dynamic_smem": p.dynamic_smem,
                      "static_smem": p.static_smem, "tier": "stream",
                      "offchip_seg": p.offchip_seg}
        assert pdes_multistep.offchip_bytes_of(B, L, 16) == \
            8 * B * 16 * p.offchip_pes(L)
    if L == tiling.MAX_GRID_RING_L + 32:     # one row of device memory
        assert (p.seg, p.offchip_seg, p.offchip_pes(L)) == (56_992, 32,
                                                           131 * 32)
    if L == 1 << 23:                          # the cell exact_mix.ring8m
        assert (p.seg, p.offchip_seg, p.offchip_pes(L)) == (63_552, 6_592,
                                                           869_888)
        assert 8 * p.offchip_pes(L) / L == 0.82958984375
    if L == tiling.MAX_STREAM_RING_L:
        assert p.seg == tiling.MAX_STREAM_SEG and last == p.seg


def test_ring_plan_below_the_stream_tier_is_unchanged():
    """Up to the grid's cap B1's plan is the one B3 keeps, for every class
    of L (the stream tier adds rings and changes none)."""
    for L in (1, 10_000, tiling.MAX_RING_L + 1, L16, L16 + 1, 1 << 20, 1 << 22,
              tiling.MAX_GRID_RING_L - 1, tiling.MAX_GRID_RING_L):
        assert tiling.ring_plan(L) == tiling.ring_plan(L, stream=False)
        assert tiling.ring_plan(L).offchip_seg == 0
    assert pdes_multistep.offchip_bytes_of(14, 1 << 20, 16) == 0

#: Row lengths B2's plan is checked at: every Lc to past the longest row
#: one cluster keeps on chip, then a stride and every class boundary up to
#: the full ring of ``--pdes-core`` and two past it.
STEP_LCS = sorted(set(range(1, 66_001)) | set(range(66_001, (1 << 20) + 3,
                                                     997))
                  | {(1 << k) + d for k in range(17, 21) for d in (-1, 0, 1, 2)})
#: (row length, cluster, threads, rows) at the shapes the port runs: the
#: commavoid edge strip, the JAX tests' rows, the main path, a
#: --pdes-core shard, the longest ring of B1, the full ring of 2^20 PEs.
STEP_SHAPES = [(16, 1, 128, 4), (37, 1, 128, 4), (1000, 1, 128, 2),
               (5120, 1, 256, 1), (10_000, 2, 256, 1), (40_960, 8, 256, 1),
               (65_536, 8, 512, 1), (tiling.MAX_RING_L + 1000, 8, 512, 1),
               (1 << 20, 8, 512, 1)]


@pytest.mark.parametrize("case", ["batch", "cluster", "cover", "smem",
                                  "shapes"])
def test_step_plan(case):
    """B2's plan is a function of Lc alone: the same for every batch, at
    most the portable cluster, every PE in exactly one segment and one
    thread's share of a tile, and a block's shared memory within the
    card's, for every Lc from 1 to 2^20 + 2."""
    plans = [(Lc, tiling.step_plan(Lc)) for Lc in STEP_LCS]
    if case == "batch":
        for Lc, p in plans[::61]:
            for B in (1, 2, 3, 5, 32, 448, 1001):
                lp = pdes_step.launch_plan(B, Lc)
                assert lp.pop("grid") == (p.cluster * -(-B // p.rows),)
                assert lp == {"cluster": p.cluster, "threads": p.threads,
                              "rows": p.rows, "dynamic_smem": p.smem,
                              "static_smem": pdes_step.STATIC_SMEM}
    elif case == "cluster":
        for Lc, p in plans:
            assert p.cluster in (1, 2, 4, tiling.STEP_MAX_CLUSTER), Lc
            assert p.cluster == 1 or p.rows == 1, Lc
            assert p.threads <= tiling.STEP_THREADS and p.group % 32 == 0
            assert p.threads == p.rows * p.group
        assert max(p.cluster for _, p in plans) == tiling.STEP_MAX_CLUSTER
    elif case == "cover":
        for Lc, p in plans:
            assert p.seg % 2 == 0 and p.tile % 2 == 0 and p.tile <= p.seg
            assert p.seg * p.cluster >= Lc > p.seg * (p.cluster - 1), Lc
            assert p.tile <= 2 * tiling.STEP_PAIRS * p.group, Lc
            assert p.keep == (p.tile == p.seg)
            assert p.keep == (Lc <= 2 * tiling.STEP_PAIRS * tiling.STEP_THREADS
                              * tiling.STEP_MAX_CLUSTER), Lc
    elif case == "smem":
        for Lc, p in plans:
            assert p.smem == 4 * p.rows * tiling.step_group_floats(
                p.seg, p.keep)
            # the kept τ′ of each row's segment, in whole 16-byte granules
            assert p.smem == (16 * p.rows * -(-p.seg // 4) if p.keep else 0)
            assert p.smem + pdes_step.STATIC_SMEM <= tiling.SMEM_PER_BLOCK
        assert pdes_step.STATIC_SMEM % 16 == 0
    else:
        for Lc, cluster, threads, rows in STEP_SHAPES:
            p = tiling.step_plan(Lc)
            assert (p.cluster, p.threads, p.rows) == (cluster, threads, rows)
        assert pdes_step.launch_plan(32, 16)["grid"] == (8,)
        assert pdes_step.launch_plan(32, 65_536)["grid"] == (256,)
        assert pdes_step.launch_plan(448, 10_000)["grid"] == (896,)
        with pytest.raises(ValueError, match="at least one PE"):
            tiling.step_plan(0)


@pytest.mark.parametrize("n_v", N_VS)
def test_site_pick_without_division_equals_mod(n_v):
    rng = np.random.default_rng(n_v % 1000)
    edges = [0, 1, n_v - 1, n_v, n_v + 1, 2**32 - 1]
    for m in (2, 3, 2**32 // n_v):
        edges += [m * n_v - 1, m * n_v, m * n_v + 1]
    w = np.array([e for e in edges if 0 <= e < 2**32], np.uint64)
    w = np.concatenate([w, rng.integers(0, 2**32, 100_000, dtype=np.uint64)])
    np.testing.assert_array_equal(ref.site_of(w, n_v), w % n_v)
    assert ref.site_of(2**32 - 1, n_v) == (2**32 - 1) % n_v


def test_site_divisor_constants():
    assert ref.site_divisor(1) == (1, 0, 0)
    assert ref.site_divisor(2) == (1, 1, 0)
    assert ref.site_divisor(10) == (2576980378, 1, 3)
    assert ref.site_divisor(2**32 - 1) == (2, 1, 31)
    for bad in (0, 2**32):
        with pytest.raises(ValueError, match="n_v"):
            ref.site_divisor(bad)


def _header_table():
    text = (_build.CSRC / "pdes_common.cuh").read_text()
    body = text[text.index("kNegLogTable[128] = {"):]
    body = body[:body.index("};")]
    pairs = re.findall(r"\{(\S+), (\S+)\}", body)
    return [(float.fromhex(c), float.fromhex(lc)) for c, lc in pairs]


def test_log_table_in_the_kernel_source_is_the_python_one():
    table = ref.neg_log_table()
    assert len(table) == 128
    assert _header_table() == table
    for j, (c, lc) in enumerate(table):
        assert (c * 512).is_integer() and 0.5 < c <= 4 / 3
        assert (c == 1.0) == (j in (0, 127)) and (lc == 0.0) == (c == 1.0)
        # every mantissa of bucket j (the upper end excluded), reduced,
        # gives |z c - 1| <= 2**-7
        lo = (1 + j / 128) / (2 if j >= 64 else 1)
        hi = (1 + (j + 1) / 128) / (2 if j >= 64 else 1)
        assert max(abs(lo * c - 1), abs(hi * c - 1)) <= 2.0**-7


def test_table_decode_equals_plain_rule_on_all_inputs():
    """The kernels' decode, in numpy, on all 2**24 inputs: the same float as
    ``fp32(-log(fp64(x)))``, so it may stand for the library log."""
    k = np.arange(1 << 24, dtype=np.uint32)
    for part in np.array_split(k, 8):
        x = part.astype(np.float32) * np.float32(2.0**-24) \
            + np.float32(2.0**-25)
        want = (-np.log(x.astype(np.float64))).astype(np.float32)
        got = ref.neg_log_emulated(x)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("L,B,at_once,blocks", [
    (10_000, 448, None, 1), (65_536, 448, 66, 2), (1 << 19, 28, 13, 10),
    (1 << 19, 16, 13, 10), (1 << 20, 28, 6, 22), (1 << 23, 14, 1, 132)])
def test_card_share_counts_split_launches(L, B, at_once, blocks,
                                          monkeypatch):
    """B1's launches on a split ring count K x B x blocks block-steps and
    K x waves x SMs SM-steps, the waves those of the rings the card holds
    at once (stubbed here: the CPU has no card); a one-block ring counts
    nothing and asks the card nothing."""
    monkeypatch.setattr(pdes_multistep, "rings_at_once",
                        lambda n: {L: at_once}[n])
    monkeypatch.setattr(pdes_multistep, "card_sms",
                        lambda dev: {"card": 132}[dev])
    monkeypatch.setattr(pdes_multistep, "block_chunks", 7)
    monkeypatch.setattr(pdes_multistep, "sm_chunks", 9)
    assert tiling.ring_plan(L).blocks == blocks
    pdes_multistep.count_card_share(B, L, 16, "card")
    pdes_multistep.count_card_share(B, L, 5, "card")
    if blocks == 1:
        assert (pdes_multistep.block_chunks, pdes_multistep.sm_chunks) == \
            (7, 9)
        return
    waves = -(-B // at_once)
    assert pdes_multistep.block_chunks == 7 + 21 * B * blocks
    assert pdes_multistep.sm_chunks == 9 + 21 * waves * 132
    if (L, B) == (1 << 19, 28):   # 3 waves of 13 rings of 10 blocks
        assert 21 * B * blocks / (21 * waves * 132) == 280 / 396
