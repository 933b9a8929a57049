"""What the CPU can check of the multistep kernels' design (B1, B3).

The kernels themselves run only on a card (``tests/test_torch_cuda.py``);
here are the pieces of them that are plain arithmetic: the launch shape
that ``kernels/tiling.py`` picks from L, the division-free site pick and
the table-driven η decode, each repeated in Python the way the kernels
compute them and held against ``%`` and the plain decode rule.
"""
import re

import numpy as np
import pytest

from repro_torch.kernels import _build, ref, tiling

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
