"""The dry run's trip-count-aware count against the full trace on a
``(2, 2)`` mesh of four fake ranks (``test_torch_scan_cost.py`` on one).

Under DTensor the first iteration of a loop may take its carry in another
placement than the later ones, which is why ``scan`` keeps the first, the
second (for all between) and the last of each kind of body; a train step
under each remat policy, whose rematerialised bodies run again inside the
backward, is held too.
"""
import pytest

from test_torch_scan_cost import assert_scaled_equals_full, run_cells


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_scaled_count_equals_full_trace_four_ranks(arch):
    assert_scaled_equals_full(run_cells(4, [arch]))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_scaled_count_under_remat(remat):
    assert_scaled_equals_full(run_cells(4, ["llama3.2-1b"], remat,
                                        kinds=("train",)))
