"""The port's copies of ``theory`` and ``scaling`` against ``repro``'s.

Both are numpy only, so the same inputs must give the same numbers: every
result is compared exactly (``assert_array_equal``, NaN in the same
places), no tolerance.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro.core import scaling as jscaling
from repro.core import theory as jtheory
from repro_torch.core import scaling, theory

DELTAS = np.array([0.0, 1e-12, 0.5, 1.0, 4.0, 16.0, 100.0, np.inf, np.nan,
                   -1.0])
N_VS = np.array([1.0, 2.0, 3.0, 10.0, 50.0, 100.0, 1000.0])


@pytest.mark.parametrize("name,args", [
    ("u_rd", (DELTAS,)),
    ("u_kpz", (N_VS,)),
    ("p_exponent", (DELTAS,)),
    ("p_exponent", (DELTAS[:, None], N_VS[None, :])),
    ("u_composite", (N_VS[:, None], DELTAS[None, :8])),
    ("u_kpz_mean_field", (N_VS[2:], 1.7, 0.4)),
    ("u_window_mean_field", (N_VS[2:], 1.7, 0.4, 1.2, 0.3)),
    ("krug_meakin_u", (np.array([10.0, 100.0, 1000.0]),)),
    ("kpz_crossover_time", (np.array([10.0, 100.0, 1000.0]),)),
])
@pytest.mark.parametrize("four_point", [True, False])
def test_theory_matches_repro(name, args, four_point):
    kw = {"four_point": four_point} if name in (
        "u_rd", "u_kpz", "u_composite") else {}
    np.testing.assert_array_equal(getattr(theory, name)(*args, **kw),
                                  getattr(jtheory, name)(*args, **kw))


def test_theory_constants_match_repro():
    for name in ("U_INF_KPZ_NV1", "KPZ_ALPHA", "KPZ_BETA", "RD_BETA"):
        assert getattr(theory, name) == getattr(jtheory, name)


def _series(seed):
    rng = np.random.default_rng(seed)
    Ls = np.array([16, 32, 64, 128, 256, 512], np.float64)
    uLs = theory.krug_meakin_u(Ls) + rng.normal(0, 1e-4, Ls.size)
    t = np.arange(1, 801, dtype=np.float64)
    w2 = np.minimum(t, 300.0) ** (2 / 3) * (1 + rng.normal(0, 0.01, t.size))
    return Ls, uLs, t, w2


@pytest.mark.parametrize("seed", [0, 1])
def test_scaling_matches_repro(seed):
    Ls, uLs, t, w2 = _series(seed)
    for name in ("krug_meakin_extrapolate", "rational_extrapolate"):
        got = dataclasses.asdict(getattr(scaling, name)(Ls, uLs))
        want = dataclasses.asdict(getattr(jscaling, name)(Ls, uLs))
        assert got == want, name
    assert scaling.fit_power_law(t, w2, t_min=5, t_max=200) == \
        jscaling.fit_power_law(t, w2, t_min=5, t_max=200)
    assert scaling.growth_exponent(t, w2) == jscaling.growth_exponent(t, w2)
    assert scaling.roughness_exponent(Ls, uLs) == \
        jscaling.roughness_exponent(Ls, uLs)
    assert scaling.saturation_width(w2) == jscaling.saturation_width(w2)
    assert math.isfinite(scaling.saturation_width(w2))
