"""A run with its timed path broken underneath comes out not correct, and
the control (the reference in bfloat16) fails the limits of every cell.

The faults each cell can have: a step that returns its state unchanged;
half of the batch left out, the mean taken over the rest; an answer
altered where it is produced.  (Every cell runs on one chip, so none has
an exchange between chips to leave out.)
"""
import math
import time

import numpy as np
import pytest

import repro_torch.core.measurement as measurement
import repro_torch.kernels.ops as ops
import repro_torch.kernels.pdes_multistep as pm
import repro_torch.service.api as api
from bench import calibrate, harness


def _unchanged_state(monkeypatch):
    b1, b2 = pm.pdes_multistep_counter, ops.step_haloed

    def b1_fault(tau, *a, **k):
        return tau, b1(tau, *a, **k)[1]

    def b2_fault(tau_h, *a, **k):
        return tau_h[:, 1:-1], b2(tau_h, *a, **k)[1]

    monkeypatch.setattr(pm, "pdes_multistep_counter", b1_fault)
    monkeypatch.setattr(ops, "step_haloed", b2_fault)


def _half_the_batch(monkeypatch):
    reduce = measurement.sweep_reduce

    def fault(stats, n_windows, replicas, **k):
        keep = max(1, replicas // 2)
        half = type(stats)(*(np.ascontiguousarray(
            a.reshape(a.shape[0], n_windows, replicas)[:, :, :keep]
            .reshape(a.shape[0], -1)) for a in stats))
        return reduce(half, n_windows, keep, **k)

    monkeypatch.setattr(measurement, "sweep_reduce", fault)


def _altered_answer(monkeypatch):
    records = api.records_from_reduction

    def fault(L, n_v, deltas, red):
        out = records(L, n_v, deltas, red)
        r = out[0]
        return [type(r)(**{**r.__dict__, "u": math.nextafter(r.u, 2.0)})
                ] + out[1:]

    monkeypatch.setattr(api, "records_from_reduction", fault)


FAULTS = {"unchanged_state": _unchanged_state,
          "half_the_batch": _half_the_batch,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("name", ["exact_mix.ring10k", "stale_mix.ring10k",
                                  "growth_mix.ring1m", "exact_mix.ring512k",
                                  "exact_mix.size_grid"])
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_path_is_not_correct(tiny_root, name, fault, monkeypatch,
                                      tmp_path):
    FAULTS[fault](monkeypatch)
    res = harness.run(tiny_root, name, 12345, 0.3, False, device="cpu",
                      out_dir=tmp_path, t_start=time.perf_counter())
    assert res["correct"] is False


@pytest.mark.parametrize("name", ["exact_mix.ring10k", "exact_mix.ring1m",
                                  "stale_mix.ring10k", "growth_mix.ring1m",
                                  "exact_mix.ring512k", "exact_mix.size_grid"])
def test_the_control_fails_every_cell(tiny_root, name):
    limits = harness.load_cell(tiny_root, name)["cell"]["limits"]
    for seed in (1, 2, 3):
        numbers = calibrate.control_numbers(tiny_root, name, seed, "cpu")
        assert all(numbers[k] > limits[k] for k in limits), numbers
