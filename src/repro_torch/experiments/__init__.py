"""Experiment layer of the port: batched window sweeps (``sweep``) and the
optimal window width Δ* (``optimal_window``)."""
from .optimal_window import (OptimalWindow, RefinedWindow, efficiency,
                             find_optimal_window, optimal_windows,
                             refine_optimal_window)
from .sweep import (SweepRecord, SweepResult, WindowSweep, run_window_sweep,
                    serial_window_sweep, spec_from_dict, spec_to_dict)

__all__ = ["OptimalWindow", "RefinedWindow", "SweepRecord", "SweepResult",
           "WindowSweep", "efficiency", "find_optimal_window",
           "optimal_windows", "refine_optimal_window", "run_window_sweep",
           "serial_window_sweep", "spec_from_dict", "spec_to_dict"]
