"""Batched window-sweep experiments of the port (``sweep``)."""
from .sweep import (SweepRecord, SweepResult, WindowSweep, run_window_sweep,
                    serial_window_sweep, spec_from_dict, spec_to_dict)

__all__ = ["SweepRecord", "SweepResult", "WindowSweep", "run_window_sweep",
           "serial_window_sweep", "spec_from_dict", "spec_to_dict"]
