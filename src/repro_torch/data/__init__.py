"""Deterministic data pipeline (port of ``repro.data``)."""
from .pipeline import DataConfig, Prefetcher, make_batch  # noqa: F401
