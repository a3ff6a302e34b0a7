"""Deterministic synthetic data of the port: the LM token streams, their
pipeline, and the paper's point clouds. Counterpart of ``repro.data``."""
from __future__ import annotations

from .pipeline import DataConfig, DataPipeline
from .synthetic import (
    gaussian_clouds,
    highdim_clouds,
    lm_batch,
    sphere_clouds,
    token_batch,
)

__all__ = [
    "DataConfig",
    "DataPipeline",
    "gaussian_clouds",
    "highdim_clouds",
    "lm_batch",
    "sphere_clouds",
    "token_batch",
]
