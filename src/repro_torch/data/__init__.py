"""Deterministic synthetic data of the port: the paper's point clouds."""
from __future__ import annotations

from .synthetic import gaussian_clouds, highdim_clouds, sphere_clouds

__all__ = ["gaussian_clouds", "sphere_clouds", "highdim_clouds"]
