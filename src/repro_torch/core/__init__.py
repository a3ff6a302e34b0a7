"""Solver core of the port: features, geometries, Sinkhorn, front end."""
from __future__ import annotations

from .api import (
    METHODS,
    PORTED_METHODS,
    AnnealedResult,
    EpsSchedule,
    OTProblem,
    solve,
    solve_annealed,
)
from .divergence import (
    sinkhorn_divergence_features,
    sinkhorn_divergence_gaussian,
    sinkhorn_divergence_geometry,
)
from .features import (
    GaussianFeatureMap,
    gaussian_features,
    gaussian_log_features,
    gaussian_q,
    lambert_w0,
)
from .geometry import (
    DenseCost,
    FactoredPositive,
    GaussianPointCloud,
    Geometry,
    data_radius,
    squared_euclidean,
)
from .grad import rot_factored, rot_geometry
from .objective import ExecutionPolicy, OTObjective
from .paged import PagedFactored
from .sinkhorn import (
    SinkhornResult,
    sinkhorn_factored,
    sinkhorn_geometry,
    sinkhorn_log_geometry,
)

__all__ = [
    "METHODS",
    "PORTED_METHODS",
    "AnnealedResult",
    "EpsSchedule",
    "OTProblem",
    "solve",
    "solve_annealed",
    "sinkhorn_divergence_geometry",
    "sinkhorn_divergence_features",
    "sinkhorn_divergence_gaussian",
    "GaussianFeatureMap",
    "gaussian_features",
    "gaussian_log_features",
    "gaussian_q",
    "lambert_w0",
    "DenseCost",
    "FactoredPositive",
    "GaussianPointCloud",
    "Geometry",
    "data_radius",
    "squared_euclidean",
    "rot_factored",
    "rot_geometry",
    "ExecutionPolicy",
    "OTObjective",
    "PagedFactored",
    "SinkhornResult",
    "sinkhorn_geometry",
    "sinkhorn_factored",
    "sinkhorn_log_geometry",
]
