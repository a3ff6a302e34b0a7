"""Solver core of the port: features, geometries, Sinkhorn, front end."""
from __future__ import annotations

from .accelerated import (
    accelerated_sinkhorn_geometry,
    accelerated_sinkhorn_log_factored,
)
from .api import (
    METHODS,
    PORTED_METHODS,
    AnnealedResult,
    EpsSchedule,
    OTProblem,
    solve,
    solve_annealed,
)
from .barycenter import (
    BarycenterResult,
    barycenter_geometry,
    barycenter_log_factored,
)
from .divergence import (
    sinkhorn_divergence_features,
    sinkhorn_divergence_gaussian,
    sinkhorn_divergence_geometry,
)
from .features import (
    ArcCosineFeatureMap,
    GaussianFeatureMap,
    arccos_features,
    gaussian_features,
    gaussian_log_features,
    gaussian_q,
    lambert_w0,
)
from .geometry import (
    ArcCosinePointCloud,
    DenseCost,
    FactoredPositive,
    GaussianPointCloud,
    Geometry,
    GridSeparable,
    NystromLowRank,
    as_geometry,
    data_radius,
    gibbs_kernel,
    neglog_kernel_cost,
    squared_euclidean,
)
from .grad import rot_factored, rot_geometry
from .nystrom import NystromFactors, nystrom_factors, sinkhorn_nystrom
from .objective import ExecutionPolicy, OTObjective
from .paged import PagedFactored
from .sinkhorn import (
    SinkhornResult,
    sinkhorn_factored,
    sinkhorn_geometry,
    sinkhorn_log_factored,
    sinkhorn_log_geometry,
    sinkhorn_log_quadratic,
    sinkhorn_quadratic,
)

__all__ = [
    "METHODS",
    "PORTED_METHODS",
    "AnnealedResult",
    "EpsSchedule",
    "OTProblem",
    "solve",
    "solve_annealed",
    "accelerated_sinkhorn_geometry",
    "accelerated_sinkhorn_log_factored",
    "BarycenterResult",
    "barycenter_geometry",
    "barycenter_log_factored",
    "sinkhorn_divergence_geometry",
    "sinkhorn_divergence_features",
    "sinkhorn_divergence_gaussian",
    "ArcCosineFeatureMap",
    "GaussianFeatureMap",
    "arccos_features",
    "gaussian_features",
    "gaussian_log_features",
    "gaussian_q",
    "lambert_w0",
    "ArcCosinePointCloud",
    "DenseCost",
    "FactoredPositive",
    "GaussianPointCloud",
    "Geometry",
    "GridSeparable",
    "NystromLowRank",
    "as_geometry",
    "data_radius",
    "gibbs_kernel",
    "neglog_kernel_cost",
    "squared_euclidean",
    "rot_factored",
    "rot_geometry",
    "NystromFactors",
    "nystrom_factors",
    "sinkhorn_nystrom",
    "ExecutionPolicy",
    "OTObjective",
    "PagedFactored",
    "SinkhornResult",
    "sinkhorn_geometry",
    "sinkhorn_factored",
    "sinkhorn_quadratic",
    "sinkhorn_log_geometry",
    "sinkhorn_log_factored",
    "sinkhorn_log_quadratic",
]
