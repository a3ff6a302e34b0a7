"""Hand-written Hopper kernels of the port, their wrappers and plans.

Each kernel wrapper launches its CUDA kernel for a CUDA tensor and runs its
plain PyTorch version (``ref``) for a CPU tensor, and counts its launches
in a plain integer attribute ``launches``: :func:`launch_counts` reads
them, :func:`reset_launch_counts` sets them to 0.
"""
from __future__ import annotations

from typing import Dict

from .feature_map import gaussian_feature_map
from .fused_loop import log_sinkhorn_block, sinkhorn_block
from .kermatvec import feature_contract, feature_matvec, sinkhorn_halfstep
from .logmatvec import log_feature_contract, log_halfstep, log_matvec
from .paged import paged_feature_contract, paged_feature_matvec, paged_halfstep

__all__ = [
    "KERNELS",
    "gaussian_feature_map",
    "feature_contract",
    "sinkhorn_halfstep",
    "feature_matvec",
    "sinkhorn_block",
    "log_feature_contract",
    "log_halfstep",
    "log_sinkhorn_block",
    "log_matvec",
    "paged_feature_contract",
    "paged_halfstep",
    "paged_feature_matvec",
    "launch_counts",
    "reset_launch_counts",
]

KERNELS = {
    "gaussian_feature_map": gaussian_feature_map,
    "feature_contract": feature_contract,
    "sinkhorn_halfstep": sinkhorn_halfstep,
    "feature_matvec": feature_matvec,
    "sinkhorn_block": sinkhorn_block,
    "log_feature_contract": log_feature_contract,
    "log_halfstep": log_halfstep,
    "log_sinkhorn_block": log_sinkhorn_block,
    "log_matvec": log_matvec,
    "paged_feature_contract": paged_feature_contract,
    "paged_halfstep": paged_halfstep,
    "paged_feature_matvec": paged_feature_matvec,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
