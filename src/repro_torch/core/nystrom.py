"""Nystrom low-rank baseline (the paper's ``Nys``, Altschuler et al. '18).

K_tilde = K[:, S] K[S, S]^+ K[S, :] with S a set of l landmark columns.
Applying K_tilde costs O(n l), as the positive-feature path does, but its
entries can be NEGATIVE, so the Sinkhorn scalings can cross zero and the
iteration diverges at small eps (paper Figs. 1/3/5); a solve reports that
as ``SinkhornResult.diverged``. The representation is
:class:`repro_torch.core.geometry.NystromLowRank` (``solve(problem,
method="nystrom")``); this module is its thin wrapper. Counterpart of
``repro.core.nystrom``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import NystromLowRank
from .sinkhorn import SinkhornResult, sinkhorn_geometry

__all__ = ["NystromFactors", "nystrom_factors", "sinkhorn_nystrom"]


class NystromFactors(NamedTuple):
    """K_tilde = L @ Rt with L (n, l), Rt (l, m)."""

    L: torch.Tensor
    Rt: torch.Tensor


def nystrom_factors(x: torch.Tensor, y: torch.Tensor, *, eps: float,
                    rank: int, generator: torch.Generator,
                    ridge: float = 1e-10) -> NystromFactors:
    """Landmark-Nystrom factorization of the Gibbs kernel exp(-C/eps),
    landmarks drawn by ``generator`` (a CPU generator)."""
    geom = NystromLowRank.from_point_clouds(x, y, eps=eps, rank=rank,
                                            generator=generator, ridge=ridge)
    return NystromFactors(L=geom.L, Rt=geom.Rt)


def sinkhorn_nystrom(factors: NystromFactors, a: torch.Tensor,
                     b: torch.Tensor, *, eps: float, tol: float = 1e-6,
                     max_iter: int = 2000) -> SinkhornResult:
    """Sinkhorn on the (possibly signed) Nystrom kernel. A blow-up shows
    as a non-finite marginal error: ``converged`` False, ``diverged``
    True, the method's documented failure (paper Fig. 1)."""
    geom = NystromLowRank(L=factors.L, Rt=factors.Rt, eps=eps)
    return sinkhorn_geometry(geom, a, b, tol=tol, max_iter=max_iter)
