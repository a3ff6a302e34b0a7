"""Wasserstein barycenters through kernel geometries (paper Fig. 6 / App C).

Iterative Bregman projections [Benamou et al. '15] in the log domain,
every kernel application through a symmetric
:class:`~repro_torch.core.geometry.Geometry` on the COMMON support: O(r n)
for factored kernels, one small contraction an axis for
:class:`~repro_torch.core.geometry.GridSeparable`. The k input histograms
go through the geometry's log operator as one (k, n) batch (the JAX
package vmaps over them). The loop is the solvers' eager host loop
(``core.sinkhorn.run_marginal_loop``), reading the barycenter's L1 change
once an iteration. Counterpart of ``repro.core.barycenter``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..kernels.ref import lse
from .geometry import FactoredPositive, Geometry
from .sinkhorn import _f32, run_marginal_loop

__all__ = [
    "BarycenterResult",
    "barycenter_geometry",
    "barycenter_log_factored",
]


class BarycenterResult(NamedTuple):
    weights: torch.Tensor       # (n,) the barycenter histogram
    n_iter: int
    err: torch.Tensor           # L1 change of the barycenter, last iteration
    converged: torch.Tensor


def barycenter_geometry(geom: Geometry, hists: torch.Tensor, *,
                        weights: Optional[torch.Tensor] = None,
                        tol: float = 1e-7,
                        max_iter: int = 500) -> BarycenterResult:
    """Bregman-projection barycenter of ``hists`` (k, n) with barycentric
    ``weights`` (k,) (uniform by default) on a symmetric, log-capable
    ``geom`` (n == m). Histogram entries are floored at 1e-38 before the
    log; each iteration normalizes the barycenter by its LSE and stops
    when its L1 change is at most ``tol``, not finite, or ``max_iter``
    is reached."""
    n_g, m_g = geom.shape
    if n_g != m_g:
        raise ValueError(
            "barycenter needs a symmetric geometry on one common support; "
            f"got shape {(n_g, m_g)}")
    k, n = hists.shape
    if n != n_g:
        raise ValueError(
            f"histograms live on {n} atoms but the geometry has {n_g}")
    eps = geom.eps
    lam = torch.full((k,), 1.0 / k, dtype=hists.dtype, device=hists.device) \
        if weights is None else weights
    log_hists = torch.log(torch.clamp(hists, min=1e-38))
    log_matvec = geom.log_operators()[0]

    def log_K(s):
        """log(K e^{s}) for the (k, n) stacked log-scalings (the operator
        takes potentials and divides by eps)."""
        return log_matvec(eps * s)

    def step(carry):
        lf, logb_prev = carry
        lg = log_hists - log_K(lf)                  # column projections
        lKg = log_K(lg)
        logb = torch.sum(lam[:, None] * (lKg + lf), dim=0)
        logb = logb - lse(logb, dim=0)              # normalize
        err = torch.sum(torch.abs(torch.exp(logb) - torch.exp(logb_prev)))
        return (logb[None, :] - lKg, logb), err

    lf = torch.zeros((k, n), dtype=hists.dtype, device=hists.device)
    logb = torch.full((n,), -math.log(n), dtype=hists.dtype,
                      device=hists.device)
    it, (_, logb), err = run_marginal_loop(step, (lf, logb), tol=tol,
                                           max_iter=max_iter)
    return BarycenterResult(torch.exp(logb), it, err, err <= _f32(tol))


def barycenter_log_factored(log_xi: torch.Tensor, hists: torch.Tensor, *,
                            eps: float,
                            weights: Optional[torch.Tensor] = None,
                            tol: float = 1e-7,
                            max_iter: int = 500) -> BarycenterResult:
    """Barycenter on K = Xi Xi^T from one (n, r) log-feature matrix of the
    common support (thin wrapper over :func:`barycenter_geometry`)."""
    geom = FactoredPositive(log_xi=log_xi, log_zeta=log_xi, eps=eps)
    return barycenter_geometry(geom, hists, weights=weights, tol=tol,
                               max_iter=max_iter)
