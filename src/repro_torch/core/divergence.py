"""Sinkhorn divergence (Eq. 2):

    Wbar(mu, nu) = W(mu, nu) - 1/2 W(mu, mu) - 1/2 W(nu, nu)

:func:`sinkhorn_divergence_geometry` works on any log-capable Geometry:
the geometry supplies the (mu, nu) kernel and its ``xx()``/``yy()``
self-geometries the two correction terms, so the divergence costs three
linear-time solves. Each term is a ``grad.rot_geometry`` call, so the
divergence is differentiable through the envelope theorem; ``xx()`` and
``yy()`` share the geometry's tensors, so their gradients add up with the
cross term's. :func:`sinkhorn_divergence_features` takes precomputed
features: in the log domain it is the geometry divergence, in scaling
space three ``grad.rot_factored`` terms (the scaling plan and its
closed-form envelope rule). :func:`sinkhorn_divergence_gaussian` builds
Lemma-1 features of two point clouds and takes either. The ``_batched``
variants take P problems stacked on a leading axis (the GAN minibatch of
the paper's Section 4): three batched solves, differentiable through the
batched envelope VJPs. Counterpart of ``repro.core.divergence``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .features import gaussian_log_features
from .geometry import FactoredPositive, Geometry
from .grad import (
    rot_factored,
    rot_factored_batched,
    rot_geometry,
    rot_log_factored_batched,
)

__all__ = [
    "sinkhorn_divergence_geometry",
    "sinkhorn_divergence_features",
    "sinkhorn_divergence_gaussian",
    "sinkhorn_divergence_features_batched",
    "sinkhorn_divergence_gaussian_batched",
]


def sinkhorn_divergence_geometry(geom: Geometry,
                                 a: Optional[torch.Tensor] = None,
                                 b: Optional[torch.Tensor] = None, *,
                                 tol: float = 1e-6, max_iter: int = 2000,
                                 mesh=None, mesh_axis: str = "data",
                                 use_pallas=None, inner_steps=None,
                                 check_every=None,
                                 precision: str = "highest") -> torch.Tensor:
    """Wbar on a log-capable Geometry with per-measure parametrization
    (factored and point-cloud families), a 0-d tensor, differentiable in
    the geometry's tensors and the weights. ``a``/``b`` default to uniform
    weights on the geometry's device.

    With ``mesh=`` (a ``DeviceMesh``) the three solves run sharded over
    ``mesh_axis`` on the all-reduced log operators
    (``core.sharded.sharded_sinkhorn_divergence``), differentiable in the
    same tensors, shared anchors included; the execution knobs do not
    apply there."""
    if mesh is not None:
        from .sharded import sharded_sinkhorn_divergence

        return sharded_sinkhorn_divergence(mesh, geom, a, b, axis=mesh_axis,
                                           tol=tol, max_iter=max_iter)
    n, m = geom.shape
    dev = geom.device
    a = torch.full((n,), 1.0 / n, device=dev) if a is None else a
    b = torch.full((m,), 1.0 / m, device=dev) if b is None else b
    kw = dict(use_pallas=use_pallas, inner_steps=inner_steps,
              check_every=check_every, precision=precision)
    w_xy = rot_geometry(geom, a, b, tol, max_iter, **kw)
    w_xx = rot_geometry(geom.xx(), a, a, tol, max_iter, **kw)
    w_yy = rot_geometry(geom.yy(), b, b, tol, max_iter, **kw)
    return w_xy - 0.5 * (w_xx + w_yy)


def sinkhorn_divergence_features(xi: torch.Tensor, zeta: torch.Tensor,
                                 a: torch.Tensor, b: torch.Tensor, *,
                                 eps: float, tol: float = 1e-6,
                                 max_iter: int = 2000,
                                 log_domain: bool = False) -> torch.Tensor:
    """Wbar from precomputed features ``xi`` (n, r) and ``zeta`` (m, r), or
    log-features with ``log_domain``; differentiable in all four tensors."""
    if log_domain:
        geom = FactoredPositive(log_xi=xi, log_zeta=zeta, eps=eps)
        return sinkhorn_divergence_geometry(geom, a, b, tol=tol,
                                            max_iter=max_iter)
    w_xy = rot_factored(xi, zeta, a, b, eps, tol, max_iter, 1.0)
    w_xx = rot_factored(xi, xi, a, a, eps, tol, max_iter, 1.0)
    w_yy = rot_factored(zeta, zeta, b, b, eps, tol, max_iter, 1.0)
    return w_xy - 0.5 * (w_xx + w_yy)


def sinkhorn_divergence_gaussian(x: torch.Tensor, y: torch.Tensor,
                                 anchors: torch.Tensor, *, eps: float,
                                 q: float, a: Optional[torch.Tensor] = None,
                                 b: Optional[torch.Tensor] = None,
                                 tol: float = 1e-6, max_iter: int = 2000,
                                 log_domain: bool = True) -> torch.Tensor:
    """Wbar between point clouds under Lemma-1 features, differentiable in
    ``x``, ``y`` and ``anchors`` (the learnable theta of Eq. 18). With
    ``log_domain=False`` the features are exponentiated and the scaling
    path runs."""
    n, m = x.shape[0], y.shape[0]
    a = torch.full((n,), 1.0 / n, device=x.device) if a is None else a
    b = torch.full((m,), 1.0 / m, device=y.device) if b is None else b
    lxi = gaussian_log_features(x, anchors, eps=eps, q=q)
    lzeta = gaussian_log_features(y, anchors, eps=eps, q=q)
    if log_domain:
        return sinkhorn_divergence_features(lxi, lzeta, a, b, eps=eps,
                                            tol=tol, max_iter=max_iter,
                                            log_domain=True)
    return sinkhorn_divergence_features(torch.exp(lxi), torch.exp(lzeta), a,
                                        b, eps=eps, tol=tol,
                                        max_iter=max_iter)


def sinkhorn_divergence_features_batched(xi: torch.Tensor, zeta: torch.Tensor,
                                         a: torch.Tensor, b: torch.Tensor, *,
                                         eps: float, tol: float = 1e-6,
                                         max_iter: int = 2000,
                                         log_domain: bool = False
                                         ) -> torch.Tensor:
    """Stacked Wbar, shape (P,), from (log-)features (P, n, r) / (P, m, r)
    and weights (P, n) / (P, m): three batched solves, differentiable in
    all four tensors."""
    if log_domain:
        def rot(p, q, w, z):
            return rot_log_factored_batched(p, q, w, z, eps, tol, max_iter)
    else:
        def rot(p, q, w, z):
            return rot_factored_batched(p, q, w, z, eps, tol, max_iter, 1.0)
    w_xy = rot(xi, zeta, a, b)
    w_xx = rot(xi, xi, a, a)
    w_yy = rot(zeta, zeta, b, b)
    return w_xy - 0.5 * (w_xx + w_yy)


def sinkhorn_divergence_gaussian_batched(x: torch.Tensor, y: torch.Tensor,
                                         anchors: torch.Tensor, *,
                                         eps: float, q: float,
                                         a: Optional[torch.Tensor] = None,
                                         b: Optional[torch.Tensor] = None,
                                         tol: float = 1e-6,
                                         max_iter: int = 2000,
                                         log_domain: bool = True
                                         ) -> torch.Tensor:
    """Batched Wbar, shape (P,), between per-problem clouds (P, n, d) /
    (P, m, d) under SHARED Lemma-1 anchors (r, d): the GAN objective of
    Eq. 18 over a minibatch, differentiable in ``x``, ``y`` and
    ``anchors``."""
    P, n, _ = x.shape
    m = y.shape[1]
    a = torch.full((P, n), 1.0 / n, device=x.device) if a is None else a
    b = torch.full((P, m), 1.0 / m, device=y.device) if b is None else b
    lxi = gaussian_log_features(x, anchors, eps=eps, q=q)
    lzeta = gaussian_log_features(y, anchors, eps=eps, q=q)
    if not log_domain:
        lxi, lzeta = torch.exp(lxi), torch.exp(lzeta)
    return sinkhorn_divergence_features_batched(
        lxi, lzeta, a, b, eps=eps, tol=tol, max_iter=max_iter,
        log_domain=log_domain)
