"""Sinkhorn divergence (Eq. 2) on any Geometry:

    Wbar(mu, nu) = W(mu, nu) - 1/2 W(mu, mu) - 1/2 W(nu, nu)

The geometry supplies the (mu, nu) kernel and its ``xx()``/``yy()``
self-geometries the two correction terms, so the divergence costs three
linear-time solves. Each term is a ``grad.rot_geometry`` call, so the
divergence is differentiable through the envelope theorem; ``xx()`` and
``yy()`` share the geometry's tensors, so their gradients add up with the
cross term's. Counterpart of
``repro.core.divergence.sinkhorn_divergence_geometry``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .geometry import Geometry
from .grad import rot_geometry

__all__ = ["sinkhorn_divergence_geometry"]


def sinkhorn_divergence_geometry(geom: Geometry,
                                 a: Optional[torch.Tensor] = None,
                                 b: Optional[torch.Tensor] = None, *,
                                 tol: float = 1e-6, max_iter: int = 2000,
                                 use_pallas=None, inner_steps=None,
                                 check_every=None,
                                 precision: str = "highest") -> torch.Tensor:
    """Wbar on a log-capable Geometry with per-measure parametrization
    (factored and point-cloud families), a 0-d tensor, differentiable in
    the geometry's tensors and the weights. ``a``/``b`` default to uniform
    weights on the geometry's device."""
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
