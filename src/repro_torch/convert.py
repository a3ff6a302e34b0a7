"""Carry the JAX package's problem state into the port.

A JAX ``GaussianPointCloud`` / ``FactoredPositive`` / ``DenseCost`` /
``OTProblem`` holds a few arrays and scalars: ``x``, ``y``, ``anchors``,
``eps``, ``R``, ``(log_)xi``, ``(log_)zeta``, ``C``, ``a``, ``b``. Each
function here takes those as numpy arrays (``np.asarray`` of the JAX
arrays) and builds the port's object on ``device`` (default: the card), so
one set of arrays can be handed to both packages.
"""
from __future__ import annotations

from typing import Optional

from .core.api import OTProblem
from .core.geometry import DenseCost, FactoredPositive, GaussianPointCloud
from .kernels.backend import as_f32, resolve_device

__all__ = [
    "gaussian_point_cloud",
    "factored_positive",
    "dense_cost",
    "ot_problem",
]


def gaussian_point_cloud(x, y, anchors, *, eps: float,
                         R: Optional[float] = None,
                         device=None) -> GaussianPointCloud:
    dev = resolve_device(device)
    return GaussianPointCloud.build(as_f32(x, dev), as_f32(y, dev),
                                    as_f32(anchors, dev), eps=eps, R=R)


def factored_positive(*, eps: float, xi=None, zeta=None, log_xi=None,
                      log_zeta=None, device=None) -> FactoredPositive:
    dev = resolve_device(device)

    def conv(arr):
        return None if arr is None else as_f32(arr, dev)

    return FactoredPositive(xi=conv(xi), zeta=conv(zeta), log_xi=conv(log_xi),
                            log_zeta=conv(log_zeta), eps=float(eps))


def dense_cost(C, *, eps: float, device=None) -> DenseCost:
    return DenseCost(as_f32(C, resolve_device(device)), float(eps))


def ot_problem(geometry, a=None, b=None, *, device=None) -> OTProblem:
    """An :class:`OTProblem` on ``geometry`` (a port geometry already on
    ``device``) with weights ``a``/``b`` (uniform when ``None``)."""
    return OTProblem.from_geometry(geometry, a, b, device=device)
