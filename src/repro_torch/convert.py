"""Carry the JAX package's problem state into the port.

A JAX ``GaussianPointCloud`` / ``FactoredPositive`` / ``DenseCost`` /
``OTProblem`` holds a few arrays and scalars: ``x``, ``y``, ``anchors``,
``eps``, ``R``, ``(log_)xi``, ``(log_)zeta``, ``C``, ``a``, ``b``. Each
function here takes those as numpy arrays (``np.asarray`` of the JAX
arrays) and builds the port's object on ``device`` (default: the card), so
one set of arrays can be handed to both packages. :func:`mlp_stack` and
:func:`gan_params` carry the JAX OT-GAN example's parameters (lists of
``{"w": (d_in, d_out), "b": (d_out,)}`` layers) into the port's modules.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch

from .core.api import OTProblem
from .core.geometry import DenseCost, FactoredPositive, GaussianPointCloud
from .examples.ot_gan import MLP, OTGAN
from .kernels.backend import as_f32, resolve_device

__all__ = [
    "gaussian_point_cloud",
    "factored_positive",
    "dense_cost",
    "ot_problem",
    "mlp_stack",
    "gan_params",
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


def mlp_stack(params: Sequence[Mapping], *, device=None):
    """The port's :class:`~repro_torch.examples.ot_gan.MLP` holding a JAX
    layer list; the JAX layer is ``x @ w + b``, so ``weight = w.T``."""
    dev = resolve_device(device)
    ws = [as_f32(p["w"], dev) for p in params]
    dims = [ws[0].shape[0]] + [w.shape[1] for w in ws]
    mlp = MLP(dims, device=dev)
    with torch.no_grad():
        for lin, w, p in zip(mlp.layers, ws, params):
            lin.weight.copy_(w.T)
            lin.bias.copy_(as_f32(p["b"], dev))
    return mlp


def gan_params(params: Mapping, *, device=None):
    """The port's :class:`~repro_torch.examples.ot_gan.OTGAN` from the JAX
    example's ``{"gen", "emb", "anchors"}`` parameter dict."""
    dev = resolve_device(device)
    return OTGAN(mlp_stack(params["gen"], device=dev),
                 mlp_stack(params["emb"], device=dev),
                 as_f32(params["anchors"], dev))
