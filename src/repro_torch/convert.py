"""Carry the JAX package's problem state into the port.

A JAX ``GaussianPointCloud`` / ``FactoredPositive`` / ``DenseCost`` /
``OTProblem`` holds a few arrays and scalars: ``x``, ``y``, ``anchors``,
``eps``, ``R``, ``(log_)xi``, ``(log_)zeta``, ``C``, ``a``, ``b``. Each
function here takes those as numpy arrays (``np.asarray`` of the JAX
arrays) and builds the port's object on ``device`` (default: the card), so
one set of arrays can be handed to both packages. :func:`mlp_stack` and
:func:`gan_params` carry the JAX OT-GAN example's parameters (lists of
``{"w": (d_in, d_out), "b": (d_out,)}`` layers) into the port's modules;
:func:`paged_factored` and :func:`streaming_distribution` carry a paged
geometry and a streaming store's state, slot for slot.
"""
from __future__ import annotations

from typing import Hashable, Mapping, Optional, Sequence

import numpy as np
import torch

from .core.api import OTProblem
from .core.geometry import DenseCost, FactoredPositive, GaussianPointCloud
from .core.paged import PagedFactored
from .examples.ot_gan import MLP, OTGAN
from .kernels.backend import as_f32, resolve_device
from .streaming import PagedFeatureStore, StreamingDistribution

__all__ = [
    "gaussian_point_cloud",
    "factored_positive",
    "dense_cost",
    "ot_problem",
    "mlp_stack",
    "gan_params",
    "paged_factored",
    "streaming_distribution",
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


def paged_factored(*, eps: float, page_live_x, page_live_y,
                   page_size: int = 64, xi=None, zeta=None, log_xi=None,
                   log_zeta=None, device=None) -> PagedFactored:
    """A :class:`PagedFactored` from numpy factors (one pair, linear or
    log) and the per-page live counts."""
    dev = resolve_device(device)

    def conv(arr):
        return None if arr is None else as_f32(arr, dev)

    def live(arr):
        return torch.as_tensor(np.asarray(arr), dtype=torch.int32,
                               device=dev).contiguous()

    return PagedFactored(xi=conv(xi), zeta=conv(zeta), log_xi=conv(log_xi),
                         log_zeta=conv(log_zeta),
                         page_live_x=live(page_live_x),
                         page_live_y=live(page_live_y),
                         page_size=int(page_size), eps=float(eps))


def streaming_distribution(feats, weights, live, slot_of: Mapping[
        Hashable, int], page_live, alloc_order: Sequence[int], *,
        page_size: int, eps: float, device=None) -> StreamingDistribution:
    """The port's :class:`StreamingDistribution` holding a JAX store's
    state slot for slot: its ``(capacity, rank)`` feature buffer, weights,
    live mask, ``_slot`` (id -> slot, in insertion order), ``page_live``
    and ``_alloc_order`` (pages in first-touch order). Nothing is on the
    device yet: the first flush uploads the whole buffer."""
    feats = np.asarray(feats, np.float32)
    capacity, rank = feats.shape
    store = PagedFeatureStore(rank, capacity, page_size=page_size,
                              device=device)
    store._feats = feats.copy()
    store._weights = np.asarray(weights, np.float32).copy()
    store._live = np.asarray(live, bool).copy()
    store._page_live = np.asarray(page_live, np.int32).copy()
    store._slot = dict(slot_of)
    store._alloc_order = [int(p) for p in alloc_order]
    return StreamingDistribution(store, eps=eps)
