"""The regularized OT value on any Geometry (forward only, for now).

The JAX package differentiates W_hat through the envelope theorem
(Prop. 3.2): the backward pass differentiates -eps u*^T K_theta v* at the
frozen fixed point, without backprop through the loop. That rule comes to
the port as a ``torch.autograd.Function`` with the training slice. Until
then every solve refuses an input that requires grad
(``NotImplementedError``), so no wrong gradient can be produced silently.
Counterpart of ``repro.core.grad.rot_geometry``.
"""
from __future__ import annotations

import torch

from .geometry import Geometry
from .sinkhorn import sinkhorn_log_geometry

__all__ = ["rot_geometry"]


def rot_geometry(geom: Geometry, a: torch.Tensor, b: torch.Tensor,
                 tol: float = 1e-6, max_iter: int = 2000, *, use_pallas=None,
                 inner_steps=None, check_every=None,
                 precision: str = "highest") -> torch.Tensor:
    """W_hat_{eps,c}(mu, nu), a 0-d tensor: the Eq.-6 dual value of the
    log-domain solve. The keywords are the forward solve's execution
    policy (see ``sinkhorn_log_geometry``)."""
    return sinkhorn_log_geometry(
        geom, a, b, tol=tol, max_iter=max_iter, use_pallas=use_pallas,
        inner_steps=inner_steps, check_every=check_every,
        precision=precision).cost
