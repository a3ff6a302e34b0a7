"""Envelope-theorem differentiation of the ROT value (Prop. 3.2).

:func:`rot_factored` is the scaling-space rule for K = xi zeta^T: with
the scalings (u*, v*) frozen, dW/dxi = -eps u* (zeta^T v*)^T, dW/dzeta =
-eps v* (xi^T u*)^T, dW/da = eps log u* and dW/db = eps log v*. Its two
contractions run through the ``feature_contract`` kernel, as its forward
solve runs through the scaling plan; it needs no backward kernel (the JAX
package has none).

:func:`rot_geometry` is the generic log-domain rule. At the optimal
potentials (f*, g*) the dual value's only theta-dependent term is the
correlation, so for any kernel parametrization

    dW/dtheta = d/dtheta [ -eps * sum_i exp(f*_i/eps + log(K_theta e^{g*/eps})_i) ]
    dW/da = f*,   dW/db = g*

with the potentials frozen: the backward pass differentiates the
geometry's own log operator once, and never the Sinkhorn loop. Every term
of the sum is about a_i at the fixed point, so the expression is stable at
any eps. The backward is plain PyTorch in float32 at "highest", whatever
precision the forward solve ran at, as the JAX package computes it in XLA
outside any Pallas kernel. Counterpart of ``repro.core.grad``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.kermatvec import feature_contract
from ..kernels.ref import ieee_fp32
from .geometry import Geometry
from .sinkhorn import sinkhorn_factored, sinkhorn_log_geometry

__all__ = ["rot_factored", "rot_geometry"]


class _RotFactored(torch.autograd.Function):
    """W_hat for K = xi zeta^T with the closed-form envelope VJP."""

    @staticmethod
    def forward(ctx, xi, zeta, a, b, eps, tol, max_iter, momentum):
        with torch.no_grad():
            res = sinkhorn_factored(xi.detach(), zeta.detach(), a.detach(),
                                    b.detach(), eps=eps, tol=tol,
                                    max_iter=max_iter, momentum=momentum)
        ctx.eps = eps
        ctx.save_for_backward(xi, zeta, res.u, res.v)
        return res.cost

    @staticmethod
    def backward(ctx, ct):
        xi, zeta, u, v = ctx.saved_tensors
        eps = ctx.eps
        zv = feature_contract(zeta.detach().contiguous(), v[:, None])[:, 0]
        xu = feature_contract(xi.detach().contiguous(), u[:, None])[:, 0]
        g_xi = (-eps * ct) * (u[:, None] * zv[None, :])
        g_zeta = (-eps * ct) * (v[:, None] * xu[None, :])
        return (g_xi, g_zeta, ct * eps * torch.log(u),
                ct * eps * torch.log(v), None, None, None, None)


def rot_factored(xi: torch.Tensor, zeta: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, eps: float, tol: float = 1e-6,
                 max_iter: int = 2000, momentum: float = 1.0) -> torch.Tensor:
    """W_hat_{eps,c_theta}(mu, nu) for K = xi zeta^T, a 0-d tensor: the
    scaling-space solve's dual value, differentiable in all four tensors
    through the envelope theorem, with no backprop through the loop."""
    return _RotFactored.apply(xi, zeta, a, b, float(eps), tol, max_iter,
                              momentum)


def _tensor_fields(geom: Geometry):
    return [f.name for f in dataclasses.fields(geom)
            if isinstance(getattr(geom, f.name), torch.Tensor)]


class _RotGeometry(torch.autograd.Function):
    """W_hat with the envelope VJP. Inputs: the geometry (its tensors are
    re-supplied as ``leaves`` so autograd tracks them), the names of those
    fields, the solve's keywords, the weights and the leaves."""

    @staticmethod
    def forward(ctx, geom, names, solve_kw, a, b, *leaves):
        fresh = dataclasses.replace(
            geom, **{n: t.detach() for n, t in zip(names, leaves)})
        with torch.no_grad():
            res = sinkhorn_log_geometry(fresh, a.detach(), b.detach(),
                                        **solve_kw)
        ctx.geom, ctx.names = fresh, names
        ctx.save_for_backward(res.f, res.g)
        return res.cost

    @staticmethod
    def backward(ctx, ct):
        f, g = ctx.saved_tensors
        geom, names = ctx.geom, ctx.names
        eps = geom.eps
        grads = [None] * len(names)
        want = [i for i, need in enumerate(ctx.needs_input_grad[5:]) if need]
        if want:
            with torch.enable_grad(), ieee_fp32():
                leaves = {n: getattr(geom, n).detach().requires_grad_(True)
                          for n in names}
                gm = dataclasses.replace(geom, **leaves)
                # zero-weight atoms carry f = -inf and add exactly 0
                corr = -eps * torch.sum(torch.exp(f / eps + gm.log_apply_k(g)))
                got = torch.autograd.grad(
                    corr, [leaves[names[i]] for i in want], allow_unused=True)
            for i, gr in zip(want, got):
                grads[i] = (torch.zeros_like(leaves[names[i]]) if gr is None
                            else ct * gr)
        return (None, None, None, ct * f, ct * g, *grads)


def rot_geometry(geom: Geometry, a: torch.Tensor, b: torch.Tensor,
                 tol: float = 1e-6, max_iter: int = 2000, *, use_pallas=None,
                 inner_steps=None, check_every=None,
                 precision: str = "highest") -> torch.Tensor:
    """W_hat_{eps,c}(mu, nu), a 0-d tensor: the Eq.-6 dual value of the
    log-domain solve, differentiable in the geometry's tensors (supports,
    anchors, features) and in the weights through the envelope theorem,
    with no backprop through the loop. The keywords are the forward
    solve's execution policy (see ``sinkhorn_log_geometry``)."""
    names = _tensor_fields(geom)
    solve_kw = dict(tol=tol, max_iter=max_iter, use_pallas=use_pallas,
                    inner_steps=inner_steps, check_every=check_every,
                    precision=precision)
    return _RotGeometry.apply(geom, names, solve_kw, a, b,
                              *(getattr(geom, n) for n in names))
