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
outside any Pallas kernel.

:func:`rot_factored_batched` and :func:`rot_log_factored_batched` take P
problems stacked on a leading axis: one batched solve on the fused plan
(every kernel launch serves all P) and the same closed-form envelope
rules, lane by lane, which the JAX package gets from ``vmap`` of its
``custom_vjp``; neither unrolls the loop. Counterpart of
``repro.core.grad``.
"""
from __future__ import annotations

import torch

from ..kernels.kermatvec import feature_contract
from ..kernels.ops import stacked_ops
from ..kernels.ref import ieee_fp32
from .geometry import Geometry
from .sinkhorn import (
    _solve_log_plan,
    _solve_scaling_plan,
    sinkhorn_factored,
    sinkhorn_log_geometry,
)

__all__ = ["rot_factored", "rot_geometry", "rot_factored_batched",
           "rot_log_factored_batched"]


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


class _RotGeometry(torch.autograd.Function):
    """W_hat with the envelope VJP. Inputs: the geometry (its tensors are
    re-supplied as ``leaves`` so autograd tracks them, those of tuple
    fields one by one), the paths of those tensors, the solve's keywords,
    the weights and the leaves."""

    @staticmethod
    def forward(ctx, geom, paths, solve_kw, a, b, *leaves):
        fresh = geom.with_tensors(paths, [t.detach() for t in leaves])
        with torch.no_grad():
            res = sinkhorn_log_geometry(fresh, a.detach(), b.detach(),
                                        **solve_kw)
        ctx.geom, ctx.paths = fresh, paths
        ctx.save_for_backward(res.f, res.g)
        return res.cost

    @staticmethod
    def backward(ctx, ct):
        f, g = ctx.saved_tensors
        geom, paths = ctx.geom, ctx.paths
        eps = geom.eps
        grads = [None] * len(paths)
        want = [i for i, need in enumerate(ctx.needs_input_grad[5:]) if need]
        if want:
            with torch.enable_grad(), ieee_fp32():
                leaves = [t.detach().requires_grad_(True)
                          for t in geom.tensors()]
                gm = geom.with_tensors(paths, leaves)
                # zero-weight atoms carry f = -inf and add exactly 0
                corr = -eps * torch.sum(torch.exp(f / eps + gm.log_apply_k(g)))
                got = torch.autograd.grad(
                    corr, [leaves[i] for i in want], allow_unused=True)
            for i, gr in zip(want, got):
                grads[i] = (torch.zeros_like(leaves[i]) if gr is None
                            else ct * gr)
        return (None, None, None, ct * f, ct * g, *grads)


def rot_geometry(geom: Geometry, a: torch.Tensor, b: torch.Tensor,
                 tol: float = 1e-6, max_iter: int = 2000, *, use_pallas=None,
                 inner_steps=None, check_every=None,
                 precision: str = "highest") -> torch.Tensor:
    """W_hat_{eps,c}(mu, nu), a 0-d tensor: the Eq.-6 dual value of the
    log-domain solve, differentiable in the geometry's tensors (supports,
    anchors, features, grid axes) and in the weights through the envelope theorem,
    with no backprop through the loop. The keywords are the forward
    solve's execution policy (see ``sinkhorn_log_geometry``)."""
    solve_kw = dict(tol=tol, max_iter=max_iter, use_pallas=use_pallas,
                    inner_steps=inner_steps, check_every=check_every,
                    precision=precision)
    return _RotGeometry.apply(geom, geom.tensor_paths(), solve_kw, a, b,
                              *geom.tensors())


def _stacked_solve(mode, p, q, a, b, eps, tol, max_iter, momentum=1.0):
    """One batched solve of P stacked problems on the fused plan of
    ``mode`` (factors ``p``/``q``, linear in scaling mode, log in log
    mode)."""
    spec = ({"kind": "factored", "xi": p, "zeta": q} if mode == "scaling"
            else {"kind": "log_factored", "log_xi": p, "log_zeta": q})
    plan = stacked_ops(spec, problems=p.shape[0], eps=eps, mode=mode)
    kw = dict(eps=eps, tol=tol, max_iter=max_iter, momentum=momentum)
    if mode == "scaling":
        return _solve_scaling_plan(plan, a, b, u_init=None, **kw)
    return _solve_log_plan(plan, a, b, f_init=None, g_init=None, **kw)


def _detached(*tensors):
    return tuple(t.detach().contiguous() for t in tensors)


class _RotFactoredBatched(torch.autograd.Function):
    """Stacked W_hat for K_p = xi_p zeta_p^T with the closed-form envelope
    VJP of :class:`_RotFactored`, lane by lane."""

    @staticmethod
    def forward(ctx, xi, zeta, a, b, eps, tol, max_iter, momentum):
        with torch.no_grad():
            res = _stacked_solve("scaling", *_detached(xi, zeta, a, b), eps,
                                 tol, max_iter, momentum)
        ctx.eps = eps
        ctx.save_for_backward(xi, zeta, res.u, res.v)
        return res.cost

    @staticmethod
    def backward(ctx, ct):
        xi, zeta, u, v = ctx.saved_tensors
        eps = ctx.eps
        zv = feature_contract(zeta.detach().contiguous(),
                              v[..., None].contiguous())[..., 0]
        xu = feature_contract(xi.detach().contiguous(),
                              u[..., None].contiguous())[..., 0]
        c = (-eps * ct)[:, None, None]
        g_xi = c * (u[..., None] * zv[:, None, :])
        g_zeta = c * (v[..., None] * xu[:, None, :])
        return (g_xi, g_zeta, ct[:, None] * eps * torch.log(u),
                ct[:, None] * eps * torch.log(v), None, None, None, None)


def rot_factored_batched(xi: torch.Tensor, zeta: torch.Tensor,
                         a: torch.Tensor, b: torch.Tensor, eps: float,
                         tol: float = 1e-6, max_iter: int = 2000,
                         momentum: float = 1.0) -> torch.Tensor:
    """Stacked W_hat over a leading problem axis: (P, n, r), (P, m, r),
    (P, n), (P, m) -> (P,), differentiable in all four tensors through the
    envelope theorem."""
    return _RotFactoredBatched.apply(xi, zeta, a, b, float(eps), tol,
                                     max_iter, momentum)


class _RotLogFactoredBatched(torch.autograd.Function):
    """Stacked W_hat on log-factors with the closed-form log-domain
    envelope VJP: with the potentials frozen, dW/dlogXi = -eps (u Xi) .*
    (Zeta^T v), formed in log space with each problem's own max shift."""

    @staticmethod
    def forward(ctx, log_xi, log_zeta, a, b, eps, tol, max_iter):
        with torch.no_grad():
            res = _stacked_solve("log", *_detached(log_xi, log_zeta, a, b),
                                 eps, tol, max_iter)
        ctx.eps = eps
        ctx.save_for_backward(log_xi, log_zeta, res.f, res.g)
        return res.cost

    @staticmethod
    def backward(ctx, ct):
        log_xi, log_zeta, f, g = ctx.saved_tensors
        eps = ctx.eps
        lu_xi = f[..., None] / eps + log_xi.detach().float()   # log(u_i Xi_ik)
        lv_zeta = g[..., None] / eps + log_zeta.detach().float()
        m1 = torch.amax(lu_xi, dim=(-2, -1), keepdim=True)
        m2 = torch.amax(lv_zeta, dim=(-2, -1), keepdim=True)
        A = torch.exp(lu_xi - m1)                            # (P, n, r)
        Bm = torch.exp(lv_zeta - m2)                         # (P, m, r)
        sB = torch.sum(Bm, dim=-2, keepdim=True)             # (P, 1, r)
        sA = torch.sum(A, dim=-2, keepdim=True)
        scale = -eps * ct[:, None, None] * torch.exp(m1 + m2)
        return (scale * A * sB, scale * Bm * sA, ct[:, None] * f,
                ct[:, None] * g, None, None, None)


def rot_log_factored_batched(log_xi: torch.Tensor, log_zeta: torch.Tensor,
                             a: torch.Tensor, b: torch.Tensor, eps: float,
                             tol: float = 1e-6,
                             max_iter: int = 2000) -> torch.Tensor:
    """Log-domain twin of :func:`rot_factored_batched` (small-eps safe):
    (P, n, r), (P, m, r) log-factors -> (P,)."""
    return _RotLogFactoredBatched.apply(log_xi, log_zeta, a, b, float(eps),
                                        tol, max_iter)
