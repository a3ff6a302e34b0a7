"""Accelerated Sinkhorn (paper Remark 2 / Appendix A.2, after Guminov et
al.): accelerated alternating minimization on the smoothed dual

    F(f, g) = <f, a> + <g, b> - eps * log( e^{f/eps}^T K e^{g/eps} ).

Each iteration takes the EXACT alternating-minimization step on the block
with the larger gradient (a Sinkhorn half-step) plus a Nesterov
extrapolation, all on the geometry's exact log operators (the two-stage
LSE on factored kernels), so it composes with Lemma-1 features at small
eps. Convergence is the sum of BOTH marginal errors (an exact block step
zeroes one of them), which doubles the float32 noise floor of the
one-marginal solvers.

The gradients of -F are closed forms where the JAX package takes
``jax.grad``: with logZ = LSE_i(log(K e^{g/eps})_i + f_i/eps),

    grad_f = softmax(log(K e^{g/eps}) + f/eps) - a
    grad_g = exp(g/eps + log(K^T e^{f/eps}) - logZ) - b,

and the same two operator applications give the exact block steps, so an
iteration applies the log operators four times. The block choice is a
``torch.where`` on device scalars; the loop is the eager host loop
(``core.sinkhorn.run_marginal_loop``), which reads the error once every
``check_every`` iterations. :func:`accelerated_stacked` runs P problems
stacked on a leading axis (the batched engine), each lane with its own
block choice and stop (``core.sinkhorn.run_lane_loop``). Counterpart of
``repro.core.accelerated``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.ref import lse
from .geometry import FactoredPositive, Geometry
from .sinkhorn import (
    SinkhornResult,
    _check_inputs,
    _converged,
    lane_sum,
    masked_dual_value,
    run_lane_loop,
    run_marginal_loop,
)

__all__ = [
    "accelerated_sinkhorn_geometry",
    "accelerated_sinkhorn_log_factored",
    "accelerated_stacked",
]


def dual_gradients(log_kg: torch.Tensor, log_ktf: torch.Tensor,
                   f: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, eps: float):
    """``(grad_f, grad_g)`` of -F at ``(f, g)`` from ``log_kg`` =
    log(K e^{g/eps}) (n,) and ``log_ktf`` = log(K^T e^{f/eps}) (m,), a
    problem axis first where stacked."""
    row = log_kg + f / eps
    log_z = lse(row, dim=-1)[..., None]
    return torch.exp(row - log_z) - a, torch.exp(g / eps + log_ktf - log_z) - b


def accelerated_sinkhorn_log_factored(
        log_xi: torch.Tensor, log_zeta: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, *, eps: float, tol: float = 1e-6,
        max_iter: int = 2000, f_init: Optional[torch.Tensor] = None,
        g_init: Optional[torch.Tensor] = None) -> SinkhornResult:
    """AGM on explicit log-features (thin wrapper over
    :func:`accelerated_sinkhorn_geometry`)."""
    return accelerated_sinkhorn_geometry(
        FactoredPositive(log_xi=log_xi, log_zeta=log_zeta, eps=eps), a, b,
        tol=tol, max_iter=max_iter, f_init=f_init, g_init=g_init)


def accelerated_sinkhorn_geometry(
        geom: Geometry, a: torch.Tensor, b: torch.Tensor, *,
        tol: float = 1e-6, max_iter: int = 2000,
        f_init: Optional[torch.Tensor] = None,
        g_init: Optional[torch.Tensor] = None,
        check_every: int = 1) -> SinkhornResult:
    """Accelerated alternating minimization on any log-capable Geometry.
    The error is read once every ``check_every`` iterations, so
    ``n_iter`` is a multiple of it; a converged result has ``err <= tol``.
    The solve ends with one exact f-step, so the Eq.-6 dual value holds."""
    _check_inputs(geom, a, b, f_init, g_init)
    log_K, log_K_T = geom.log_operators()
    return _agm(log_K, log_K_T, a, b, eps=geom.eps, tol=tol,
                max_iter=max_iter, f_init=f_init, g_init=g_init,
                check_every=check_every)


def accelerated_stacked(log_K, log_K_T, a: torch.Tensor, b: torch.Tensor, *,
                        eps: float, tol=1e-6, max_iter: int = 2000,
                        f_init: Optional[torch.Tensor] = None,
                        g_init: Optional[torch.Tensor] = None,
                        check_every: int = 1) -> SinkhornResult:
    """AGM on P problems stacked on a leading axis: ``log_K`` /
    ``log_K_T`` map (P, m) / (P, n) potentials to their log operators,
    ``a``/``b`` are (P, n)/(P, m); ``tol`` is a float or one a lane. Each
    lane takes its own block choice and stops on its own, so its result is
    its own solve's; ``n_iter`` is an int64 tensor, one count a lane."""
    return _agm(log_K, log_K_T, a, b, eps=eps, tol=tol, max_iter=max_iter,
                f_init=f_init, g_init=g_init, check_every=check_every,
                lanes=a.shape[0])


def _agm(log_K, log_K_T, a, b, *, eps, tol, max_iter, f_init, g_init,
         check_every, lanes=None) -> SinkhornResult:
    check_every = int(check_every)
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    loga, logb = torch.log(a), torch.log(b)

    def step(carry):
        f, g, zf, zg, A = carry
        Ac = A[..., None]
        beta = Ac / (Ac + 1.0)
        yf = beta * f + (1 - beta) * zf
        yg = beta * g + (1 - beta) * zg
        log_kg, log_ktf = log_K(yg), log_K_T(yf)
        gf, gg = dual_gradients(log_kg, log_ktf, yf, yg, a, b, eps)
        # the block with the larger gradient takes its exact argmin
        use_f = (lane_sum(gf * gf) >= lane_sum(gg * gg))[..., None]
        f_new = torch.where(use_f, eps * (loga - log_kg), yf)
        g_new = torch.where(use_f, yg, eps * (logb - log_ktf))
        step_size = (Ac + 1.0) * eps / 2.0
        zf = zf - step_size * gf
        zg = zg - step_size * gg
        # both marginals: the block just stepped is feasible by construction
        log_col = log_K_T(f_new) + g_new / eps
        log_row = log_K(g_new) + f_new / eps
        err = (lane_sum(torch.abs(torch.exp(log_col) - b))
               + lane_sum(torch.abs(torch.exp(log_row) - a)))
        return (f_new, g_new, zf, zg, A + 1.0), err

    f0 = torch.zeros_like(a) if f_init is None else f_init
    g0 = torch.zeros_like(b) if g_init is None else g_init
    A0 = torch.ones(a.shape[:-1], dtype=a.dtype, device=a.device)
    kw = dict(tol=tol, max_iter=max_iter, steps_per_check=check_every)
    if lanes is None:
        it, (_, g, *_), err = run_marginal_loop(
            step, (f0, g0, f0, g0, A0), **kw)
    else:
        it, (_, g, *_), err = run_lane_loop(
            step, (f0, g0, f0, g0, A0), lanes=lanes, **kw)
        it = torch.tensor(it)
    f = eps * (loga - log_K(g))
    cost = masked_dual_value(a, b, f, g)
    u, v = torch.exp(f / eps), torch.exp(g / eps)
    return SinkhornResult(u, v, f, g, cost, it, err, _converged(err, tol))
