"""Sinkhorn solvers on any Geometry: scaling space and log domain.

Algorithm 1 of the paper, generic in the kernel operator:

    repeat:  v <- b / K^T u ;  u <- a / K v
    until || v . (K^T u) - b ||_1 < tol

In the log domain the iterates are the potentials (f, g) = eps (log u,
log v) and the factored kernel applies through the exact two-stage LSE.
``use_pallas`` picks the fused plan of ``kernels.ops`` (the hand-written
CUDA kernels on the card, their plain versions on the CPU) or, with
``False``, the geometry's plain torch operators. Every solver ends on a
u-update, so the Eq.-6 dual value is  a . f + b . g  with zero-weight atoms
masked. Counterpart of ``repro.core.sinkhorn``.

:func:`run_marginal_loop` is a host loop: PyTorch runs eagerly, so the
marginal error is read to the host once per check block (one device
synchronisation per check). With the fused plan on the card the auto
cadence runs 8 iterations per launch of the megakernel
(``kernels.fused_loop``: ``sinkhorn_block`` in scaling space,
``log_sinkhorn_block`` in the log domain) wherever it is admitted, as the
JAX package does on a compiled backend; on the CPU it checks every
iteration, as the JAX package does in interpret mode.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..kernels.ops import (
    check_precision,
    geometry_ops,
    notify_plan_selected,
    relax_log,
    relax_scaling,
)
from .geometry import FactoredPositive, Geometry, _masked_log

__all__ = [
    "SinkhornResult",
    "masked_dual_value",
    "make_scaling_step",
    "make_log_step",
    "run_marginal_loop",
    "sinkhorn_operator",
    "sinkhorn_geometry",
    "sinkhorn_factored",
    "sinkhorn_log_geometry",
]


class SinkhornResult(NamedTuple):
    """Solver output. ``u``/``v`` are scalings; ``f``/``g`` potentials."""

    u: torch.Tensor
    v: torch.Tensor
    f: torch.Tensor             # eps * log u
    g: torch.Tensor             # eps * log v
    cost: torch.Tensor          # W_hat = a.f + b.g   (Eq. 6), 0-d
    n_iter: int
    marginal_err: torch.Tensor  # 0-d
    converged: torch.Tensor     # 0-d bool

    @property
    def diverged(self) -> torch.Tensor:
        """The iteration blew up (non-finite marginal error or dual value)
        rather than merely not converging yet."""
        return ~(torch.isfinite(self.marginal_err) & torch.isfinite(self.cost))


def _f32(x: float) -> float:
    """``x`` rounded to float32: the solvers compare float32 errors."""
    return float(torch.tensor(x, dtype=torch.float32))


def _check_inputs(geom: Geometry, *tensors: torch.Tensor) -> None:
    """Forward solves only: a differentiable input would let autograd trace
    the whole loop and return a gradient that is not the envelope-theorem
    one, so it is refused, as the JAX package cannot reverse-differentiate
    its while_loop either. Gradients go through ``core.grad.rot_geometry``
    (the envelope VJP), e.g. ``sinkhorn_divergence_geometry``."""
    for t in (*geom.tensors(), *(t for t in tensors if t is not None)):
        if t.requires_grad:
            raise NotImplementedError(
                "gradients of a solve are not taken through the loop: "
                "differentiate rot_geometry / sinkhorn_divergence_geometry "
                "(the envelope-theorem VJP), or pass tensors that do not "
                "require grad")
        if t.device != geom.device:
            raise ValueError(f"input on {t.device}, geometry on "
                             f"{geom.device}")


def masked_dual_value(a, b, f, g):
    """W_hat = <a, f> + <b, g> with zero-weight atoms excluded (their
    potentials are -inf, and 0 * -inf would be NaN)."""
    ta = torch.sum(torch.where(a > 0, a * f, torch.zeros_like(f)))
    tb = torch.sum(torch.where(b > 0, b * g, torch.zeros_like(g)))
    return ta + tb


def make_scaling_step(matvec, rmatvec, a, b, *, momentum: float = 1.0):
    """One full Alg.-1 iteration in scaling space:
    ``step((u, v, s)) -> ((u', v', s'), err)`` with ``s = K^T u`` carried.
    Dead (zero-mass) atoms are pinned to scaling 0, so a 0/0 under a dead
    slot never rides the next matvec into the live lanes."""
    zero_b, zero_a = torch.zeros_like(b), torch.zeros_like(a)

    def step(carry):
        u, v, s = carry
        v_new = relax_scaling(torch.where(b > 0, b / s, zero_b), v, momentum)
        u_new = relax_scaling(
            torch.where(a > 0, a / matvec(v_new), zero_a), u, momentum)
        s_new = rmatvec(u_new)
        err = torch.sum(torch.abs(v_new * s_new - b))
        return (u_new, v_new, s_new), err

    return step


def make_log_step(log_matvec, log_rmatvec, a, b, *, eps: float,
                  momentum: float = 1.0):
    """One full log-domain iteration: ``step((f, g)) -> ((f', g'), err)``."""
    loga, logb = _masked_log(a), _masked_log(b)

    def step(carry):
        f, g = carry
        g = relax_log(eps * (logb - log_rmatvec(f)), g, momentum)
        f = relax_log(eps * (loga - log_matvec(g)), f, momentum)
        log_col = log_rmatvec(f) + g / eps
        err = torch.sum(torch.abs(torch.exp(log_col) - b))
        return (f, g), err

    return step


def run_marginal_loop(step, carry0, *, tol: float, max_iter: int,
                      steps_per_check: int = 1, iters_per_step: int = 1):
    """Run ``step`` until the marginal error drops below ``tol``.

    One check block is always taken. Each block calls ``step``
    ``steps_per_check`` times back to back, each call advancing
    ``iters_per_step`` iterations (``inner_steps`` for the megakernel block
    step, 1 otherwise), then reads the error to the host once; the loop
    stops when it is ``<= tol``, is not finite, or ``max_iter`` is reached.
    ``n_iter`` is therefore a multiple of the cadence and ``max_iter``
    rounds up to one. Returns ``(n_iter, carry, err)``."""
    tol = _f32(tol)
    cadence = steps_per_check * iters_per_step

    def block(carry):
        for _ in range(steps_per_check):
            carry, err = step(carry)
        return carry, err

    carry, err = block(carry0)
    it = cadence
    e = float(err)
    while it < max_iter and e > tol and math.isfinite(e):
        carry, err = block(carry)
        it += cadence
        e = float(err)
    return it, carry, err


# ---------------------------------------------------------------------------
# Plan selection (the use_pallas policy)
# ---------------------------------------------------------------------------


def _maybe_pallas_plan(geom: Geometry, use_pallas: Optional[bool], mode: str,
                       precision: str = "highest"):
    """Resolve ``use_pallas`` into a fused plan or ``None``. ``None`` and
    ``True`` take the plan (kernels on the card, plain versions on the
    CPU); ``False`` the geometry's plain operators. Geometries without a
    fused plan (dense costs) always run their operators."""
    if use_pallas is False:
        return None
    plan = geometry_ops(geom, mode=mode, precision=precision)
    if plan is not None:
        notify_plan_selected({
            "geometry": type(geom).__name__,
            "mode": plan.mode,
            "kind": plan.kind,
            "precision": plan.precision,
        })
    return plan


def _resolve_cadence(plan, inner_steps: Optional[int],
                     check_every: Optional[int]):
    """``(inner, check, auto)``: iterations per megakernel launch and per
    convergence check from the knobs.

    Auto (both ``None``): 8 and 8 when the fused plan runs on the card and
    has a megakernel (``_plan_loop`` still takes the per-iteration step at
    shapes the megakernel does not admit); 1 and 1 everywhere else,
    including the CPU and a plan with no megakernel (the paged plan), as
    the JAX package keeps 1/1 in interpret mode and without a block step.
    Explicit values hold on every path; on the plain operators
    ``inner_steps`` only sets the check cadence."""
    if inner_steps is None and check_every is None:
        if plan is not None and plan.features[0].is_cuda \
                and plan.make_block_step is not None:
            return 8, 8, True
        return 1, 1, True
    inner = 1 if inner_steps is None else int(inner_steps)
    if inner < 1:
        raise ValueError(f"inner_steps must be >= 1, got {inner_steps}")
    check = inner if check_every is None else int(check_every)
    if check < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if check % inner != 0:
        raise ValueError(
            f"check_every ({check}) must be a multiple of inner_steps "
            f"({inner}): the marginal error only exists at block boundaries")
    return inner, check, False


def _plan_loop(plan, a, b, carry0, *, tol, max_iter, inner_steps,
               check_every, momentum):
    """Run a fused plan's hot loop: the megakernel block step
    (``inner_steps`` iterations per launch) where the plan has one and
    admits the shape, else the per-iteration step at the same check
    cadence (every iteration under auto). ``carry0`` is ``(f0, g0)``;
    returns ``(n_iter, carry, err)``."""
    inner, check, auto = _resolve_cadence(plan, inner_steps, check_every)
    block = None
    if inner > 1 and plan.make_block_step is not None:
        block = plan.make_block_step(a, b, inner_steps=inner,
                                     momentum=momentum)
    if block is not None:
        step, init = block
        return run_marginal_loop(step, init(*carry0), tol=tol,
                                 max_iter=max_iter,
                                 steps_per_check=check // inner,
                                 iters_per_step=inner)
    step, init = plan.make_step(a, b, momentum=momentum)
    return run_marginal_loop(step, init(*carry0), tol=tol, max_iter=max_iter,
                             steps_per_check=1 if auto else check)


# ---------------------------------------------------------------------------
# Scaling space
# ---------------------------------------------------------------------------


def _finish_scaling(a, b, u, v, it, err, *, eps, tol) -> SinkhornResult:
    f, g = eps * _masked_log(u), eps * _masked_log(v)
    cost = masked_dual_value(a, b, f, g)
    return SinkhornResult(u, v, f, g, cost, it, err, err <= _f32(tol))


def sinkhorn_operator(matvec, rmatvec, a, b, *, eps: float, tol: float = 1e-6,
                      max_iter: int = 2000, momentum: float = 1.0,
                      u_init: Optional[torch.Tensor] = None,
                      check_every: int = 1) -> SinkhornResult:
    """Algorithm 1 on an abstract positive kernel operator."""
    u0 = torch.ones_like(a) if u_init is None else u_init
    v0 = torch.ones_like(b)
    step = make_scaling_step(matvec, rmatvec, a, b, momentum=momentum)
    it, (u, v, _), err = run_marginal_loop(
        step, (u0, v0, rmatvec(u0)), tol=tol, max_iter=max_iter,
        steps_per_check=int(check_every))
    return _finish_scaling(a, b, u, v, it, err, eps=eps, tol=tol)


def _solve_scaling_plan(plan, a, b, *, eps, tol, max_iter, momentum,
                        u_init, inner_steps=None,
                        check_every=None) -> SinkhornResult:
    """Algorithm 1 with the loop body routed through the fused scaling
    plan: the semantics of :func:`sinkhorn_operator` (warm start, marginal
    check, momentum) up to the check cadence. The plan divides ``b / s``
    without the dead-atom pin of :func:`make_scaling_step`, as the JAX
    package's plan does."""
    u0 = torch.ones_like(a) if u_init is None else u_init
    v0 = torch.ones_like(b)
    it, (u, v, _), err = _plan_loop(plan, a, b, (u0, v0), tol=tol,
                                    max_iter=max_iter,
                                    inner_steps=inner_steps,
                                    check_every=check_every,
                                    momentum=momentum)
    return _finish_scaling(a, b, u, v, it, err, eps=eps, tol=tol)


def sinkhorn_geometry(geom: Geometry, a: torch.Tensor, b: torch.Tensor, *,
                      tol: float = 1e-6, max_iter: int = 2000,
                      momentum: float = 1.0,
                      u_init: Optional[torch.Tensor] = None,
                      use_pallas: Optional[bool] = None,
                      inner_steps: Optional[int] = None,
                      check_every: Optional[int] = None,
                      precision: str = "highest") -> SinkhornResult:
    """Algorithm 1 in scaling space on any Geometry.

    With the fused plan (``use_pallas`` not ``False``) a factored or
    point-cloud geometry runs the scaling kernels: per iteration two
    ``feature_contract`` launches, one fused ``sinkhorn_halfstep`` (a
    ``feature_matvec`` and the relaxation at momentum other than 1) and one
    ``feature_matvec`` for the carried ``s = K^T u``; or ``inner_steps``
    iterations in one launch of the megakernel ``sinkhorn_block`` where it
    is admitted (see :func:`_resolve_cadence`). ``use_pallas=False``, and
    dense costs, which have no fused plan, run the geometry's plain torch
    operators. ``precision="bf16"`` stores the factors in bfloat16 with
    float32 accumulation on both paths. ``u_init`` warm-starts u."""
    check_precision(precision)
    _check_inputs(geom, a, b, u_init)
    plan = _maybe_pallas_plan(geom, use_pallas, "scaling", precision)
    if plan is not None:
        return _solve_scaling_plan(plan, a, b, eps=geom.eps, tol=tol,
                                   max_iter=max_iter, momentum=momentum,
                                   u_init=u_init, inner_steps=inner_steps,
                                   check_every=check_every)
    _, check, _ = _resolve_cadence(None, inner_steps, check_every)
    matvec, rmatvec = geom.operators(precision=precision)
    return sinkhorn_operator(matvec, rmatvec, a, b, eps=geom.eps, tol=tol,
                             max_iter=max_iter, momentum=momentum,
                             u_init=u_init, check_every=check)


def sinkhorn_factored(xi: torch.Tensor, zeta: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, *, eps: float, tol: float = 1e-6,
                      max_iter: int = 2000, momentum: float = 1.0,
                      u_init: Optional[torch.Tensor] = None
                      ) -> SinkhornResult:
    """Linear-time Sinkhorn on K = xi zeta^T (the paper's Section 3.1),
    through the fused scaling plan."""
    return sinkhorn_geometry(FactoredPositive(xi=xi, zeta=zeta, eps=eps), a,
                             b, tol=tol, max_iter=max_iter,
                             momentum=momentum, u_init=u_init)


# ---------------------------------------------------------------------------
# Log domain (small-eps safe)
# ---------------------------------------------------------------------------


def _log_init(a, b, f_init, g_init):
    """Initial potentials, with zero-weight atoms pinned to -inf so padding
    is exact from iteration 0."""
    f0 = torch.zeros_like(a) if f_init is None else f_init
    g0 = torch.zeros_like(b) if g_init is None else g_init
    f0 = torch.where(a > 0, f0, torch.full_like(f0, -torch.inf))
    g0 = torch.where(b > 0, g0, torch.full_like(g0, -torch.inf))
    return f0, g0


def _finish_log(a, b, f, g, it, err, *, eps, tol) -> SinkhornResult:
    cost = masked_dual_value(a, b, f, g)
    u, v = torch.exp(f / eps), torch.exp(g / eps)
    return SinkhornResult(u, v, f, g, cost, it, err, err <= _f32(tol))


def sinkhorn_log_geometry(geom: Geometry, a: torch.Tensor, b: torch.Tensor, *,
                          tol: float = 1e-6, max_iter: int = 2000,
                          momentum: float = 1.0,
                          f_init: Optional[torch.Tensor] = None,
                          g_init: Optional[torch.Tensor] = None,
                          use_pallas: Optional[bool] = None,
                          inner_steps: Optional[int] = None,
                          check_every: Optional[int] = None,
                          precision: str = "highest") -> SinkhornResult:
    """Log-domain Sinkhorn on any log-capable Geometry.

    With the fused plan (``use_pallas`` not ``False``) each iteration runs
    the log kernels: three ``log_halfstep`` and two ``log_feature_contract``
    launches, the stage-1 LSE carried so the convergence check costs one
    half-step; or ``inner_steps`` iterations run in one launch of the
    megakernel (see :func:`_resolve_cadence`). ``precision="bf16"`` stores
    the factors in bfloat16 with float32 accumulation, on the plan and on
    the plain operators alike. ``f_init``/``g_init`` warm-start the
    potentials."""
    check_precision(precision)
    _check_inputs(geom, a, b, f_init, g_init)
    f0, g0 = _log_init(a, b, f_init, g_init)
    plan = _maybe_pallas_plan(geom, use_pallas, "log", precision)
    if plan is not None:
        it, carry, err = _plan_loop(plan, a, b, (f0, g0), tol=tol,
                                    max_iter=max_iter,
                                    inner_steps=inner_steps,
                                    check_every=check_every,
                                    momentum=momentum)
    else:
        _, check, _ = _resolve_cadence(None, inner_steps, check_every)
        log_matvec, log_rmatvec = geom.log_operators(precision=precision)
        step = make_log_step(log_matvec, log_rmatvec, a, b, eps=geom.eps,
                             momentum=momentum)
        it, carry, err = run_marginal_loop(step, (f0, g0), tol=tol,
                                           max_iter=max_iter,
                                           steps_per_check=check)
    return _finish_log(a, b, carry[0], carry[1], it, err, eps=geom.eps,
                       tol=tol)
