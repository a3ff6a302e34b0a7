"""Solver front end: ``OTProblem``, ``EpsSchedule``, ``solve``.

    problem = OTProblem.from_point_clouds(x, y, anchors, eps=0.1)
    res = solve(problem, schedule=EpsSchedule(eps_init=1.0, decay=0.5))

An :class:`OTProblem` is a thin ``(geometry, a, b)`` record; a ``method``
names an algorithm and the geometry supplies the kernel operators. The
constructors take tensors or numpy arrays and put them on ``device``,
which defaults to the card (``device="cpu"`` runs the plain PyTorch
versions of the kernels). Every single-problem method is ported:
``factored``, ``log_factored``, ``accelerated``, ``quadratic``,
``log_quadratic``, ``arccos`` and ``nystrom``; ``sharded`` /
``sharded_log`` raise ``NotImplementedError``. Counterpart of
``repro.core.api`` (single-problem surface).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..kernels.backend import as_f32, resolve_device
from .accelerated import accelerated_sinkhorn_geometry
from .features import ArcCosineFeatureMap
from .geometry import (
    ArcCosinePointCloud,
    DenseCost,
    FactoredPositive,
    GaussianPointCloud,
    Geometry,
    GridSeparable,
    NystromLowRank,
)
from .sinkhorn import SinkhornResult, sinkhorn_geometry, sinkhorn_log_geometry

__all__ = [
    "METHODS",
    "PORTED_METHODS",
    "OTProblem",
    "EpsSchedule",
    "AnnealedResult",
    "solve",
    "solve_annealed",
]

METHODS = ("auto", "factored", "log_factored", "accelerated", "quadratic",
           "log_quadratic", "arccos", "nystrom", "sharded", "sharded_log")


def _uniform(n: int, device) -> torch.Tensor:
    return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)


def _weights(w, n: int, device) -> torch.Tensor:
    return _uniform(n, device) if w is None else as_f32(w, device)


@dataclasses.dataclass(frozen=True)
class OTProblem:
    """One entropic OT problem: a Geometry (the kernel) plus marginals
    ``a`` (n,) and ``b`` (m,) on the geometry's device; zero weights are
    allowed and masked exactly by every solver."""

    geometry: Geometry
    a: torch.Tensor
    b: torch.Tensor

    def __post_init__(self):
        if not isinstance(self.geometry, Geometry):
            raise TypeError("OTProblem.geometry must be a Geometry")

    @property
    def eps(self) -> float:
        return self.geometry.eps

    @property
    def anneal_capable(self) -> bool:
        return self.geometry.anneal_capable

    @classmethod
    def from_geometry(cls, geometry: Geometry, a=None, b=None, *,
                      device=None) -> "OTProblem":
        dev = resolve_device(device)
        if geometry.device != dev:
            raise ValueError(f"geometry is on {geometry.device}, problem "
                             f"asked for {dev}")
        n, m = geometry.shape
        return cls(geometry=geometry, a=_weights(a, n, dev),
                   b=_weights(b, m, dev))

    @classmethod
    def from_features(cls, xi, zeta, a=None, b=None, *, eps: float,
                      device=None) -> "OTProblem":
        dev = resolve_device(device)
        geom = FactoredPositive(xi=as_f32(xi, dev), zeta=as_f32(zeta, dev),
                                eps=float(eps))
        return cls.from_geometry(geom, a, b, device=dev)

    @classmethod
    def from_log_features(cls, log_xi, log_zeta, a=None, b=None, *,
                          eps: float, device=None) -> "OTProblem":
        dev = resolve_device(device)
        geom = FactoredPositive(log_xi=as_f32(log_xi, dev),
                                log_zeta=as_f32(log_zeta, dev),
                                eps=float(eps))
        return cls.from_geometry(geom, a, b, device=dev)

    @classmethod
    def from_cost(cls, C, a=None, b=None, *, eps: float,
                  device=None) -> "OTProblem":
        dev = resolve_device(device)
        return cls.from_geometry(DenseCost(as_f32(C, dev), float(eps)), a, b,
                                 device=dev)

    @classmethod
    def from_point_clouds(cls, x, y, anchors, a=None, b=None, *, eps: float,
                          R: Optional[float] = None,
                          device=None) -> "OTProblem":
        dev = resolve_device(device)
        geom = GaussianPointCloud.build(as_f32(x, dev), as_f32(y, dev),
                                        as_f32(anchors, dev), eps=eps, R=R)
        return cls.from_geometry(geom, a, b, device=dev)

    @classmethod
    def from_grid(cls, axes_x, axes_y=None, a=None, b=None, *, eps: float,
                  device=None) -> "OTProblem":
        """Separable-grid problem (images / histograms): the measures live
        on the cartesian product of the axis coordinates, weights in C
        order (``image.reshape(-1)``)."""
        dev = resolve_device(device)
        geom = GridSeparable.build(axes_x, axes_y, eps=eps, device=dev)
        return cls.from_geometry(geom, a, b, device=dev)


# ---------------------------------------------------------------------------
# Epsilon annealing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EpsSchedule:
    """Geometric eps cascade eps_0, eps_0*decay, ... down to the target.

    Intermediate stages stop at loose tolerances, geometric from
    ``stage_tol`` down to sqrt(stage_tol * tol), each capped at the
    previous stage's achieved error and at ``stage_iters`` iterations; the
    final stage gets ``tol`` and the caller's ``max_iter``."""

    eps_init: float
    decay: float = 0.5
    stage_iters: int = 400
    stage_tol: float = 1e-2

    def __post_init__(self):
        if not (0.0 < self.decay < 1.0):
            raise ValueError(f"decay must be in (0, 1), got {self.decay}")
        if self.eps_init <= 0:
            raise ValueError("eps_init must be positive")

    def stages(self, eps_final: float) -> Tuple[float, ...]:
        if self.eps_init <= eps_final:
            return (eps_final,)
        out = []
        e = self.eps_init
        thresh = eps_final / math.sqrt(self.decay)
        while e > thresh:
            out.append(e)
            e *= self.decay
        out.append(eps_final)
        return tuple(out)

    def stage_tols(self, tol_final: float, n_stages: int) -> Tuple[float, ...]:
        if n_stages <= 1 or self.stage_tol <= tol_final:
            return (tol_final,) * max(n_stages, 1)
        if n_stages == 2:
            return (self.stage_tol, tol_final)
        mid = math.sqrt(self.stage_tol * tol_final)
        ratio = (mid / self.stage_tol) ** (1.0 / (n_stages - 2))
        tols = [max(self.stage_tol * ratio**k, tol_final)
                for k in range(n_stages - 1)]
        return tuple(tols) + (tol_final,)


class AnnealedResult(NamedTuple):
    result: SinkhornResult              # final-stage solve (n_iter = TOTAL)
    stage_eps: Tuple[float, ...]
    stage_iters: Tuple[int, ...]        # iterations per stage
    stage_errs: torch.Tensor            # (S,) marginal error at stage exit


# ---------------------------------------------------------------------------
# Dispatch: method -> (geometry coercion, solver runner)
# ---------------------------------------------------------------------------


def _run_scaling(geom, a, b, *, tol, max_iter, momentum, f_init, g_init,
                 **policy):
    u_init = None if f_init is None else torch.exp(f_init / geom.eps)
    return sinkhorn_geometry(geom, a, b, tol=tol, max_iter=max_iter,
                             momentum=momentum, u_init=u_init, **policy)


def _run_log(geom, a, b, *, tol, max_iter, momentum, f_init, g_init,
             **policy):
    return sinkhorn_log_geometry(geom, a, b, tol=tol, max_iter=max_iter,
                                 momentum=momentum, f_init=f_init,
                                 g_init=g_init, **policy)


def _run_accelerated(geom, a, b, *, tol, max_iter, momentum, f_init, g_init,
                     use_pallas=None, inner_steps=None, check_every=None,
                     precision="highest"):
    # AGM's extrapolation is its acceleration and its body has no fused
    # plan (use_pallas is ignored), so over-relaxation, the megakernel
    # block and bf16 storage are refused rather than silently dropped
    if momentum != 1.0:
        raise ValueError(
            "momentum (over-relaxation) is not supported by "
            "method='accelerated': the AGM extrapolation already plays "
            f"that role; got momentum={momentum}. Use momentum=1.0 or a "
            "plain method ('factored', 'log_factored', ...).")
    if inner_steps is not None and int(inner_steps) > 1:
        raise ValueError(
            "inner_steps > 1 (the persistent megakernel) is not available "
            "for method='accelerated': the AGM body interleaves gradient "
            "extrapolation with exact block steps and has no fused plan. "
            "Use check_every= for the cadence win, or a plain method.")
    if precision != "highest":
        raise ValueError(
            "method='accelerated' differentiates the smoothed dual through "
            "its log-operators; the bf16 storage policy is not supported "
            f"here (got precision={precision!r})")
    return accelerated_sinkhorn_geometry(
        geom, a, b, tol=tol, max_iter=max_iter, f_init=f_init, g_init=g_init,
        check_every=1 if check_every is None else check_every)


def _default_generator(key: Optional[torch.Generator]) -> torch.Generator:
    """``key``, or a CPU generator seeded 0 (the JAX package's
    ``PRNGKey(0)`` default)."""
    return torch.Generator().manual_seed(0) if key is None else key


def _coerce_native_factored(geom, eps, *, rank, key):
    if isinstance(geom, DenseCost):
        raise ValueError(
            "no factored kernel available (dense-cost problem); use a "
            "quadratic method or build the problem from point clouds")
    return geom


def _coerce_densify(geom, eps, *, rank, key):
    if isinstance(geom, DenseCost):
        return geom
    return DenseCost(geom.cost_matrix(), eps)


def _coerce_arccos(geom, eps, *, rank, key):
    if isinstance(geom, ArcCosinePointCloud):
        return geom
    if isinstance(geom, GaussianPointCloud):
        # the same supports under the arc-cosine family: fresh anchors
        # u ~ N(0, sigma^2 I), as many as the problem's unless ``rank``
        r = geom.anchors.shape[0] if rank is None else rank
        fm = ArcCosineFeatureMap(r=r, d=geom.x.shape[-1])
        anchors = fm.init(_default_generator(key), device=geom.device)
        return ArcCosinePointCloud(geom.x, geom.y, anchors, eps=eps, s=fm.s,
                                   sigma=fm.sigma, kappa=fm.kappa)
    raise ValueError(
        "method='arccos' needs point-cloud supports (an ArcCosinePointCloud "
        f"or GaussianPointCloud geometry); got {type(geom).__name__}")


def _coerce_nystrom(geom, eps, *, rank, key):
    if isinstance(geom, NystromLowRank):
        return geom
    if isinstance(geom, (GaussianPointCloud, ArcCosinePointCloud)):
        r = geom.anchors.shape[0] if rank is None else rank
        return NystromLowRank.from_point_clouds(
            geom.x, geom.y, eps=eps, rank=r,
            generator=_default_generator(key))
    raise ValueError(
        "method='nystrom' needs point-cloud supports (a NystromLowRank or "
        f"point-cloud geometry); got {type(geom).__name__}")


# method -> (coerce geometry, runner). The only dispatch table in the file.
_SOLVERS: Dict[str, Tuple[Callable, Callable]] = {
    "factored": (_coerce_native_factored, _run_scaling),
    "log_factored": (_coerce_native_factored, _run_log),
    "accelerated": (_coerce_native_factored, _run_accelerated),
    "quadratic": (_coerce_densify, _run_scaling),
    "log_quadratic": (_coerce_densify, _run_log),
    "arccos": (_coerce_arccos, _run_log),
    "nystrom": (_coerce_nystrom, _run_scaling),
}
PORTED_METHODS = ("auto", *_SOLVERS)

# auto dispatch: the first matching geometry type wins; other geometries
# take "factored" on linear features, else "log_factored" (grids and
# Gaussian clouds, the reference's last two rows)
_AUTO_METHODS: Tuple[Tuple[type, str], ...] = (
    (NystromLowRank, "nystrom"),
    (ArcCosinePointCloud, "arccos"),
    (DenseCost, "log_quadratic"),
)


def _auto_method(problem: OTProblem) -> str:
    g = problem.geometry
    for typ, method in _AUTO_METHODS:
        if isinstance(g, typ):
            return method
    if isinstance(g, FactoredPositive) and g.xi is not None:
        return "factored"
    return "log_factored"


def _solve_stage(problem: OTProblem, method: str, eps: float, *, tol: float,
                 max_iter: int, momentum: float,
                 f_init: Optional[torch.Tensor],
                 g_init: Optional[torch.Tensor],
                 rank: Optional[int] = None,
                 key: Optional[torch.Generator] = None,
                 use_pallas: Optional[bool] = None,
                 inner_steps: Optional[int] = None,
                 check_every: Optional[int] = None,
                 precision: str = "highest") -> SinkhornResult:
    """One solve at a fixed eps with optional warm-started potentials."""
    if method not in _SOLVERS:
        if method in METHODS:
            raise NotImplementedError(
                f"method={method!r} is not ported to repro_torch yet "
                f"(ROADMAP.md, queue A); ported: {PORTED_METHODS}")
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{METHODS}")
    coerce, run = _SOLVERS[method]
    geom = coerce(problem.geometry.rebuild_at(eps), eps, rank=rank, key=key)
    return run(geom, problem.a, problem.b, tol=tol, max_iter=max_iter,
               momentum=momentum, f_init=f_init, g_init=g_init,
               use_pallas=use_pallas, inner_steps=inner_steps,
               check_every=check_every, precision=precision)


def solve_annealed(problem: OTProblem, *, method: str = "auto",
                   schedule: EpsSchedule, tol: float = 1e-6,
                   max_iter: int = 2000, momentum: float = 1.0,
                   rank: Optional[int] = None,
                   key: Optional[torch.Generator] = None,
                   use_pallas: Optional[bool] = None,
                   inner_steps: Optional[int] = None,
                   check_every: Optional[int] = None,
                   precision: str = "highest") -> AnnealedResult:
    """Annealed solve with per-stage diagnostics: each stage re-derives the
    kernel at eps_k and warm-starts from the previous stage's potentials.
    ``result.n_iter`` is the total across stages. On the fused plan each
    stage eps has its own runner (``core.runners``, the counterpart of the
    JAX package's per-stage jit runner), reused across calls; a stage's
    potentials go into the next stage's static buffers on the device."""
    if method == "auto":
        method = _auto_method(problem)
    if not problem.geometry.anneal_capable:
        raise ValueError(
            "eps-annealing needs a geometry whose kernel is re-derivable at "
            f"any eps; {type(problem.geometry).__name__} pins the kernel to "
            "one eps")
    stages = schedule.stages(problem.eps)
    tols = schedule.stage_tols(tol, len(stages))
    f = g = None
    prev_err = None
    stage_iters, stage_errs = [], []
    res = None
    for k, e in enumerate(stages):
        last = k == len(stages) - 1
        tol_k = tols[k] if prev_err is None else min(tols[k], prev_err)
        res = _solve_stage(
            problem, method, e, tol=tol_k,
            max_iter=max_iter if last else schedule.stage_iters,
            momentum=momentum, f_init=f, g_init=g, rank=rank, key=key,
            use_pallas=use_pallas,
            inner_steps=inner_steps, check_every=check_every,
            precision=precision)
        prev_err = float(res.marginal_err)
        f, g = res.f, res.g
        stage_iters.append(res.n_iter)
        stage_errs.append(res.marginal_err)
    final = res._replace(n_iter=sum(stage_iters))
    return AnnealedResult(final, stages, tuple(stage_iters),
                          torch.stack(stage_errs))


def solve(problem: OTProblem, *, method: str = "auto",
          schedule: Optional[EpsSchedule] = None, tol: float = 1e-6,
          max_iter: int = 2000, momentum: float = 1.0,
          rank: Optional[int] = None,
          key: Optional[torch.Generator] = None,
          use_pallas: Optional[bool] = None,
          inner_steps: Optional[int] = None,
          check_every: Optional[int] = None,
          precision: str = "highest") -> SinkhornResult:
    """Solve one entropic OT problem.

    ``method``: "auto" (Nystrom factors -> "nystrom", arc-cosine clouds
    -> "arccos", dense costs -> "log_quadratic", grids, Gaussian point
    clouds and log-features -> "log_factored", linear features ->
    "factored"), "factored" (Algorithm 1 in scaling space, on features or
    point clouds), "log_factored", "accelerated" (AGM on the log
    operators, momentum 1, no megakernel, float32 only), "quadratic",
    "log_quadratic", "arccos" (the log plan on Lemma-3 features; a
    Gaussian problem's clouds get ``rank`` fresh anchors drawn by ``key``)
    or "nystrom" (signed low-rank factors of ``rank`` landmarks drawn by
    ``key``, scaling space). ``key`` is a ``torch.Generator`` (a CPU one
    seeded 0 by default).
    ``schedule``: optional :class:`EpsSchedule` (anneal-capable
    geometries; scaling stages warm-start from ``u = exp(f / eps)``).
    ``use_pallas``: ``None``/``True`` run the fused plan of the method's
    mode, scaling or log (the CUDA kernels on the card, their plain
    versions on the CPU), ``False`` the geometry's plain torch operators;
    dense costs always run their operators. ``check_every``/``inner_steps``
    set the cadence (iterations per megakernel launch and per check).
    ``precision="bf16"`` stores the factors in bfloat16 with float32
    accumulation.
    """
    if method == "auto":
        method = _auto_method(problem)
    kw = dict(tol=tol, max_iter=max_iter, momentum=momentum, rank=rank,
              key=key, use_pallas=use_pallas, inner_steps=inner_steps,
              check_every=check_every, precision=precision)
    if schedule is not None:
        return solve_annealed(problem, method=method, schedule=schedule,
                              **kw).result
    return _solve_stage(problem, method, problem.eps, f_init=None,
                        g_init=None, **kw)
