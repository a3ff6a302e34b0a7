"""Solver front end: ``OTProblem``, ``EpsSchedule``, ``solve``, and the
batched engine ``BatchedSinkhorn`` / ``solve_many``.

    problem = OTProblem.from_point_clouds(x, y, anchors, eps=0.1)
    res = solve(problem, schedule=EpsSchedule(eps_init=1.0, decay=0.5))
    res = solve(SolveSpec(geometry=geom, tol=1e-6))      # one record

    engine = BatchedSinkhorn(eps=0.05, method="log_factored")
    results = engine.solve_many(problems)   # buckets, pads, one loop a bucket

An :class:`OTProblem` is a thin ``(geometry, a, b)`` record; a ``method``
names an algorithm and the geometry supplies the kernel operators. The
constructors take tensors or numpy arrays and put them on ``device``,
which defaults to the card (``device="cpu"`` runs the plain PyTorch
versions of the kernels). Every single-problem method is ported:
``factored``, ``log_factored``, ``accelerated``, ``quadratic``,
``log_quadratic``, ``arccos`` and ``nystrom``; ``sharded`` /
``sharded_log`` raise ``NotImplementedError``.

The batched engine solves P independent problems of one padded shape in
one loop: their factors are stacked on a leading axis and every kernel
launch of the fused plan serves all P (``kernels.ops``), where the JAX
package ``vmap``s its solver and so adds the problems as a leading grid
axis of its kernels. Supports are padded to the power-of-two buckets of
``configs.shapes.ot_bucket`` with zero-weight atoms, which every solver
masks exactly; each lane stops on its own, so its result is its own
solve's. Counterpart of ``repro.core.api``.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from collections import OrderedDict
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from ..configs.shapes import OTBatchShape
from ..kernels.backend import as_f32, resolve_device
from ..kernels.ops import check_precision, notify_plan_selected, stacked_ops
from ..kernels.ref import ieee_fp32, lse
from .accelerated import accelerated_sinkhorn_geometry, accelerated_stacked
from .features import ArcCosineFeatureMap
from .geometry import (
    ArcCosinePointCloud,
    DenseCost,
    FactoredPositive,
    GaussianPointCloud,
    Geometry,
    GridSeparable,
    NystromLowRank,
    _factored_log_apply,
    _stored,
    data_radius,
)
from .runners import RunnerCache
from .sinkhorn import (
    SinkhornResult,
    _f32,
    _finish_log,
    _finish_scaling,
    _log_init,
    _resolve_cadence,
    _solve_log_plan,
    _solve_scaling_plan,
    make_log_step,
    make_scaling_step,
    run_lane_loop,
    sinkhorn_geometry,
    sinkhorn_log_geometry,
)

__all__ = [
    "METHODS",
    "PORTED_METHODS",
    "OTProblem",
    "EpsSchedule",
    "AnnealedResult",
    "BatchedSinkhorn",
    "solve",
    "solve_annealed",
    "solve_many",
    "unpad_result",
    "get_engine",
    "engine_cache_info",
    "set_engine_cache_capacity",
    "clear_engine_cache",
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


def _check_accelerated(momentum, inner_steps, precision) -> None:
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


def _run_accelerated(geom, a, b, *, tol, max_iter, momentum, f_init, g_init,
                     use_pallas=None, inner_steps=None, check_every=None,
                     precision="highest"):
    _check_accelerated(momentum, inner_steps, precision)
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


def _warn_legacy(where: str, use_pallas, inner_steps, check_every,
                 precision) -> None:
    if (use_pallas is not None or inner_steps is not None
            or check_every is not None or precision != "highest"):
        plural = "s" if where == "solve_many" else ""
        warnings.warn(
            "passing execution kwargs (use_pallas=/inner_steps=/"
            f"check_every=/precision=) to {where}() directly is deprecated: "
            "build a SolveSpec with an ExecutionPolicy "
            f"(repro_torch.core.spec) and call {where}(spec{plural})",
            DeprecationWarning, stacklevel=3)


def solve(problem, *, method: str = "auto",
          schedule: Optional[EpsSchedule] = None, tol: float = 1e-6,
          max_iter: int = 2000, momentum: float = 1.0,
          rank: Optional[int] = None,
          key: Optional[torch.Generator] = None,
          use_pallas: Optional[bool] = None,
          inner_steps: Optional[int] = None,
          check_every: Optional[int] = None,
          precision: str = "highest") -> SinkhornResult:
    """Solve one entropic OT problem.

    The preferred form takes one argument, a
    :class:`~repro_torch.core.spec.SolveSpec`, which carries the geometry,
    the weights, the target and an ``ExecutionPolicy``::

        solve(SolveSpec(geometry=geom, tol=1e-6,
                        policy=ExecutionPolicy(precision="bf16")))

    The keyword form below stays as a wrapper; the execution kwargs
    (``use_pallas=`` / ``inner_steps=`` / ``check_every=`` /
    ``precision=``) with a bare problem emit a ``DeprecationWarning``. A
    spec with ``recovery`` set climbs its recovery ladder on a failed
    verdict and returns the ladder's last result
    (:func:`~repro_torch.resilience.ladder.solve_with_recovery`).

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
    from .spec import SolveSpec     # spec imports this module

    if isinstance(problem, SolveSpec):
        spec = problem
        if spec.recovery is not None:
            from ..resilience.ladder import solve_with_recovery
            return solve_with_recovery(spec).result
        kw = spec.solver_kwargs()
        meth, sched = kw.pop("method"), kw.pop("schedule")
        with spec.policy.scope():
            prob = spec.problem()
            if meth == "auto":
                meth = _auto_method(prob)
            if sched is not None:
                return solve_annealed(prob, method=meth, schedule=sched,
                                      **kw).result
            return _solve_stage(prob, meth, prob.eps, f_init=None,
                                g_init=None, **kw)
    _warn_legacy("solve", use_pallas, inner_steps, check_every, precision)
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


# ---------------------------------------------------------------------------
# Batched engine
# ---------------------------------------------------------------------------


def _pad_rows(arr: torch.Tensor, n_pad: int, *, replicate: bool,
              fill: float = 0.0) -> torch.Tensor:
    """Pad axis 0 to ``n_pad``: replicate the last row (features, supports,
    costs: keeps log-features finite) or append ``fill`` (0 for weights
    and potentials)."""
    pad = n_pad - arr.shape[0]
    if pad <= 0:
        return arr
    if replicate:
        tail = arr[-1:].expand((pad,) + tuple(arr.shape[1:]))
    else:
        tail = torch.full((pad,) + tuple(arr.shape[1:]), fill,
                          dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, tail], dim=0)


def _stacked(x, device) -> torch.Tensor:
    """A stacked operand as a contiguous float32 tensor: a tensor keeps
    its device, an array goes to ``device`` (default: the card)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).contiguous()
    return as_f32(x, resolve_device(device))


# The engine's methods and the mode each runs in: "factored" is Algorithm 1
# on linear factors, "log_factored" the log domain on log-factors (both the
# fused plans of kernels.ops over (P, n, r) factors), "accelerated" AGM on
# the log-factors, and the quadratic methods the dense (P, n, m) costs on
# plain torch operators, as the single-problem path runs them.
_ENGINE_MODES: Dict[str, str] = {
    "factored": "scaling",
    "log_factored": "log",
    "accelerated": "log",
    "quadratic": "scaling",
    "log_quadratic": "log",
}


def _plain_scaling_operators(ka, kb, method: str, eps: float,
                             precision: str):
    """``(matvec, rmatvec)`` of P stacked kernels on (P, m) / (P, n)
    scalings: the factored kernel Xi Zeta^T, or the Gibbs kernel of the
    dense costs ``ka``, stored at ``precision`` and applied in float32."""
    def mv(A, v):
        with ieee_fp32():
            return (A.float() @ v[..., None])[..., 0]

    if method == "quadratic":
        K = _stored(torch.exp(-ka / eps), precision)
        return (lambda v: mv(K, v)), (lambda u: mv(K.mT, u))
    xi, zeta = _stored(ka, precision), _stored(kb, precision)
    return (lambda v: mv(xi, mv(zeta.mT, v)),
            lambda u: mv(zeta, mv(xi.mT, u)))


def _plain_log_operators(ka, kb, method: str, eps: float, precision: str):
    """``(log_matvec, log_rmatvec)`` of P stacked kernels on (P, m) / (P,
    n) potentials: the exact two-stage LSE on log-factors, or the LSE of
    the dense costs ``ka``."""
    if method == "log_quadratic":
        negC = _stored(-ka / eps, precision)
        return (lambda g: lse(negC.float() + (g / eps)[..., None, :], dim=-1),
                lambda f: lse(negC.float() + (f / eps)[..., :, None], dim=-2))
    lxi, lzt = _stored(ka, precision), _stored(kb, precision)
    return (lambda g: _factored_log_apply(lxi.float(), lzt.float(), g / eps),
            lambda f: _factored_log_apply(lzt.float(), lxi.float(), f / eps))


# Runners an engine keeps: one a (stacked shape, problem count, stage eps)
# cell, room for a ragged list's buckets and an annealing schedule's stages.
_ENGINE_RUNNERS = 16


class BatchedSinkhorn:
    """The batched solver engine: P independent problems of one padded
    shape in one loop.

    All problems of a batch share the feature rank r; supports are padded
    to the power-of-two buckets of ``configs.shapes.ot_bucket`` with
    zero-weight atoms, which the masked solvers treat exactly. On the
    fused plans ("factored", "log_factored") every kernel launch serves
    the whole batch and the loop is one captured CUDA graph a cell, kept
    in the engine's own ``runners`` (one a stacked shape, problem count
    and stage eps; no capture after a cell's first solve). "accelerated"
    and the quadratic methods run plain torch operators on the stacked
    tensors, as their single-problem solves run plain operators. Each
    lane stops on its own and is then frozen, so each result equals that
    problem's own solve.

    ``solve_stacked`` and ``solve_point_clouds`` take uniform (P, ...)
    tensors; ``solve_many`` takes a ragged list of problems and buckets
    it. Counterpart of ``repro.core.api.BatchedSinkhorn``.
    """

    _FACTORED = ("factored", "log_factored", "accelerated")
    _QUADRATIC = ("quadratic", "log_quadratic")

    def __init__(self, *, eps: float, method: str = "log_factored",
                 tol: float = 1e-6, max_iter: int = 2000,
                 momentum: float = 1.0,
                 schedule: Optional[EpsSchedule] = None,
                 use_pallas: Optional[bool] = None,
                 inner_steps: Optional[int] = None,
                 check_every: Optional[int] = None,
                 precision: str = "highest"):
        if method not in self._FACTORED + self._QUADRATIC:
            raise ValueError(
                f"batched engine supports {self._FACTORED + self._QUADRATIC},"
                f" got {method!r}")
        check_precision(precision)
        if schedule is not None and method not in ("log_factored",
                                                   "accelerated"):
            raise ValueError(
                "batched annealing runs in log domain (small-eps stages); "
                f"use method='log_factored' or 'accelerated', got {method!r}")
        self.eps = float(eps)
        self.method = method
        self.tol = tol
        self.max_iter = int(max_iter)
        self.momentum = float(momentum)
        self.schedule = schedule
        self.use_pallas = use_pallas
        self.inner_steps = inner_steps
        self.check_every = check_every
        self.precision = precision
        self.runners = RunnerCache(max_runners=_ENGINE_RUNNERS)

    # -- one stacked solve ---------------------------------------------------

    def _solve(self, ka, kb, a, b, f_init, g_init, *, eps: float, tol,
               max_iter: int, plan_spec: Optional[dict] = None,
               runners: Optional[RunnerCache] = None) -> SinkhornResult:
        """One stacked solve at ``eps``: the fused plan of the method's
        mode where it applies (built from ``plan_spec`` where given, else
        from the stacked factors ``ka``/``kb``), its loop captured in
        ``runners`` (default the engine's own), else the plain operators
        through the eager lane loop. ``tol`` is a float or one a lane."""
        method, mode = self.method, _ENGINE_MODES[self.method]
        P = a.shape[0]
        fused = self.use_pallas is not False and method in (
            "factored", "log_factored")
        if fused:
            spec = plan_spec if plan_spec is not None else (
                {"kind": "factored", "xi": ka, "zeta": kb}
                if method == "factored" else
                {"kind": "log_factored", "log_xi": ka, "log_zeta": kb})
            plan = stacked_ops(spec, problems=P, eps=eps, mode=mode,
                               precision=self.precision)
            notify_plan_selected({"geometry": "BatchedSinkhorn",
                                  "mode": plan.mode, "kind": plan.kind,
                                  "precision": plan.precision})
            kw = dict(eps=eps, tol=tol, max_iter=max_iter,
                      momentum=self.momentum, inner_steps=self.inner_steps,
                      check_every=self.check_every,
                      runners=self.runners if runners is None else runners)
            if mode == "scaling":
                u0 = None if f_init is None else torch.exp(f_init / eps)
                res = _solve_scaling_plan(plan, a, b, u_init=u0, **kw)
            else:
                res = _solve_log_plan(plan, a, b, f_init=f_init,
                                      g_init=g_init, **kw)
            return res._replace(n_iter=torch.tensor(res.n_iter))
        if method == "accelerated":
            _check_accelerated(self.momentum, self.inner_steps,
                               self.precision)
            ops = _plain_log_operators(ka, kb, method, eps, "highest")
            _, check, _ = _resolve_cadence(None, None, self.check_every)
            return accelerated_stacked(*ops, a, b, eps=eps, tol=tol,
                                       max_iter=max_iter, f_init=f_init,
                                       g_init=g_init, check_every=check)
        _, check, _ = _resolve_cadence(None, self.inner_steps,
                                       self.check_every)
        kw = dict(tol=tol, max_iter=max_iter, lanes=P, steps_per_check=check)
        if mode == "scaling":
            matvec, rmatvec = _plain_scaling_operators(
                ka, kb, method, eps, self.precision)
            u0 = torch.ones_like(a) if f_init is None else \
                torch.exp(f_init / eps)
            step = make_scaling_step(matvec, rmatvec, a, b,
                                     momentum=self.momentum)
            it, (u, v, _), err = run_lane_loop(
                step, (u0, torch.ones_like(b), rmatvec(u0)), **kw)
            return _finish_scaling(a, b, u, v, torch.tensor(it), err,
                                   eps=eps, tol=tol)
        log_mv, log_rmv = _plain_log_operators(ka, kb, method, eps,
                                               self.precision)
        step = make_log_step(log_mv, log_rmv, a, b, eps=eps,
                             momentum=self.momentum)
        it, (f, g), err = run_lane_loop(
            step, _log_init(a, b, f_init, g_init), **kw)
        return _finish_log(a, b, f, g, torch.tensor(it), err, eps=eps,
                           tol=tol)

    # -- stacked entry points ------------------------------------------------

    def solve_stacked(self, ka, kb, a, b, f_init=None, g_init=None, *,
                      runners: Optional[RunnerCache] = None
                      ) -> SinkhornResult:
        """Solve P problems given stacked kernel data.

        factored: ``ka``/``kb`` = features (P, n, r)/(P, m, r);
        log_factored/accelerated: log-features; quadratic/log_quadratic:
        ``ka`` = costs (P, n, m) and ``kb`` is ignored (pass ``ka``).
        Returns a stacked :class:`SinkhornResult` (leading axis P; its
        ``n_iter`` an int64 tensor on the CPU, one count a problem).

        ``f_init``/``g_init`` (both (P, n)/(P, m)) warm-start the
        potentials: they are copied into the cell's runner buffers (the
        JAX package donates them), so no second pair is held.

        ``runners`` is the :class:`~repro_torch.core.runners.RunnerCache`
        the fused loop captures into, the engine's own ``runners`` by
        default (the serving layer gives each of its runners its own).
        """
        if self.schedule is not None:
            raise ValueError(
                "stacked features pin the kernel to one eps: annealing "
                "needs solve_point_clouds (geometry mode)")
        if (f_init is None) != (g_init is None):
            raise ValueError(
                "pass both f_init and g_init (or neither): warm starts come "
                "as potential pairs")
        ka = _stacked(ka, None)
        dev = ka.device
        kb = _stacked(kb, dev)
        a, b = _stacked(a, dev), _stacked(b, dev)
        if f_init is not None:
            f_init, g_init = _stacked(f_init, dev), _stacked(g_init, dev)
        return self._solve(ka, kb, a, b, f_init, g_init, eps=self.eps,
                           tol=self.tol, max_iter=self.max_iter,
                           runners=runners)

    def solve_point_clouds(self, x, y, anchors, a=None, b=None, *,
                           R: Optional[float] = None) -> SinkhornResult:
        """Solve P cloud pairs (P, n, d)/(P, m, d) with SHARED anchors
        (r, d), each stage's features built in one feature-map launch a
        side over the flattened (P * n, d) points; the one batched mode
        that composes with an ``EpsSchedule``.

        ``R`` bounds the data (Lemma 1's q); ``None`` rounds the batch's
        data radius up to the next 0.5, so minibatches of similar scale
        share their cells. Each stage's tolerance is capped, lane by lane,
        at that lane's error at the previous stage, and ``n_iter`` is each
        lane's total over the stages (``solve_annealed``'s semantics)."""
        if self.method not in ("log_factored", "accelerated"):
            raise ValueError("point-cloud mode runs in log domain")
        x = _stacked(x, None)
        dev = x.device
        y, anchors = _stacked(y, dev), _stacked(anchors, dev)
        P, n, d = x.shape
        m = y.shape[1]
        a = torch.full((P, n), 1.0 / n, device=dev) if a is None \
            else _stacked(a, dev)
        b = torch.full((P, m), 1.0 / m, device=dev) if b is None \
            else _stacked(b, dev)
        if R is None:
            R = math.ceil(float(data_radius(x, y)) * 2.0) / 2.0
        if self.schedule is not None:
            stages = self.schedule.stages(self.eps)
            tols = self.schedule.stage_tols(self.tol, len(stages))
        else:
            stages, tols = (self.eps,), (self.tol,)
        xf, yf = x.reshape(P * n, d), y.reshape(P * m, d)
        f = g = prev_err = None
        total = torch.zeros(P, dtype=torch.int64)
        res = None
        for k, e in enumerate(stages):
            last = k == len(stages) - 1
            tol_k = tols[k] if prev_err is None else torch.minimum(
                prev_err, torch.tensor(_f32(tols[k]), device=dev))
            geom = GaussianPointCloud(xf, yf, anchors, eps=float(e),
                                      R=float(R))
            if self.use_pallas is not False and self.method == "log_factored":
                ka = kb = None
                spec = geom.pallas_ops()
            else:
                lxi, lzt = geom.log_features()
                ka, kb = lxi.view(P, n, -1), lzt.view(P, m, -1)
                spec = None
            res = self._solve(
                ka, kb, a, b, f, g, eps=float(e), tol=tol_k,
                max_iter=self.max_iter if last else self.schedule.stage_iters,
                plan_spec=spec)
            prev_err = res.marginal_err
            f, g = res.f, res.g
            total = total + res.n_iter
        return res._replace(n_iter=total)

    # -- ragged entry point --------------------------------------------------

    def solve_many(self, problems: Sequence[OTProblem], *,
                   f_inits: Optional[Sequence[Optional[torch.Tensor]]] = None,
                   g_inits: Optional[Sequence[Optional[torch.Tensor]]] = None
                   ) -> List[SinkhornResult]:
        """Solve a ragged list of problems: bucket by padded shape, pad with
        zero-weight atoms, one stacked solve a bucket, unpad. Exact with
        respect to per-problem solves (masked zero weights), order
        preserving.

        ``f_inits``/``g_inits`` optionally warm-start individual problems
        (per-problem ``(n_i,)``/``(m_i,)`` potentials, ``None`` entries
        cold). In a bucket with a warm entry, cold entries get zero
        potentials, which is exactly the cold start (``f = 0`` is ``u = 1``
        in scaling space; the log solver starts from zeros and pins dead
        atoms), so warm and cold problems mix in one bucket exactly."""
        if (f_inits is None) != (g_inits is None):
            raise ValueError(
                "pass both f_inits and g_inits (or neither): warm starts "
                "come as potential pairs")
        if f_inits is not None:
            if len(f_inits) != len(problems) or len(g_inits) != len(problems):
                raise ValueError(
                    f"f_inits/g_inits must match problems ({len(problems)}), "
                    f"got {len(f_inits)}/{len(g_inits)}")
            for i, (fi, gi) in enumerate(zip(f_inits, g_inits)):
                if (fi is None) != (gi is None):
                    raise ValueError(f"problem {i}: pass both f_init and "
                                     "g_init (or neither)")
        groups: Dict[OTBatchShape, List[int]] = {}
        datas: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        for i, p in enumerate(problems):
            if float(p.eps) != float(self.eps):
                raise ValueError(
                    f"problem {i} declares eps={p.eps} but this engine "
                    f"solves at eps={self.eps}; build one engine per eps")
            ka, kb = self.kernel_data(p)
            datas[i] = (ka, kb)
            groups.setdefault(self.batch_shape(ka, kb), []).append(i)

        out: List[Optional[SinkhornResult]] = [None] * len(problems)
        for shape, idxs in groups.items():
            kas, kbs, aws, bws, f0s, g0s = [], [], [], [], [], []
            warm = f_inits is not None and any(
                f_inits[i] is not None for i in idxs)
            for i in idxs:
                p = problems[i]
                ka, kb = self.pad_kernel_data(*datas[i], shape)
                kas.append(ka)
                kbs.append(kb)
                aws.append(_pad_rows(p.a, shape.n_pad, replicate=False))
                bws.append(_pad_rows(p.b, shape.m_pad, replicate=False))
                if warm:
                    fi, gi = f_inits[i], g_inits[i]
                    if fi is None:                 # cold lane: zeros == cold
                        fi = torch.zeros_like(p.a)
                        gi = torch.zeros_like(p.b)
                    f0s.append(_pad_rows(fi, shape.n_pad, replicate=False))
                    g0s.append(_pad_rows(gi, shape.m_pad, replicate=False))
            inits = (torch.stack(f0s), torch.stack(g0s)) if warm else ()
            res = self.solve_stacked(torch.stack(kas), torch.stack(kbs),
                                     torch.stack(aws), torch.stack(bws),
                                     *inits)
            for j, i in enumerate(idxs):
                out[i] = unpad_result(res, j, problems[i].a.shape[0],
                                      problems[i].b.shape[0])
        return out

    # -- bucketing / padding helpers -----------------------------------------

    def kernel_data(self, p: OTProblem) -> Tuple[torch.Tensor, torch.Tensor]:
        """One problem's kernel under this engine's method: (log-)features
        for the factored methods, the dense cost (twice) for the quadratic
        ones."""
        geom = p.geometry.rebuild_at(self.eps)
        if self.method == "factored":
            return geom.features()
        if self.method in ("log_factored", "accelerated"):
            return geom.log_features()
        C = geom.cost_matrix()
        return C, C

    def batch_shape(self, ka: torch.Tensor, kb: torch.Tensor) -> OTBatchShape:
        """The bucket cell one problem's kernel data lands in: the key the
        ragged path groups by."""
        if self.method in self._QUADRATIC:
            return OTBatchShape.for_quadratic(ka.shape[0], ka.shape[1])
        return OTBatchShape.for_problem(ka.shape[0], kb.shape[0],
                                        ka.shape[1])

    def pad_kernel_data(self, ka: torch.Tensor, kb: torch.Tensor,
                        shape: OTBatchShape
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pad one problem's kernel data up to its bucket cell (replicated
        rows: exact, the added atoms carry zero weight)."""
        if self.method in self._QUADRATIC:
            ka = _pad_rows(ka, shape.n_pad, replicate=True)
            ka = _pad_rows(ka.T, shape.m_pad, replicate=True).T.contiguous()
            return ka, ka
        return (_pad_rows(ka, shape.n_pad, replicate=True),
                _pad_rows(kb, shape.m_pad, replicate=True))


def unpad_result(res: SinkhornResult, j: int, n: int, m: int
                 ) -> SinkhornResult:
    """Problem ``j`` of a stacked bucket result without its padded atoms:
    the inverse of the engine's bucket padding."""
    return SinkhornResult(
        u=res.u[j, :n], v=res.v[j, :m], f=res.f[j, :n], g=res.g[j, :m],
        cost=res.cost[j], n_iter=int(res.n_iter[j]),
        marginal_err=res.marginal_err[j], converged=res.converged[j])


# ---------------------------------------------------------------------------
# Engine cache: LRU over solver configurations
# ---------------------------------------------------------------------------
#
# Every distinct configuration owns a BatchedSinkhorn and with it the
# captured loops of its runners, so the cache is a bounded LRU: the least
# recently used engine, its graphs and buffers go once the cap is hit.

_ENGINE_CACHE: "OrderedDict[Tuple, BatchedSinkhorn]" = OrderedDict()
_ENGINE_CACHE_CAPACITY = 8
_ENGINE_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def engine_cache_info() -> Dict[str, int]:
    """Size, capacity, hits, misses and evictions of the ``solve_many``
    engine cache (a copy, safe to diff across calls)."""
    return dict(size=len(_ENGINE_CACHE), capacity=_ENGINE_CACHE_CAPACITY,
                **_ENGINE_CACHE_STATS)


def set_engine_cache_capacity(capacity: int) -> None:
    """Re-cap the engine LRU; evicts the oldest engines at once if the new
    cap is below the current size."""
    global _ENGINE_CACHE_CAPACITY
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    _ENGINE_CACHE_CAPACITY = capacity
    while len(_ENGINE_CACHE) > _ENGINE_CACHE_CAPACITY:
        _ENGINE_CACHE.popitem(last=False)
        _ENGINE_CACHE_STATS["evictions"] += 1


def clear_engine_cache() -> None:
    _ENGINE_CACHE.clear()
    for k in _ENGINE_CACHE_STATS:
        _ENGINE_CACHE_STATS[k] = 0


def get_engine(*, eps: float, method: str = "log_factored",
               tol: float = 1e-6, max_iter: int = 2000,
               momentum: float = 1.0, use_pallas: Optional[bool] = None,
               inner_steps: Optional[int] = None,
               check_every: Optional[int] = None,
               precision: str = "highest") -> BatchedSinkhorn:
    """The cached :class:`BatchedSinkhorn` of a solver configuration: a
    hit refreshes its recency; a miss builds the engine and may evict the
    least recently used one (its captured loops go with it)."""
    key = (method, float(eps), float(tol), int(max_iter), float(momentum),
           use_pallas, inner_steps, check_every, precision)
    engine = _ENGINE_CACHE.get(key)
    if engine is not None:
        _ENGINE_CACHE.move_to_end(key)
        _ENGINE_CACHE_STATS["hits"] += 1
        return engine
    _ENGINE_CACHE_STATS["misses"] += 1
    engine = BatchedSinkhorn(
        eps=eps, method=method, tol=tol, max_iter=max_iter,
        momentum=momentum, use_pallas=use_pallas, inner_steps=inner_steps,
        check_every=check_every, precision=precision)
    _ENGINE_CACHE[key] = engine
    while len(_ENGINE_CACHE) > _ENGINE_CACHE_CAPACITY:
        _ENGINE_CACHE.popitem(last=False)
        _ENGINE_CACHE_STATS["evictions"] += 1
    return engine


def _refuse_mesh(inits: bool) -> None:
    if inits:
        raise ValueError(
            "solve_many(mesh=...) dispatches problems one at a time; "
            "per-problem warm starts are a batched-engine feature: drop "
            "mesh= or the inits")
    raise NotImplementedError(
        "solve_many(mesh=...) runs the sharded methods, which are not "
        "ported to repro_torch yet (ROADMAP.md, queue A: distributed)")


def _host(x) -> Optional[torch.Tensor]:
    return None if x is None else x.detach().cpu()


def _recover_lanes(specs, results, f_inits, g_inits) -> None:
    """Send each failed lane of a batched ``solve_many(specs)`` up the
    recovery ladder alone, seeded with its batched result (lanes are
    independent, so a failed lane never touched its siblings and only the
    failures pay for retries)."""
    from ..resilience.health import classify
    from ..resilience.ladder import solve_with_recovery

    accept = specs[0].recovery.accept
    for i, res in enumerate(results):
        p = specs[i].problem()
        h = classify(res, f_init=_host(f_inits[i] if f_inits else None),
                     g_init=_host(g_inits[i] if g_inits else None),
                     a=_host(p.a), b=_host(p.b))
        if h.verdict not in accept:
            results[i] = solve_with_recovery(specs[i],
                                             first_attempt=res).result


def solve_many(problems, *, method: str = "log_factored",
               eps: Optional[float] = None, tol: float = 1e-6,
               max_iter: int = 2000, momentum: float = 1.0,
               use_pallas: Optional[bool] = None,
               inner_steps: Optional[int] = None,
               check_every: Optional[int] = None,
               precision: str = "highest", mesh=None,
               f_inits: Optional[Sequence[Optional[torch.Tensor]]] = None,
               g_inits: Optional[Sequence[Optional[torch.Tensor]]] = None
               ) -> List[SinkhornResult]:
    """Batched solve of a ragged problem list through the cached engine of
    its configuration (:func:`get_engine`), so calls in a loop reuse the
    engine's captured loops.

    ``eps`` defaults to the problems' shared eps; mixed-eps lists are
    refused. ``f_inits``/``g_inits`` warm-start individual problems (see
    :meth:`BatchedSinkhorn.solve_many`).

    The preferred form is a sequence of
    :class:`~repro_torch.core.spec.SolveSpec`: they must share one method,
    tol, max_iter, momentum, policy and recovery (engines are
    per-configuration), and take no schedule, rank or key; the solver
    kwargs above are then ignored except ``f_inits``/``g_inits``. With
    ``recovery`` set, each lane whose verdict the policy does not accept
    climbs the ladder alone, from its batched result. The
    execution kwargs with bare problems emit a ``DeprecationWarning``.
    ``mesh=`` (sharded solves) is not ported and raises."""
    if not problems:
        return []
    from .spec import SolveSpec     # spec imports this module

    if isinstance(problems[0], SolveSpec):
        specs = list(problems)
        head = specs[0]
        shared = (head.method, head.tol, head.max_iter, head.momentum,
                  head.policy, head.recovery)
        for s_ in specs:
            if not isinstance(s_, SolveSpec):
                raise TypeError(
                    "solve_many: mixed SolveSpec and OTProblem entries")
            if (s_.method, s_.tol, s_.max_iter, s_.momentum, s_.policy,
                    s_.recovery) != shared:
                raise ValueError(
                    "solve_many(specs) needs one shared method/tol/"
                    "max_iter/momentum/policy/recovery across specs "
                    "(engines are per-configuration); call solve(spec) "
                    "per problem for heterogeneous configs")
            if s_.schedule is not None or s_.rank is not None \
                    or s_.key is not None:
                raise ValueError(
                    "solve_many(specs) does not support schedule/rank/"
                    "key; call solve(spec) per problem")
        pol = head.policy
        eps_set = {float(s_.eps) for s_ in specs}
        if len(eps_set) != 1:
            raise ValueError(
                f"mixed spec eps {sorted(eps_set)}; batched engines are "
                "per-eps: group specs by eps")
        eng_method = "log_factored" if head.method == "auto" else head.method
        with pol.scope():
            engine = get_engine(
                eps=eps_set.pop(), method=eng_method, tol=head.tol,
                max_iter=head.max_iter, momentum=head.momentum,
                use_pallas=pol.use_pallas, inner_steps=pol.inner_steps,
                check_every=pol.check_every, precision=pol.precision)
            results = engine.solve_many([s_.problem() for s_ in specs],
                                        f_inits=f_inits, g_inits=g_inits)
        if head.recovery is not None:
            _recover_lanes(specs, results, f_inits, g_inits)
        return results
    _warn_legacy("solve_many", use_pallas, inner_steps, check_every,
                 precision)
    eps_set = {float(p.eps) for p in problems}
    if eps is None:
        if len(eps_set) != 1:
            raise ValueError(f"mixed problem eps {sorted(eps_set)}; pass eps=")
        eps = eps_set.pop()
    if mesh is not None:
        _refuse_mesh(f_inits is not None or g_inits is not None)
    engine = get_engine(
        eps=eps, method=method, tol=tol, max_iter=max_iter,
        momentum=momentum, use_pallas=use_pallas, inner_steps=inner_steps,
        check_every=check_every, precision=precision)
    return engine.solve_many(problems, f_inits=f_inits, g_inits=g_inits)
