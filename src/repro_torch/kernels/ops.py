"""Fused solve plans over the hand-written kernels.

``geometry_ops`` consumes the Geometry layer's ``pallas_ops()`` hook (the
name is kept from the JAX package so the two read side by side): the
geometry declares its cost family and this module maps it to kernels. In
log mode, the plan of every family the port has is :func:`_log_plan`:

* ``gaussian`` — the fused feature map with ``log_space=True`` builds the
  log-factors once per solve;
* ``log_factored`` — the log-factors as given;
* ``factored`` — the masked log of the linear factors.

Each iteration then runs ``log_halfstep`` three times and
``log_feature_contract`` twice. The scaling plan needs the scaling trio
(``feature_contract`` / ``sinkhorn_halfstep`` / ``feature_matvec``), which
is not ported yet: ``mode="scaling"`` raises for every kind. There is no
persistent megakernel either (``make_block_step`` is ``None``), so the
cadence is one iteration per step. Counterpart of ``repro.kernels.ops``.

``observe_plan_selection`` is the test hook: while it is active every plan
installed on a solve path appends an event dict.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from .feature_map import gaussian_feature_map
from .logmatvec import log_feature_contract, log_halfstep

__all__ = [
    "PRECISIONS",
    "check_precision",
    "relax_scaling",
    "relax_log",
    "GeometryOps",
    "geometry_ops",
    "observe_plan_selection",
    "notify_plan_selected",
]

PRECISIONS = ("highest", "bf16")

SCALING_PLAN_TODO = (
    "the scaling plan (mode='scaling') needs the scaling kernel trio "
    "feature_contract / sinkhorn_halfstep / feature_matvec, which is not "
    "ported yet (ROADMAP.md, queue A, next item: the scaling trio, queue B "
    "items 2-4); use use_pallas=False for the plain torch operators, or a "
    "log-domain method"
)


def check_precision(precision: str) -> str:
    """Validate a ``precision=`` value. ``"bf16"`` factor storage is not
    ported yet and raises ``NotImplementedError``."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    if precision == "bf16":
        raise NotImplementedError(
            "precision='bf16' (bf16 factor storage) is not ported yet "
            "(ROADMAP.md, queue A: bf16 factor storage); use 'highest'")
    return precision


def relax_scaling(new: torch.Tensor, old: torch.Tensor,
                  momentum: float) -> torch.Tensor:
    """Geometric over-relaxation ``u <- old^{1-w} * new^w``; zero scalings
    (dead atoms) take ``new`` verbatim, so ``0^{1-w} * 0`` never makes NaN."""
    if momentum == 1.0:
        return new
    mixed = old ** (1.0 - momentum) * new ** momentum
    return torch.where((old > 0) & (new > 0), mixed, new)


def relax_log(new: torch.Tensor, old: torch.Tensor,
              momentum: float) -> torch.Tensor:
    """Log-space over-relaxation ``f <- (1-w) old + w new``; ``-inf``
    potentials (dead atoms) take ``new`` verbatim."""
    if momentum == 1.0:
        return new
    mixed = (1.0 - momentum) * old + momentum * new
    return torch.where(torch.isfinite(old) & torch.isfinite(new), mixed, new)


def _masked_log(w: torch.Tensor) -> torch.Tensor:
    """log w with log(0) pinned to -inf (local twin of
    ``core.geometry._masked_log``: kernels do not import core)."""
    pos = w > 0
    return torch.where(pos, torch.log(torch.where(pos, w, torch.ones_like(w))),
                       torch.full_like(w, -torch.inf))


class GeometryOps(NamedTuple):
    """Fused execution plan for one geometry's cost family.

    ``mode``      — "log" (the only mode ported: potentials, log-factors).
    ``kind``      — the ``pallas_ops()`` spec kind the plan was built from.
    ``features``  — the materialized log-factors ``(log_xi, log_zeta)``.
    ``iteration`` — one full fused iteration ``(loga, logb, f) -> (f', g)``
                    on (n, B) / (m, B) columns.
    ``make_step`` — ``(a, b, *, momentum) -> (step, init)``: ``step`` is
                    drop-in for ``core.sinkhorn.run_marginal_loop`` and
                    matches ``make_log_step`` over the geometry's plain
                    operators; ``init`` lifts ``(f0, g0)`` into the carry
                    ``(f, g, t1)`` with ``t1 = LSE(logXi + f/eps)``.
    ``eps``       — the regularization the potentials live at.
    ``make_block_step`` — the persistent megakernel; not ported (``None``).
    ``precision`` — "highest" (float32 factors and accumulation).
    """

    mode: str
    kind: str
    features: Tuple[torch.Tensor, torch.Tensor]
    iteration: Callable
    make_step: Callable
    eps: float
    make_block_step: Optional[Callable] = None
    precision: str = "highest"


def _log_plan(kind: str, log_xi: torch.Tensor, log_zeta: torch.Tensor,
              eps: float, precision: str = "highest") -> GeometryOps:
    log_xi, log_zeta = log_xi.contiguous(), log_zeta.contiguous()

    def iteration(loga, logb, f):
        t = log_feature_contract(log_xi, f / eps)
        g = log_halfstep(log_zeta, t, logb, scale=eps)
        s = log_feature_contract(log_zeta, g / eps)
        return log_halfstep(log_xi, s, loga, scale=eps), g

    def contract_f(f):
        """Stage-1 LSE over logXi: computed once per iteration, it serves
        both the convergence check and the next iteration's g-update."""
        return log_feature_contract(log_xi, f[:, None] / eps)

    def make_step(a, b, *, momentum: float = 1.0):
        loga = _masked_log(a)[:, None].contiguous()
        logb = _masked_log(b)[:, None].contiguous()
        zero = torch.zeros_like(logb)

        def step(carry):
            f, g, t1 = carry
            g_new = relax_log(
                log_halfstep(log_zeta, t1, logb, scale=eps)[:, 0], g,
                momentum)
            t2 = log_feature_contract(log_zeta, g_new[:, None] / eps)
            f_new = relax_log(
                log_halfstep(log_xi, t2, loga, scale=eps)[:, 0], f, momentum)
            t3 = contract_f(f_new)
            lse = log_halfstep(log_zeta, t3, zero, scale=-1.0)[:, 0]
            log_col = lse + g_new / eps
            err = torch.sum(torch.abs(torch.exp(log_col) - b))
            return (f_new, g_new, t3), err

        def init(f0, g0):
            return (f0, g0, contract_f(f0))

        return step, init

    return GeometryOps(mode="log", kind=kind, features=(log_xi, log_zeta),
                       iteration=iteration, make_step=make_step, eps=eps,
                       precision=precision)


def geometry_ops(geom, *, mode: str = "log",
                 precision: str = "highest") -> Optional[GeometryOps]:
    """Fused-kernel plan for ``geom``, chosen by the geometry itself, or
    ``None`` when it declares no fused path (dense costs): callers then run
    the geometry's plain torch operators."""
    if mode not in ("scaling", "log"):
        raise ValueError(f"unknown plan mode {mode!r}")
    check_precision(precision)
    spec = geom.pallas_ops()
    if spec is None:
        return None
    kind = spec["kind"]
    if kind not in ("factored", "log_factored", "gaussian"):
        raise ValueError(f"unknown pallas_ops spec kind {kind!r}")
    if mode == "scaling":
        raise NotImplementedError(f"{kind}: {SCALING_PLAN_TODO}")
    if kind == "factored":
        return _log_plan(kind, _masked_log(spec["xi"]),
                         _masked_log(spec["zeta"]), float(geom.eps),
                         precision)
    if kind == "log_factored":
        return _log_plan(kind, spec["log_xi"], spec["log_zeta"],
                         float(spec["eps"]), precision)
    kw = dict(anchors=spec["anchors"], log_const=spec["log_const"],
              inv_eps=spec["inv_eps"], log_space=True)
    log_xi = gaussian_feature_map(spec["x"], **kw)
    log_zeta = gaussian_feature_map(spec["y"], **kw)
    return _log_plan(kind, log_xi, log_zeta, float(geom.eps), precision)


# ---------------------------------------------------------------------------
# Plan-selection hook (test observability)
# ---------------------------------------------------------------------------

_PLAN_OBSERVERS: List[Callable[[dict], None]] = []


def notify_plan_selected(event: dict) -> None:
    """Called by the solvers when a fused plan is installed on a hot loop."""
    for cb in list(_PLAN_OBSERVERS):
        cb(dict(event))


@contextlib.contextmanager
def observe_plan_selection():
    """``with observe_plan_selection() as ev: solve(...)`` collects one
    dict (``geometry`` / ``mode`` / ``kind`` / ``precision``) per plan
    selection."""
    events: List[dict] = []
    _PLAN_OBSERVERS.append(events.append)
    try:
        yield events
    finally:
        _PLAN_OBSERVERS.remove(events.append)
