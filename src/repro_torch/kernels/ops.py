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
``log_feature_contract`` twice; ``make_block_step`` runs ``inner_steps``
iterations in one launch of the megakernel ``log_sinkhorn_block`` where
``fused_loop.block_plan_fits`` admits the shape. ``precision="bf16"``
stores the log-factors in bfloat16 (cast after the feature map, as the JAX
package casts them); every kernel accumulates in float32. The scaling plan
needs the scaling trio (``feature_contract`` / ``sinkhorn_halfstep`` /
``feature_matvec``), which is not ported yet: ``mode="scaling"`` raises
for every kind. Counterpart of ``repro.kernels.ops``.

``observe_plan_selection`` is the test hook: while it is active every plan
installed on a solve path appends an event dict.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from .feature_map import gaussian_feature_map
from .fused_loop import block_plan_fits, log_sinkhorn_block
from .logmatvec import log_feature_contract, log_halfstep
from .ref import relax_log, relax_scaling

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
    """Validate a ``precision=`` value: ``"highest"`` (float32 factors) or
    ``"bf16"`` (bfloat16 factor storage, float32 accumulation)."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    return precision


def _store_features(xi: torch.Tensor, zeta: torch.Tensor, precision: str):
    """The storage half of the mixed-precision policy: ``"bf16"`` halves
    the bytes of the (n, r)/(m, r) factors every kernel streams, while
    every kernel widens them to float32 before it adds or sums."""
    check_precision(precision)
    if precision == "bf16":
        return xi.to(torch.bfloat16), zeta.to(torch.bfloat16)
    return xi, zeta


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
    ``make_block_step`` — ``(a, b, *, inner_steps, momentum) ->
                    Optional[(step, init)]``: ``step`` advances
                    ``inner_steps`` iterations in one megakernel launch
                    over the same carry as ``make_step``; ``None`` where
                    ``fused_loop.block_plan_fits`` refuses the shape.
    ``precision`` — "highest" (float32 factors) or "bf16" (bfloat16
                    factor storage); accumulation is float32 in both.
    """

    mode: str
    kind: str
    features: Tuple[torch.Tensor, torch.Tensor]
    iteration: Callable
    make_step: Callable
    eps: float
    make_block_step: Callable
    precision: str = "highest"


def _log_plan(kind: str, log_xi: torch.Tensor, log_zeta: torch.Tensor,
              eps: float, precision: str = "highest") -> GeometryOps:
    log_xi, log_zeta = _store_features(log_xi.contiguous(),
                                       log_zeta.contiguous(), precision)

    def iteration(loga, logb, f):
        t = log_feature_contract(log_xi, f / eps)
        g = log_halfstep(log_zeta, t, logb, scale=eps)
        s = log_feature_contract(log_zeta, g / eps)
        return log_halfstep(log_xi, s, loga, scale=eps), g

    def contract_f(f):
        """Stage-1 LSE over logXi: computed once per iteration, it serves
        both the convergence check and the next iteration's g-update."""
        return log_feature_contract(log_xi, f[:, None] / eps)

    def init(f0, g0):
        """The carry ``(f, g, t1)`` both step kinds advance."""
        return (f0, g0, contract_f(f0))

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

        return step, init

    def make_block_step(a, b, *, inner_steps: int, momentum: float = 1.0):
        n, m = a.shape[0], b.shape[0]
        if not block_plan_fits(n, m, log_xi.shape[1], 1, log_xi.dtype):
            return None
        loga = _masked_log(a)[:, None].contiguous()
        logb = _masked_log(b)[:, None].contiguous()
        bc = b[:, None].contiguous()

        def step(carry):
            f, g, t1 = carry
            f2, g2, t2, err = log_sinkhorn_block(
                log_xi, log_zeta, loga, logb, bc, f[:, None].contiguous(),
                g[:, None].contiguous(), t1, inner_steps=inner_steps,
                eps=eps, momentum=momentum)
            return (f2[:, 0], g2[:, 0], t2), err

        return step, init

    return GeometryOps(mode="log", kind=kind, features=(log_xi, log_zeta),
                       iteration=iteration, make_step=make_step, eps=eps,
                       make_block_step=make_block_step, precision=precision)


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
