"""Fused solve plans over the hand-written kernels.

``geometry_ops`` consumes the Geometry layer's ``pallas_ops()`` hook (the
name is kept from the JAX package so the two read side by side): the
geometry declares its cost family and this module maps it to kernels, in
one of two modes.

``mode="scaling"`` is Algorithm 1 on the factors, :func:`_scaling_plan`:

* ``gaussian`` — the fused feature map with ``log_space=False`` builds the
  factors once per solve;
* ``log_factored`` — ``exp`` of the log-factors;
* ``factored`` — the factors as given.

Each iteration runs ``feature_contract`` twice, the fused
``sinkhorn_halfstep`` once (``feature_matvec`` and ``relax_scaling`` in its
place at momentum other than 1) and ``feature_matvec`` once for the carried
``s = K^T u``.

``mode="log"`` is the log-domain twin, :func:`_log_plan`:

* ``gaussian`` — the fused feature map with ``log_space=True`` builds the
  log-factors once per solve;
* ``log_factored`` — the log-factors as given;
* ``factored`` — the masked log of the linear factors.

Each iteration then runs ``log_halfstep`` three times and
``log_feature_contract`` twice.

In both modes ``make_block_step`` runs ``inner_steps`` iterations in one
launch of the megakernel (``sinkhorn_block`` or ``log_sinkhorn_block``)
where ``fused_loop.block_plan_fits`` admits the shape, and returns ``None``
elsewhere, where the solvers take the streaming per-iteration step.
``precision="bf16"`` stores the factors in bfloat16 (cast after the
feature map, as the JAX package casts them); every kernel accumulates in
float32.

``paged`` (``core.paged.PagedFactored``, the streaming stores' geometry)
runs, in scaling mode, :func:`_paged_scaling_plan`: the plan above with
the paged kernels, which skip every page with no live slot. It has no
megakernel (``make_block_step`` is ``None``). Unlike the JAX package,
which refuses the paged kernels on a GPU backend, the port always takes
them in scaling mode. In log mode a paged geometry runs :func:`_log_plan`
on its full-capacity log-factors: dead slots have zero weight, so their
potentials are pinned to ``-inf`` and drop out of every LSE. Counterpart
of ``repro.kernels.ops``.

The scaling and log plans also run P problems stacked on a leading axis
(``(P, n, r)`` factors, ``(P, n)`` weights and carries, one error a
problem): every kernel launch then serves all P problems, the port's
counterpart of the JAX package's ``vmap`` over its kernels, which adds the
problems as a leading grid axis (``repro.kernels.ops.
fused_batched_sinkhorn_iteration``). :func:`stacked_ops` builds such a plan
from stacked factors, or from flattened ``(P * n, d)`` point clouds with
shared anchors, whose Lemma-1 features are per point and so need no
problem axis in the feature map. The megakernels take the problem axis
too, one thread block cluster a problem: ``make_block_step`` advances all
P problems ``inner_steps`` iterations in one launch wherever
``fused_loop.block_plan_fits`` admits one problem's shape, as the JAX
package's ``vmap`` over its megakernel does.

A spec carrying a mesh axis (``spmd``: ``distributed.sharding.MeshAxis``,
from ``core.sharded``'s geometries) gives the SHARDED plan: the factors
are this rank's rows, and the plan's iteration holds one collective
between the stage that sums over the support and the stage that does not
(the scaling contract's r-vector all-reduced, the log contract's combined
by MAX and SUM), with the marginal error all-reduced. It has no
megakernel (its block would drop the collective) and no stacked or paged
form.

``observe_plan_selection`` is the test hook: while it is active every plan
installed on a solve path appends an event dict.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from .feature_map import gaussian_feature_map
from .fused_loop import block_plan_fits, log_sinkhorn_block, sinkhorn_block
from .kermatvec import feature_contract, feature_matvec, sinkhorn_halfstep
from .logmatvec import log_feature_contract, log_halfstep, log_matvec
from .paged import paged_feature_contract, paged_feature_matvec, paged_halfstep
from .ref import relax_log, relax_scaling

__all__ = [
    "PRECISIONS",
    "check_precision",
    "relax_scaling",
    "relax_log",
    "feature_contract",
    "sinkhorn_halfstep",
    "feature_matvec",
    "log_matvec",
    "fused_sinkhorn_iteration",
    "batched_sinkhorn_halfstep",
    "fused_batched_sinkhorn_iteration",
    "GeometryOps",
    "geometry_ops",
    "stacked_ops",
    "observe_plan_selection",
    "notify_plan_selected",
]

PRECISIONS = ("highest", "bf16")


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


def fused_sinkhorn_iteration(xi: torch.Tensor, zeta: torch.Tensor,
                             a: torch.Tensor, b: torch.Tensor,
                             u: torch.Tensor):
    """One full Alg.-1 iteration through the kernels, on (n, B) / (m, B)
    columns::

        t  = Xi^T u ;   v  = b / (Zeta t)     (fused half-step)
        s  = Zeta^T v ; u' = a / (Xi s)       (fused half-step)

    Returns ``(u', v)``."""
    t = feature_contract(xi, u)
    v = sinkhorn_halfstep(zeta, t, b)
    s = feature_contract(zeta, v)
    return sinkhorn_halfstep(xi, s, a), v


def batched_sinkhorn_halfstep(xi: torch.Tensor, u: torch.Tensor,
                              marg: torch.Tensor,
                              zeta: torch.Tensor) -> torch.Tensor:
    """One fused half-step ``v_p = marg_p / (Xi_p (Zeta_p^T u_p))`` for P
    problems with their own factors: ``xi`` (P, n, r), ``u`` (P, m),
    ``marg`` (P, n), ``zeta`` (P, m, r) -> (P, n). One contract and one
    half-step launch serve all P."""
    t = feature_contract(zeta, u[..., None].contiguous())
    return sinkhorn_halfstep(xi, t, marg[..., None].contiguous())[..., 0]


def fused_batched_sinkhorn_iteration(xi: torch.Tensor, zeta: torch.Tensor,
                                     a: torch.Tensor, b: torch.Tensor,
                                     u: torch.Tensor):
    """One full Alg.-1 iteration for P independent problems, ``xi`` (P, n,
    r), ``zeta`` (P, m, r), ``a``/``u`` (P, n), ``b`` (P, m)::

        t_p = Xi_p^T u_p ;  v_p  = b_p / (Zeta_p t_p)
        s_p = Zeta_p^T v_p ; u_p' = a_p / (Xi_p s_p)

    Returns ``(u', v)`` stacked: four launches for all P problems."""
    v = batched_sinkhorn_halfstep(zeta, u, b, xi)
    return batched_sinkhorn_halfstep(xi, v, a, zeta), v


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over a problem's atoms: all of a 1-D tensor, the last axis
    of stacked problems (``core.sinkhorn.lane_sum``)."""
    return torch.sum(x) if x.dim() <= 1 else torch.sum(x, dim=-1)


class GeometryOps(NamedTuple):
    """Fused execution plan for one geometry's cost family.

    ``mode``      — "scaling" (scalings, factors) or "log" (potentials,
                    log-factors).
    ``kind``      — the ``pallas_ops()`` spec kind the plan was built from.
    ``features``  — the materialized factors the plan runs on: ``(xi,
                    zeta)`` in scaling mode, ``(log_xi, log_zeta)`` in log
                    mode, at their storage precision.
    ``iteration`` — one full fused iteration on (n, B) / (m, B) columns:
                    scaling ``(a, b, u) -> (u', v)``, log ``(loga, logb, f)
                    -> (f', g)``.
    ``make_step`` — ``(a, b, *, momentum) -> (step, init)``: ``step`` is
                    drop-in for ``core.sinkhorn.run_marginal_loop`` and
                    matches ``make_scaling_step`` / ``make_log_step`` over
                    the geometry's plain operators; ``init`` lifts the start
                    values into the carry, which holds the reusable
                    intermediate: ``(u, v, s)`` with ``s = K^T u`` in
                    scaling mode, ``(f, g, t1)`` with ``t1 = LSE(logXi +
                    f/eps)`` in log mode.
    ``eps``       — the regularization the kernel lives at.
    ``make_block_step`` — ``(a, b, *, inner_steps, momentum) ->
                    Optional[(step, init)]``: ``step`` advances
                    ``inner_steps`` iterations in one megakernel launch
                    over the same carry as ``make_step``; it returns
                    ``None`` where ``fused_loop.block_plan_fits`` refuses
                    the shape, and is itself ``None`` for a plan with no
                    megakernel (the paged plan).
    ``precision`` — "highest" (float32 factors) or "bf16" (bfloat16
                    factor storage); accumulation is float32 in both.
    ``init``      — ``(u0, v0) -> carry`` (``(f0, g0)`` in log mode), the
                    ``init`` both step kinds return.
    ``operands``  — every tensor the steps read besides the weights: the
                    factors, then the page tables of a paged plan.
    ``bind``      — ``operands -> GeometryOps``: the same plan over other
                    tensors of the operands' shapes and dtypes (a solve
                    runner's static buffers, ``core.runners``).
    ``page_size`` — the page of a paged geometry's plan (either mode), 0
                    otherwise.
    ``spmd``      — the mesh axis (``distributed.sharding.MeshAxis``) of a
                    sharded plan, whose factors are this rank's rows; None
                    for a plan on one device.

    A plan's steps read no value to the host, so a runner can capture
    them in a CUDA graph.
    """

    mode: str
    kind: str
    features: Tuple[torch.Tensor, torch.Tensor]
    iteration: Callable
    make_step: Callable
    eps: float
    make_block_step: Optional[Callable]
    precision: str = "highest"
    init: Optional[Callable] = None
    operands: Tuple[torch.Tensor, ...] = ()
    bind: Optional[Callable] = None
    page_size: int = 0
    spmd: Optional[object] = None

    def block_admits(self, n: int, m: int, P: int = 1) -> bool:
        """Whether ``make_block_step`` gives a megakernel step at n x m for
        P >= 1 stacked problems: the plan has one and
        ``fused_loop.block_plan_fits`` admits one problem's shape (each
        problem runs in a cluster of its own, so any P is admitted)."""
        xi = self.features[0]
        return (self.make_block_step is not None and P >= 1
                and block_plan_fits(n, m, xi.shape[-1], 1, xi.dtype))


def _identity(x):
    return x


def _scaling_plan(kind: str, xi: torch.Tensor, zeta: torch.Tensor,
                  eps: float, precision: str = "highest",
                  spmd=None) -> GeometryOps:
    """The scaling plan. With ``spmd`` (a mesh axis) the factors are this
    rank's rows and each contract's r-vector is summed over the ranks
    before the stage that does not sum over the support, as is the
    marginal error: the reference's psum'd iteration, each rank running
    the kernels on its rows. No megakernel then (its block would drop the
    collective)."""
    xi, zeta = _store_features(xi.contiguous(), zeta.contiguous(), precision)
    psum = _identity if spmd is None else spmd.sum_

    def contract(w, x):
        """``t = W^T x`` over every rank's rows."""
        return psum(feature_contract(w, x))

    def iteration(a, b, u):
        """``fused_sinkhorn_iteration`` over every rank's rows."""
        v = sinkhorn_halfstep(zeta, contract(xi, u), b)
        return sinkhorn_halfstep(xi, contract(zeta, v), a), v

    def apply_kt(u):
        """``u (n,) -> K^T u (m,)`` (a problem axis first where stacked)."""
        t = contract(xi, u[..., None].contiguous())
        return feature_matvec(zeta, t)[..., 0]

    def init(u0, v0):
        """The carry ``(u, v, s = K^T u)`` both step kinds advance."""
        return (u0, v0, apply_kt(u0))

    def make_step(a, b, *, momentum: float = 1.0):
        ac = a[..., None].contiguous()

        def step(carry):
            u, v, s = carry
            v_new = relax_scaling(b / s, v, momentum)
            t = contract(zeta, v_new[..., None].contiguous())
            if momentum == 1.0:
                # matvec and marginal divide fused in one pass
                u_new = sinkhorn_halfstep(xi, t, ac)[..., 0]
            else:
                kv = feature_matvec(xi, t)[..., 0]
                u_new = relax_scaling(a / kv, u, momentum)
            t2 = contract(xi, u_new[..., None].contiguous())
            s_new = feature_matvec(zeta, t2)[..., 0]
            err = psum(_lane_sum(torch.abs(v_new * s_new - b)))
            return (u_new, v_new, s_new), err

        return step, init

    def make_block_step(a, b, *, inner_steps: int, momentum: float = 1.0):
        """One launch of ``inner_steps`` iterations for every problem (a
        problem axis first where stacked), or ``None`` where
        ``block_plan_fits`` refuses one problem's shape."""
        n, m = a.shape[-1], b.shape[-1]
        if not block_plan_fits(n, m, xi.shape[-1], 1, xi.dtype):
            return None
        ac, bc = a[..., None].contiguous(), b[..., None].contiguous()

        def step(carry):
            u, v, s = carry
            u2, v2, s2, err = sinkhorn_block(
                xi, zeta, ac, bc, u[..., None].contiguous(),
                v[..., None].contiguous(), s[..., None].contiguous(),
                inner_steps=inner_steps, momentum=momentum)
            return (u2[..., 0], v2[..., 0], s2[..., 0]), err

        return step, init

    return GeometryOps(mode="scaling", kind=kind, features=(xi, zeta),
                       iteration=iteration, make_step=make_step, eps=eps,
                       make_block_step=(make_block_step if spmd is None
                                        else None),
                       precision=precision, init=init, operands=(xi, zeta),
                       bind=lambda ops: _scaling_plan(kind, *ops, eps,
                                                      precision, spmd),
                       spmd=spmd)


def _log_plan(kind: str, log_xi: torch.Tensor, log_zeta: torch.Tensor,
              eps: float, precision: str = "highest",
              spmd=None) -> GeometryOps:
    """The log plan. With ``spmd`` (a mesh axis) the log-factors are this
    rank's rows, each log contract's r-vector is combined over the ranks
    as ``distributed.psum_logsumexp`` combines it (MAX, then the SUM of
    the shifted exponentials, an all ``-inf`` slice pinned) before the
    local half-step, and the marginal error is summed over the ranks. No
    megakernel then."""
    log_xi, log_zeta = _store_features(log_xi.contiguous(),
                                       log_zeta.contiguous(), precision)
    psum = _identity if spmd is None else spmd.sum_
    combine = _identity if spmd is None else spmd.combine_lse

    def log_contract(log_w, s):
        """Stage 1 over every rank's rows."""
        return combine(log_feature_contract(log_w, s))

    def iteration(loga, logb, f):
        t = log_contract(log_xi, f / eps)
        g = log_halfstep(log_zeta, t, logb, scale=eps)
        s = log_contract(log_zeta, g / eps)
        return log_halfstep(log_xi, s, loga, scale=eps), g

    def contract_f(f):
        """Stage-1 LSE over logXi: computed once per iteration, it serves
        both the convergence check and the next iteration's g-update."""
        return log_contract(log_xi, f[..., None] / eps)

    def init(f0, g0):
        """The carry ``(f, g, t1)`` both step kinds advance."""
        return (f0, g0, contract_f(f0))

    def make_step(a, b, *, momentum: float = 1.0):
        loga = _masked_log(a)[..., None].contiguous()
        logb = _masked_log(b)[..., None].contiguous()
        zero = torch.zeros_like(logb)

        def step(carry):
            f, g, t1 = carry
            g_new = relax_log(
                log_halfstep(log_zeta, t1, logb, scale=eps)[..., 0], g,
                momentum)
            t2 = log_contract(log_zeta, g_new[..., None] / eps)
            f_new = relax_log(
                log_halfstep(log_xi, t2, loga, scale=eps)[..., 0], f,
                momentum)
            t3 = contract_f(f_new)
            lse = log_halfstep(log_zeta, t3, zero, scale=-1.0)[..., 0]
            log_col = lse + g_new / eps
            err = psum(_lane_sum(torch.abs(torch.exp(log_col) - b)))
            return (f_new, g_new, t3), err

        return step, init

    def make_block_step(a, b, *, inner_steps: int, momentum: float = 1.0):
        """One launch of ``inner_steps`` iterations for every problem (a
        problem axis first where stacked), or ``None`` where
        ``block_plan_fits`` refuses one problem's shape."""
        n, m = a.shape[-1], b.shape[-1]
        if not block_plan_fits(n, m, log_xi.shape[-1], 1, log_xi.dtype):
            return None
        loga = _masked_log(a)[..., None].contiguous()
        logb = _masked_log(b)[..., None].contiguous()
        bc = b[..., None].contiguous()

        def step(carry):
            f, g, t1 = carry
            f2, g2, t2, err = log_sinkhorn_block(
                log_xi, log_zeta, loga, logb, bc, f[..., None].contiguous(),
                g[..., None].contiguous(), t1, inner_steps=inner_steps,
                eps=eps, momentum=momentum)
            return (f2[..., 0], g2[..., 0], t2), err

        return step, init

    return GeometryOps(mode="log", kind=kind, features=(log_xi, log_zeta),
                       iteration=iteration, make_step=make_step, eps=eps,
                       make_block_step=(make_block_step if spmd is None
                                        else None),
                       precision=precision, init=init,
                       operands=(log_xi, log_zeta),
                       bind=lambda ops: _log_plan(kind, *ops, eps,
                                                  precision, spmd),
                       spmd=spmd)


def _paged_scaling_plan(kind: str, xi: torch.Tensor, zeta: torch.Tensor,
                        live_x: torch.Tensor, live_y: torch.Tensor,
                        page_size: int, eps: float,
                        precision: str = "highest") -> GeometryOps:
    """The scaling plan on paged factor buffers: every contract, half-step
    and matvec skips the pages with no live slot. Equal to
    :func:`_scaling_plan` wherever dead slots carry zero weight and
    scaling, the streaming stores' invariant. No megakernel."""
    # a bf16 store buffer passes through; a float32 one is cast here
    xi, zeta = _store_features(xi.contiguous(), zeta.contiguous(), precision)
    kw = dict(page_size=page_size)

    def iteration(a, b, u):
        t = paged_feature_contract(xi, u, live_x, **kw)
        v = paged_halfstep(zeta, t, b, live_y, **kw)
        s = paged_feature_contract(zeta, v, live_y, **kw)
        return paged_halfstep(xi, s, a, live_x, **kw), v

    def apply_kt(u):
        """``u (C_x,) -> K^T u (C_y,)``, 0 on dead pages."""
        t = paged_feature_contract(xi, u[:, None].contiguous(), live_x, **kw)
        return paged_feature_matvec(zeta, t, live_y, **kw)[:, 0]

    def init(u0, v0):
        return (u0, v0, apply_kt(u0))

    def make_step(a, b, *, momentum: float = 1.0):
        ac = a[:, None].contiguous()
        zero_a, zero_b = torch.zeros_like(a), torch.zeros_like(b)

        def step(carry):
            u, v, s = carry
            # the paged matvec writes zeros on dead pages, so b / s is 0 / 0
            # there: pinned to the flat plan's value (b = 0 -> v = 0)
            v_new = relax_scaling(torch.where(b > 0, b / s, zero_b), v,
                                  momentum)
            t = paged_feature_contract(zeta, v_new[:, None].contiguous(),
                                       live_y, **kw)
            if momentum == 1.0:
                u_new = paged_halfstep(xi, t, ac, live_x, **kw)[:, 0]
            else:
                kv = paged_feature_matvec(xi, t, live_x, **kw)[:, 0]
                u_new = relax_scaling(torch.where(a > 0, a / kv, zero_a), u,
                                      momentum)
            t2 = paged_feature_contract(xi, u_new[:, None].contiguous(),
                                        live_x, **kw)
            s_new = paged_feature_matvec(zeta, t2, live_y, **kw)[:, 0]
            err = torch.sum(torch.abs(v_new * s_new - b))
            return (u_new, v_new, s_new), err

        return step, init

    return GeometryOps(mode="scaling", kind=kind, features=(xi, zeta),
                       iteration=iteration, make_step=make_step, eps=eps,
                       make_block_step=None, precision=precision, init=init,
                       operands=(xi, zeta, live_x, live_y),
                       bind=lambda ops: _paged_scaling_plan(
                           kind, *ops, page_size, eps, precision),
                       page_size=page_size)


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
    return _spec_ops(spec, float(geom.eps), mode, precision)


def stacked_ops(spec: dict, *, problems: int, eps: float, mode: str,
                precision: str = "highest") -> GeometryOps:
    """The fused plan of ``problems`` stacked problems from a
    ``pallas_ops()``-shaped spec: kinds ``factored`` (``xi``/``zeta`` (P,
    n, r)/(P, m, r)), ``log_factored`` (``log_xi``/``log_zeta``) or
    ``gaussian`` (``x``/``y`` the P problems' clouds flattened to (P * n,
    d)/(P * m, d), shared ``anchors``: one feature map launch a side, the
    features viewed as (P, n, r))."""
    if mode not in ("scaling", "log"):
        raise ValueError(f"unknown plan mode {mode!r}")
    check_precision(precision)
    if spec["kind"] not in ("factored", "log_factored", "gaussian"):
        raise ValueError(f"no stacked plan for kind {spec['kind']!r}")
    return _spec_ops(dict(spec, eps=float(eps)), float(eps), mode, precision,
                     problems=int(problems))


def _spec_ops(spec: dict, eps: float, mode: str, precision: str,
              problems: int = 0) -> GeometryOps:
    """The plan of a ``pallas_ops()`` spec; ``problems`` P > 0 where its
    point clouds hold P problems flattened (the features are then viewed
    as (P, n, r))."""
    kind = spec["kind"]
    if kind not in ("factored", "log_factored", "gaussian", "paged"):
        raise ValueError(f"unknown pallas_ops spec kind {kind!r}")
    spmd = spec.get("spmd")
    if spmd is not None and (kind == "paged" or problems):
        raise ValueError(f"no sharded plan for kind {kind!r} with "
                         f"{problems} stacked problems")
    if kind == "paged":
        if "xi" in spec:
            xi, zeta = spec["xi"], spec["zeta"]
            lxi = lzt = None
        else:
            lxi, lzt = spec["log_xi"], spec["log_zeta"]
            xi, zeta = torch.exp(lxi), torch.exp(lzt)
        if mode == "log":
            if lxi is None:
                lxi, lzt = _masked_log(xi), _masked_log(zeta)
            return _log_plan(kind, lxi, lzt, float(spec["eps"]), precision
                             )._replace(page_size=int(spec["page_size"]))
        return _paged_scaling_plan(kind, xi, zeta, spec["page_live_x"],
                                   spec["page_live_y"],
                                   int(spec["page_size"]), eps, precision)
    if kind == "factored":
        xi, zeta = spec["xi"], spec["zeta"]
        if mode == "scaling":
            return _scaling_plan(kind, xi, zeta, eps, precision, spmd)
        return _log_plan(kind, _masked_log(xi), _masked_log(zeta), eps,
                         precision, spmd)
    if kind == "log_factored":
        lxi, lzt = spec["log_xi"], spec["log_zeta"]
        if mode == "log":
            return _log_plan(kind, lxi, lzt, float(spec["eps"]), precision,
                             spmd)
        return _scaling_plan(kind, torch.exp(lxi), torch.exp(lzt), eps,
                             precision, spmd)
    kw = dict(anchors=spec["anchors"], log_const=spec["log_const"],
              inv_eps=spec["inv_eps"], log_space=mode == "log")
    xi = gaussian_feature_map(spec["x"], **kw)
    zeta = gaussian_feature_map(spec["y"], **kw)
    if problems:
        xi = xi.view(problems, -1, xi.shape[-1])
        zeta = zeta.view(problems, -1, zeta.shape[-1])
    if mode == "scaling":
        return _scaling_plan(kind, xi, zeta, eps, precision, spmd)
    return _log_plan(kind, xi, zeta, eps, precision, spmd)


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
