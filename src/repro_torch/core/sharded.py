"""Sharded Sinkhorn over ``torch.distributed``: scaling space and log domain.

The factored kernel is what makes Sinkhorn distributable: shard the
SUPPORT of each measure over one dimension of a ``DeviceMesh`` (``"data"``
by default), p ranks each holding

    Xi   : (n/p, r)        Zeta : (m/p, r)
    u, a : (n/p,)          v, b : (m/p,)

Each half-iteration is a LOCAL thin contraction followed by ONE all-reduce
of an r-vector,

    t = all_reduce_sum( Xi_loc^T u_loc )          # r floats on the wire
    v_loc = b_loc / (Zeta_loc @ t)

and the log-domain twin moves the same r-vector: each rank's stage-1 LSE
over its rows is combined as ``distributed.psum_logsumexp`` combines it
(an all-reduce MAX, then the SUM of the shifted exponentials), after which
stage 2 is local. The marginal error and the dual value are all-reduced
too, so every rank leaves the loop together and holds the same cost.

Execution on the card: the geometry's fused plan carries the collective
(``kernels.ops``: ``_scaling_plan`` / ``_log_plan`` with a mesh axis), so
each rank runs the hand-written contract and half-step kernels on its
rows; the megakernels stay off (their block would drop the collective)
and the loop is the eager host loop, one host read a check block (a
captured graph cannot hold a gloo collective). ``use_pallas=False`` runs
the all-reduced plain operators instead (:class:`RowShardedGeometry`'s
``operators`` / ``log_operators``), the yardstick; on the CPU the plan runs
the kernels' plain versions. The JAX package runs plain XLA operators
here, since its Pallas plan has no psum inside.

The contract is the JAX package's:

* every rank passes the GLOBAL problem; supports are padded to a multiple
  of p with zero-weight atoms, whose initial potentials are ``-inf`` (log)
  and scalings 0 (scaling space), so they add nothing to any sum or LSE
  from iteration 0 and the result matches the UNPADDED solve;
* each rank takes its rows: point-cloud families (Gaussian, arc-cosine)
  build only their local feature rows and replicate the anchors; explicit
  factors shard their rows; a feature-capable family with no row rule
  (the paged stores' geometry) materializes its global factors once, and
  one with no positive factors (Nystrom, dense costs, grids) is refused;
* the result is gathered, unpadded and identical on every rank.

:func:`sharded_sinkhorn_divergence` differentiates through
``grad.rot_geometry``'s envelope VJP on the sharded geometry: its
correlation is each rank's share (its rows), the r-vector's all-reduce
sums the ranks' cotangents, and the boundaries (``distributed.shard_rows``
/ ``replicate``) gather the row-sharded leaves' gradients and sum the
replicated ones (shared anchors), so every gradient equals the
single-process one on every rank. Counterpart of ``repro.core.sharded``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..distributed.sharding import (
    MeshAxis,
    psum_logsumexp,
    replicate,
    shard_rows,
)
from ..kernels.ref import lse
from .api import _pad_rows
from .geometry import (
    ArcCosinePointCloud,
    FactoredPositive,
    GaussianPointCloud,
    Geometry,
    _compute,
    _stored,
)
from .grad import rot_geometry
from .sinkhorn import SinkhornResult, sinkhorn_geometry, sinkhorn_log_geometry

__all__ = [
    "RowShardedFactored",
    "RowShardedGeometry",
    "sharded_sinkhorn_factored",
    "sharded_sinkhorn_geometry",
    "sharded_sinkhorn_divergence",
    "make_sharded_sinkhorn",
]


# ---------------------------------------------------------------------------
# All-reduced factored operators (shared by both sharded geometries)
# ---------------------------------------------------------------------------


class _PsumOps:
    """The all-reduced operator surface, derived from the host class's
    LOCAL ``features()`` / ``log_features()``, its ``eps`` and its mesh
    ``axis``: one implementation for both sharded geometries, so the
    collective wiring cannot drift between them."""

    @property
    def spmd(self) -> MeshAxis:
        """The mesh axis the operators, the marginal error and the dual
        value reduce over (``core.sinkhorn.geometry_reduce``)."""
        return self.axis

    def operators(self, *, precision: str = "highest"):
        # bf16 storage composes with sharding: the LOCAL rows are stored in
        # bf16, the all-reduced r-vector stays float32
        xi, zeta = (_stored(w, precision) for w in self.features())
        psum = self.axis.sum_
        return (lambda v: _compute(xi) @ psum(_compute(zeta).T @ v),
                lambda u: _compute(zeta) @ psum(_compute(xi).T @ u))

    def log_operators(self, *, precision: str = "highest"):
        """The exact two-stage LSE with its first stage (over the sharded
        support) through :func:`psum_logsumexp`; differentiable, as the
        envelope VJP needs."""
        eps, axis = self.eps, self.axis
        lxi, lzt = (_stored(w, precision) for w in self.log_features())

        def apply(log_u, log_w, s):
            t = psum_logsumexp(_compute(log_w) + s[..., :, None], axis,
                               dim=-2)
            return lse(_compute(log_u) + t[..., None, :], dim=-1)

        return (lambda g: apply(lxi, lzt, g / eps),
                lambda f: apply(lzt, lxi, f / eps))

    def apply_k(self, v):
        return self.operators()[0](v)

    def apply_kt(self, u):
        return self.operators()[1](u)

    def log_apply_k(self, g):
        return self.log_operators()[0](g)

    def log_apply_kt(self, f):
        return self.log_operators()[1](f)

    def _sharded_spec(self, spec: Optional[dict]) -> Optional[dict]:
        """The local rows' fused-plan spec with the mesh axis, which puts
        the collective inside the plan (``kernels.ops``)."""
        return None if spec is None else dict(spec, spmd=self.axis)


@dataclasses.dataclass(frozen=True, eq=False)
class RowShardedFactored(_PsumOps, FactoredPositive):
    """One rank's shard of a factored geometry: ``xi``/``zeta`` (or
    ``log_xi``/``log_zeta``) hold the LOCAL (n/p, r) / (m/p, r) rows and
    the operators reduce the shared r-vector over ``axis``, the only
    traffic an iteration."""

    axis: Optional[MeshAxis] = dataclasses.field(default=None, kw_only=True)

    def xx(self) -> "RowShardedFactored":
        lxi, _ = self.log_features()
        return RowShardedFactored(log_xi=lxi, log_zeta=lxi, eps=self.eps,
                                  axis=self.axis)

    def yy(self) -> "RowShardedFactored":
        _, lzt = self.log_features()
        return RowShardedFactored(log_xi=lzt, log_zeta=lzt, eps=self.eps,
                                  axis=self.axis)

    def pallas_ops(self):
        return self._sharded_spec(FactoredPositive.pallas_ops(self))


@dataclasses.dataclass(frozen=True, eq=False)
class RowShardedGeometry(_PsumOps, Geometry):
    """One rank's shard of ANY feature-capable geometry: ``base`` carries
    the LOCAL rows of the wrapped family (point clouds their local support
    rows, anchors whole, deriving local feature rows; explicit factors
    their local rows). Its tensors are the base's, so the envelope VJP
    differentiates them."""

    base: Geometry
    axis: MeshAxis

    @property
    def eps(self) -> float:
        return self.base.eps

    @property
    def shape(self) -> Tuple[int, int]:
        return self.base.shape              # the LOCAL (n/p, m/p) shard

    @property
    def supports_log(self) -> bool:
        return self.base.supports_log

    @property
    def supports_features(self) -> bool:
        return self.base.supports_features

    def tensor_paths(self):
        return self.base.tensor_paths()

    def tensors(self):
        return self.base.tensors()

    def with_tensors(self, paths, tensors) -> "RowShardedGeometry":
        return dataclasses.replace(self,
                                   base=self.base.with_tensors(paths, tensors))

    def features(self):
        return self.base.features()         # local rows

    def log_features(self):
        return self.base.log_features()

    def cost_matrix(self):
        raise ValueError(
            "RowShardedGeometry has no dense cost view: each rank holds "
            "only its local support rows; densify the wrapped geometry "
            "instead")

    def xx(self) -> "RowShardedGeometry":
        return RowShardedGeometry(self.base.xx(), self.axis)

    def yy(self) -> "RowShardedGeometry":
        return RowShardedGeometry(self.base.yy(), self.axis)

    def pallas_ops(self):
        return self._sharded_spec(self.base.pallas_ops())


# ---------------------------------------------------------------------------
# Host plumbing: which fields shard, padding, the local geometry
# ---------------------------------------------------------------------------

# Geometry family -> fields whose rows shard over the mesh axis; every other
# tensor field (shared anchors) replicates. First-measure fields have n
# rows, second-measure fields m.
_ROW_SHARDED_FIELDS = {
    FactoredPositive: ("xi", "zeta", "log_xi", "log_zeta"),
    GaussianPointCloud: ("x", "y"),
    ArcCosinePointCloud: ("x", "y"),
}
_N_FIELDS = ("xi", "log_xi", "x")


def _row_sharded_fields(geom: Geometry) -> Optional[Tuple[str, ...]]:
    for cls in type(geom).__mro__:
        if cls in _ROW_SHARDED_FIELDS:
            return _ROW_SHARDED_FIELDS[cls]
    return None


def _auto_mode(geom: Geometry) -> str:
    """Scaling vs log as the local auto table (``api._auto_method``):
    explicit linear factors run the scaling iteration, every other family
    the small-eps-safe log domain."""
    if isinstance(geom, FactoredPositive) and geom.xi is not None:
        return "scaling"
    return "log"


def _prepare(mesh, geom: Geometry, axis: str):
    """The mesh axis and the geometry as a shardable family: families with
    a row rule pass (point clouds never materialize global features);
    other feature-capable families materialize their global factors once;
    the rest are refused."""
    spmd = MeshAxis(mesh, axis)
    if isinstance(geom, RowShardedGeometry):
        geom = geom.base
    if _row_sharded_fields(geom) is None:
        if not geom.supports_features:
            raise ValueError(
                "sharded solve needs a geometry with per-row feature "
                f"structure; {type(geom).__name__} has none (no positive "
                "factors to shard)")
        xi, zeta = geom.features()
        geom = FactoredPositive(xi=xi, zeta=zeta, eps=geom.eps)
    return geom, spmd


def _local_geometry(geom: Geometry, spmd: MeshAxis) -> RowShardedGeometry:
    """This rank's shard: the row-sharded fields padded to a multiple of p
    (the last row repeated, so log-features stay finite) and cut to its
    rows, every other tensor replicated; both boundaries differentiable."""
    n, m = geom.shape
    rows = _row_sharded_fields(geom)
    changes = {}
    for name, _ in geom.tensor_paths():
        val = getattr(geom, name)
        if name in rows:
            target = spmd.padded(n if name in _N_FIELDS else m)
            changes[name] = shard_rows(_pad_rows(val, target, replicate=True),
                                       spmd)
        else:
            changes[name] = replicate(val, spmd)
    return RowShardedGeometry(dataclasses.replace(geom, **changes), spmd)


def _local_rows(w: torch.Tensor, spmd: MeshAxis, fill: float = 0.0):
    """This rank's rows of a weight or start vector, padded with ``fill``."""
    return shard_rows(_pad_rows(w, spmd.padded(w.shape[0]), replicate=False,
                                fill=fill), spmd)


def _gathered(res: SinkhornResult, spmd: MeshAxis, n: int,
              m: int) -> SinkhornResult:
    """Every rank's rows of the scalings and potentials, unpadded; the
    scalars are replicated already."""
    def full(x, k):
        return spmd.gather_rows(x)[:k]

    return res._replace(u=full(res.u, n), v=full(res.v, m),
                        f=full(res.f, n), g=full(res.g, m))


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def sharded_sinkhorn_geometry(
        mesh, geom: Geometry, a: torch.Tensor, b: torch.Tensor, *,
        axis: str = "data", mode: str = "auto", tol: float = 1e-6,
        max_iter: int = 2000, momentum: float = 1.0,
        f_init: Optional[torch.Tensor] = None,
        g_init: Optional[torch.Tensor] = None,
        inner_steps: Optional[int] = None,
        check_every: Optional[int] = None, precision: str = "highest",
        use_pallas: Optional[bool] = None) -> SinkhornResult:
    """Sharded solve of a feature-capable Geometry on ``mesh`` (a
    ``DeviceMesh``), called on every rank with the same global inputs.

    Supports shard over the mesh dimension ``axis`` (padded to a multiple
    of its size with inert zero-weight atoms); r and the scalars
    replicate. ``mode``: ``"scaling"``, ``"log"`` (mandatory at small eps,
    where scalings over/underflow) or ``"auto"`` (scaling for explicit
    linear factors, log otherwise). ``f_init``/``g_init`` warm-start the
    potentials (scaling space warm-starts u = exp(f_init / eps) only),
    ``momentum`` over-relaxes: the single-device semantics. ``inner_steps
    > 1`` (the megakernel) is refused; ``check_every`` sets the cadence
    (default every iteration). ``use_pallas=False`` runs the all-reduced
    plain operators instead of the sharded plan. The result is gathered
    and identical on every rank."""
    if mode not in ("auto", "scaling", "log"):
        raise ValueError(
            f"mode must be 'auto' | 'scaling' | 'log', got {mode!r}")
    if inner_steps is not None and int(inner_steps) > 1:
        raise ValueError(
            "inner_steps > 1 (the persistent megakernel) is not available "
            "on sharded solves: the fused block iterates on LOCAL feature "
            "rows only and would drop the per-iteration all-reduce. Use "
            "check_every= for the fewer-syncs cadence, or solve on one "
            "device for the megakernel.")
    check_every = 1 if check_every is None else int(check_every)
    geom, spmd = _prepare(mesh, geom, axis)
    if mode == "auto":
        mode = _auto_mode(geom)
    if mode == "log" and not geom.supports_log:
        raise ValueError(f"{type(geom).__name__} has no log-domain "
                         "operators; use mode='scaling'")
    n, m = geom.shape
    local = _local_geometry(geom, spmd)
    a_l, b_l = _local_rows(a, spmd), _local_rows(b, spmd)
    kw = dict(tol=tol, max_iter=max_iter, momentum=momentum,
              use_pallas=use_pallas, check_every=check_every,
              precision=precision)
    if mode == "log":
        # padded atoms start at -inf (and a = 0 pins them there too), so
        # they add exp(-inf) = 0 to every LSE from iteration 0
        f0 = torch.zeros_like(a) if f_init is None else f_init
        g0 = torch.zeros_like(b) if g_init is None else g_init
        res = sinkhorn_log_geometry(
            local, a_l, b_l, f_init=_local_rows(f0, spmd, -torch.inf),
            g_init=_local_rows(g0, spmd, -torch.inf), **kw)
    else:
        # scaling space warm-starts u only, as the single-device runner;
        # zero scalings keep padded atoms inert
        u0 = torch.ones_like(a) if f_init is None \
            else torch.exp(f_init / geom.eps)
        res = sinkhorn_geometry(local, a_l, b_l,
                                u_init=_local_rows(u0, spmd), **kw)
    return _gathered(res, spmd, n, m)


def sharded_sinkhorn_divergence(mesh, geom: Geometry,
                                a: Optional[torch.Tensor] = None,
                                b: Optional[torch.Tensor] = None, *,
                                axis: str = "data", tol: float = 1e-6,
                                max_iter: int = 2000) -> torch.Tensor:
    """Sharded Sinkhorn divergence: three log-domain envelope solves on
    the sharded geometry, a 0-d tensor replicated on every rank.
    Differentiable in the geometry's tensors (supports, features, shared
    anchors) and the weights: every rank's gradients are the
    single-process ones (see the module doc)."""
    geom, spmd = _prepare(mesh, geom, axis)
    if not geom.supports_log:
        raise ValueError(f"{type(geom).__name__} has no log-domain "
                         "operators; the sharded divergence runs in log "
                         "space")
    n, m = geom.shape
    dev = geom.device
    a = torch.full((n,), 1.0 / n, device=dev) if a is None else a
    b = torch.full((m,), 1.0 / m, device=dev) if b is None else b
    g = _local_geometry(geom, spmd)
    a_l, b_l = _local_rows(a, spmd), _local_rows(b, spmd)
    w_xy = rot_geometry(g, a_l, b_l, tol, max_iter)
    w_xx = rot_geometry(g.xx(), a_l, a_l, tol, max_iter)
    w_yy = rot_geometry(g.yy(), b_l, b_l, tol, max_iter)
    return w_xy - 0.5 * (w_xx + w_yy)


def sharded_sinkhorn_factored(mesh, xi, zeta, a, b, *, eps: float,
                              axis: str = "data", mode: str = "scaling",
                              tol: float = 1e-6, max_iter: int = 2000,
                              momentum: float = 1.0,
                              f_init: Optional[torch.Tensor] = None,
                              g_init: Optional[torch.Tensor] = None
                              ) -> SinkhornResult:
    """Sharded solve on explicit positive factors K = xi @ zeta.T."""
    return sharded_sinkhorn_geometry(
        mesh, FactoredPositive(xi=xi, zeta=zeta, eps=eps), a, b, axis=axis,
        mode=mode, tol=tol, max_iter=max_iter, momentum=momentum,
        f_init=f_init, g_init=g_init)


def make_sharded_sinkhorn(mesh, *, axis: str = "data", eps: float,
                          mode: str = "scaling", tol: float = 1e-6,
                          max_iter: int = 2000) -> Callable:
    """A solver ``fn(xi, zeta, a, b)`` bound to ``mesh``: global inputs,
    supports sharded over ``axis``, the result replicated."""

    def fn(xi, zeta, a, b) -> SinkhornResult:
        return sharded_sinkhorn_factored(
            mesh, xi, zeta, a, b, eps=eps, axis=axis, mode=mode, tol=tol,
            max_iter=max_iter)

    return fn
