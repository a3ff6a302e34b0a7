"""The Geometry layer: one kernel-operator protocol for every cost family.

A :class:`Geometry` packages the representation of the Gibbs kernel behind
one small operator protocol, so every solver is generic in the kernel:

    ``apply_k`` / ``apply_kt``          scaling-space matvecs  K v, K^T u
    ``log_apply_k`` / ``log_apply_kt``  log(K e^{g/eps}), log(K^T e^{f/eps})
    ``cost_matrix()``                   dense cost for the quadratic methods
    ``rebuild_at(eps)``                 the kernel re-derived at a new eps
    ``features()`` / ``log_features()`` materialized positive factors
    ``xx()`` / ``yy()``                 the self-geometries of the divergence
    ``pallas_ops()``                    the spec ``kernels.ops`` maps to
                                        fused kernels (name kept from the
                                        JAX package)

Families ported so far: :class:`DenseCost` (the quadratic oracle),
:class:`FactoredPositive` and :class:`GaussianPointCloud`. Geometries are
frozen dataclasses holding float32 tensors on one device. Counterpart of
``repro.core.geometry``.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..kernels.ops import check_precision
from ..kernels.ref import ieee_fp32, lse
from .features import (
    _anchor_log_const,
    _log_f32,
    gaussian_log_features,
    gaussian_q,
)

__all__ = [
    "Geometry",
    "DenseCost",
    "FactoredPositive",
    "GaussianPointCloud",
    "squared_euclidean",
    "data_radius",
]


def squared_euclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """C_ij = ||x_i - y_j||^2, shapes (n,d),(m,d) -> (n,m)."""
    x2 = torch.sum(x * x, dim=-1)[:, None]
    y2 = torch.sum(y * y, dim=-1)[None, :]
    with ieee_fp32():
        C = x2 + y2 - 2.0 * (x @ y.T)
    return torch.clamp(C, min=0.0)


def data_radius(*point_sets: torch.Tensor) -> torch.Tensor:
    """R = max_i ||p_i||_2 over all supplied supports (for Lemma 1's q)."""
    return torch.max(torch.stack(
        [torch.max(torch.linalg.norm(p, dim=-1)) for p in point_sets]))


def _masked_log(w: torch.Tensor) -> torch.Tensor:
    """log w with log(0) pinned to -inf without 0*inf NaN hazards."""
    pos = w > 0
    return torch.where(pos, torch.log(torch.where(pos, w, torch.ones_like(w))),
                       torch.full_like(w, -torch.inf))


def _stored(arr: torch.Tensor, precision: str) -> torch.Tensor:
    """The storage half of the mixed-precision policy: ``"bf16"`` keeps the
    loop-invariant kernel representation (features, log-features, dense
    Gibbs kernel) in bfloat16, as the fused plan stores its factors."""
    check_precision(precision)
    return arr.to(torch.bfloat16) if precision == "bf16" else arr


def _compute(arr: torch.Tensor) -> torch.Tensor:
    """Widen a bf16-stored operand to float32 where it is applied, inside
    the operator closures, so every contraction and LSE accumulates in
    float32 while the hoisted array stays bf16."""
    return arr.float()


def _factored_log_apply(log_u: torch.Tensor, log_w: torch.Tensor,
                        s: torch.Tensor) -> torch.Tensor:
    """log((e^{log_u} e^{log_w}^T) e^{s}) via the exact two-stage LSE:
    out_i = LSE_k(log_u[i,k] + LSE_j(log_w[j,k] + s_j)), O(r (n + m))."""
    t = lse(log_w + s[:, None], dim=0)
    return lse(log_u + t[None, :], dim=1)


def _shifted_log_product(log_u: torch.Tensor,
                         log_w: torch.Tensor) -> torch.Tensor:
    """log(e^{log_u} @ e^{log_w}^T) densely, max-shifted per row."""
    m1 = torch.amax(log_u, dim=1, keepdim=True)
    m2 = torch.amax(log_w, dim=1, keepdim=True)
    with ieee_fp32():
        K = torch.exp(log_u - m1) @ torch.exp(log_w - m2).T
    return _masked_log(K) + m1 + m2.T


class Geometry(abc.ABC):
    """One entropic-OT cost family: the kernel-operator protocol.

    ``anneal_capable`` — ``rebuild_at(eps)`` re-derives the kernel at any
    eps.
    """

    anneal_capable: bool = False

    @property
    @abc.abstractmethod
    def shape(self) -> Tuple[int, int]:
        """(n, m): support sizes of the two measures."""

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """Every tensor the geometry holds."""
        return tuple(v for f in dataclasses.fields(self)
                     if isinstance(v := getattr(self, f.name), torch.Tensor))

    @property
    def device(self) -> torch.device:
        return self.tensors()[0].device

    # -- scaling-space operators ---------------------------------------------

    @abc.abstractmethod
    def apply_k(self, v: torch.Tensor) -> torch.Tensor:
        """K v, shape (m,) -> (n,)."""

    @abc.abstractmethod
    def apply_kt(self, u: torch.Tensor) -> torch.Tensor:
        """K^T u, shape (n,) -> (m,)."""

    def operators(self, *, precision: str = "highest"
                  ) -> Tuple[Callable, Callable]:
        """(matvec, rmatvec) with loop-invariant work done once."""
        check_precision(precision)
        return self.apply_k, self.apply_kt

    # -- log-domain operators ------------------------------------------------

    def log_apply_k(self, g: torch.Tensor) -> torch.Tensor:
        """log(K e^{g/eps}), shape (m,) -> (n,)."""
        raise ValueError(f"{type(self).__name__} has no log-domain operators")

    def log_apply_kt(self, f: torch.Tensor) -> torch.Tensor:
        """log(K^T e^{f/eps}), shape (n,) -> (m,)."""
        raise ValueError(f"{type(self).__name__} has no log-domain operators")

    def log_operators(self, *, precision: str = "highest"
                      ) -> Tuple[Callable, Callable]:
        """(log_matvec, log_rmatvec) with loop-invariant work done once."""
        check_precision(precision)
        return self.log_apply_k, self.log_apply_kt

    # -- dense views ---------------------------------------------------------

    @abc.abstractmethod
    def cost_matrix(self) -> torch.Tensor:
        """Dense (n, m) ground cost for the quadratic baselines: the true
        squared-Euclidean cost for point clouds, the induced cost
        ``-eps log(Xi Zeta^T)`` for explicit factors."""

    def log_dense_kernel(self) -> torch.Tensor:
        raise ValueError(
            f"{type(self).__name__} kernel may be signed; use dense_kernel()")

    # -- eps handling --------------------------------------------------------

    def rebuild_at(self, eps: float) -> "Geometry":
        if float(eps) == float(self.eps):
            return self
        raise ValueError(
            f"{type(self).__name__} pins the kernel to the eps its factors "
            f"were built at ({self.eps}); got {eps}. Build the problem from "
            "point clouds (GaussianPointCloud) to enable eps-annealing.")

    # -- factored views ------------------------------------------------------

    def features(self) -> Tuple[torch.Tensor, torch.Tensor]:
        raise ValueError(f"no factored kernel available "
                         f"({type(self).__name__}); use a quadratic method")

    def log_features(self) -> Tuple[torch.Tensor, torch.Tensor]:
        xi, zeta = self.features()
        return _masked_log(xi), _masked_log(zeta)

    # -- divergence sub-geometries -------------------------------------------

    def xx(self) -> "Geometry":
        raise ValueError(f"{type(self).__name__} does not define "
                         "self-geometries")

    def yy(self) -> "Geometry":
        raise ValueError(f"{type(self).__name__} does not define "
                         "self-geometries")

    # -- accelerator dispatch ------------------------------------------------

    def pallas_ops(self) -> Optional[dict]:
        """Spec consumed by ``kernels.ops.geometry_ops``; ``None`` means no
        fused path and the solvers run the plain operators above."""
        return None


class _FeatureKernelOps:
    """Mixin: the factored-kernel operators derived from ``features()`` /
    ``log_features()``, materialized once per ``operators()`` call."""

    def operators(self, *, precision: str = "highest"):
        xi, zeta = (_stored(w, precision) for w in self.features())
        return (lambda v: _compute(xi) @ (_compute(zeta).T @ v),
                lambda u: _compute(zeta) @ (_compute(xi).T @ u))

    def log_operators(self, *, precision: str = "highest"):
        eps = self.eps
        lxi, lzt = (_stored(w, precision) for w in self.log_features())
        return (lambda g: _factored_log_apply(_compute(lxi), _compute(lzt),
                                              g / eps),
                lambda f: _factored_log_apply(_compute(lzt), _compute(lxi),
                                              f / eps))

    def apply_k(self, v):
        return self.operators()[0](v)

    def apply_kt(self, u):
        return self.operators()[1](u)

    def log_apply_k(self, g):
        return self.log_operators()[0](g)

    def log_apply_kt(self, f):
        return self.log_operators()[1](f)

    def log_dense_kernel(self):
        lxi, lzt = self.log_features()
        return _shifted_log_product(lxi, lzt)


@dataclasses.dataclass(frozen=True, eq=False)
class DenseCost(Geometry):
    """Explicit (n, m) ground cost; Gibbs kernel K = exp(-C/eps). O(nm)
    matvecs: the quadratic oracle."""

    C: torch.Tensor
    eps: float

    anneal_capable = True

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.C.shape)

    def operators(self, *, precision: str = "highest"):
        K = _stored(torch.exp(-self.C / self.eps), precision)
        return (lambda v: _compute(K) @ v), (lambda u: _compute(K).T @ u)

    def log_operators(self, *, precision: str = "highest"):
        eps = self.eps
        negC = _stored(-self.C / eps, precision)
        return (lambda g: lse(_compute(negC) + (g / eps)[None, :], dim=1),
                lambda f: lse(_compute(negC) + (f / eps)[:, None], dim=0))

    def apply_k(self, v):
        return self.operators()[0](v)

    def apply_kt(self, u):
        return self.operators()[1](u)

    def log_apply_k(self, g):
        return self.log_operators()[0](g)

    def log_apply_kt(self, f):
        return self.log_operators()[1](f)

    def cost_matrix(self):
        return self.C

    def log_dense_kernel(self):
        return -self.C / self.eps

    def rebuild_at(self, eps: float) -> "DenseCost":
        return self if float(eps) == float(self.eps) else \
            DenseCost(self.C, float(eps))


@dataclasses.dataclass(frozen=True, eq=False)
class FactoredPositive(_FeatureKernelOps, Geometry):
    """K = Xi Zeta^T from explicit positive features or log-features; the
    kernel is pinned to the eps the features were drawn at."""

    xi: Optional[torch.Tensor] = None
    zeta: Optional[torch.Tensor] = None
    log_xi: Optional[torch.Tensor] = None
    log_zeta: Optional[torch.Tensor] = None
    eps: float = dataclasses.field(kw_only=True)

    def __post_init__(self):
        have_lin = self.xi is not None and self.zeta is not None
        have_log = self.log_xi is not None and self.log_zeta is not None
        if have_lin == have_log:
            raise ValueError("FactoredPositive needs exactly one factor pair: "
                             "(xi, zeta) or (log_xi, log_zeta)")

    @property
    def shape(self) -> Tuple[int, int]:
        if self.xi is not None:
            return self.xi.shape[0], self.zeta.shape[0]
        return self.log_xi.shape[0], self.log_zeta.shape[0]

    def features(self):
        if self.xi is not None:
            return self.xi, self.zeta
        return torch.exp(self.log_xi), torch.exp(self.log_zeta)

    def log_features(self):
        if self.log_xi is not None:
            return self.log_xi, self.log_zeta
        return _masked_log(self.xi), _masked_log(self.zeta)

    def cost_matrix(self):
        return -self.eps * self.log_dense_kernel()

    def xx(self) -> "FactoredPositive":
        if self.xi is not None:
            return FactoredPositive(xi=self.xi, zeta=self.xi, eps=self.eps)
        return FactoredPositive(log_xi=self.log_xi, log_zeta=self.log_xi,
                                eps=self.eps)

    def yy(self) -> "FactoredPositive":
        if self.zeta is not None:
            return FactoredPositive(xi=self.zeta, zeta=self.zeta,
                                    eps=self.eps)
        return FactoredPositive(log_xi=self.log_zeta, log_zeta=self.log_zeta,
                                eps=self.eps)

    def pallas_ops(self):
        if self.xi is not None:
            return {"kind": "factored", "xi": self.xi, "zeta": self.zeta}
        return {"kind": "log_factored", "log_xi": self.log_xi,
                "log_zeta": self.log_zeta, "eps": self.eps}


@dataclasses.dataclass(frozen=True, eq=False)
class GaussianPointCloud(_FeatureKernelOps, Geometry):
    """Point clouds + Lemma-1 anchors: features re-derived at any eps, so
    the family composes with an ``EpsSchedule``. ``cost_matrix`` is the
    true squared-Euclidean cost."""

    x: torch.Tensor                     # (n, d)
    y: torch.Tensor                     # (m, d)
    anchors: torch.Tensor               # (r, d)
    eps: float
    R: float

    anneal_capable = True

    @classmethod
    def build(cls, x, y, anchors, *, eps: float,
              R: Optional[float] = None) -> "GaussianPointCloud":
        R = float(data_radius(x.detach(), y.detach())) if R is None \
            else float(R)
        return cls(x=x, y=y, anchors=anchors, eps=float(eps), R=R)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.x.shape[0], self.y.shape[0]

    @property
    def q(self) -> float:
        return gaussian_q(self.R, self.eps, self.x.shape[-1])

    def log_features(self):
        q = self.q
        return (gaussian_log_features(self.x, self.anchors, eps=self.eps, q=q),
                gaussian_log_features(self.y, self.anchors, eps=self.eps, q=q))

    def features(self):
        lxi, lzt = self.log_features()
        return torch.exp(lxi), torch.exp(lzt)

    def cost_matrix(self):
        return squared_euclidean(self.x, self.y)

    def rebuild_at(self, eps: float) -> "GaussianPointCloud":
        return self if float(eps) == float(self.eps) else \
            GaussianPointCloud(self.x, self.y, self.anchors, eps=float(eps),
                               R=self.R)

    def xx(self) -> "GaussianPointCloud":
        return GaussianPointCloud(self.x, self.x, self.anchors, eps=self.eps,
                                  R=self.R)

    def yy(self) -> "GaussianPointCloud":
        return GaussianPointCloud(self.y, self.y, self.anchors, eps=self.eps,
                                  R=self.R)

    def pallas_ops(self):
        r = self.anchors.shape[0]
        log_const = (_anchor_log_const(self.anchors, self.q, self.eps)
                     - 0.5 * _log_f32(r)).contiguous()
        return {
            "kind": "gaussian",
            "x": self.x,
            "y": self.y,
            "anchors": self.anchors,
            "log_const": log_const,
            "inv_eps": 1.0 / self.eps,
        }
