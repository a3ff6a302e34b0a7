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

Cost families: :class:`DenseCost` (the quadratic oracle),
:class:`FactoredPositive` (explicit positive factors),
:class:`GaussianPointCloud` (Lemma-1 features, anneal-capable),
:class:`ArcCosinePointCloud` (Lemma-3 features with a kappa floor),
:class:`NystromLowRank` (the paper's signed ``Nys`` baseline, scaling space
only) and :class:`GridSeparable` (separable costs on regular grids, one
small contraction an axis). Geometries are frozen dataclasses holding
float32 tensors (:class:`GridSeparable` tuples of them) on one device.
The log-domain operators also take a leading batch of potentials, (k, m)
-> (k, n). Counterpart of ``repro.core.geometry``.
"""
from __future__ import annotations

import abc
import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from ..kernels.backend import as_f32, resolve_device
from ..kernels.ops import check_precision
from ..kernels.ref import ieee_fp32, lse
from .features import (
    _anchor_log_const,
    _log_f32,
    arccos_features,
    gaussian_log_features,
    gaussian_q,
)

__all__ = [
    "Geometry",
    "DenseCost",
    "FactoredPositive",
    "GaussianPointCloud",
    "ArcCosinePointCloud",
    "NystromLowRank",
    "GridSeparable",
    "as_geometry",
    "squared_euclidean",
    "gibbs_kernel",
    "neglog_kernel_cost",
    "data_radius",
]


def squared_euclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """C_ij = ||x_i - y_j||^2, shapes (n,d),(m,d) -> (n,m)."""
    x2 = torch.sum(x * x, dim=-1)[:, None]
    y2 = torch.sum(y * y, dim=-1)[None, :]
    with ieee_fp32():
        C = x2 + y2 - 2.0 * (x @ y.T)
    return torch.clamp(C, min=0.0)


def gibbs_kernel(C: torch.Tensor, eps: float) -> torch.Tensor:
    """K = exp(-C / eps)."""
    return torch.exp(-C / eps)


def neglog_kernel_cost(k_matrix: torch.Tensor, eps: float) -> torch.Tensor:
    """c(x,y) = -eps log k(x,y): the kernel-first cost of Eq. (7)."""
    return -eps * torch.log(k_matrix)


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
    out_i = LSE_k(log_u[i,k] + LSE_j(log_w[j,k] + s_j)), O(r (n + m)).
    ``s`` is (m,) or a batch (k, m)."""
    t = lse(log_w + s[..., :, None], dim=-2)
    return lse(log_u + t[..., None, :], dim=-1)


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
    ``supports_log`` — log-domain operators exist (an entrywise POSITIVE
    kernel; signed Nystrom factors do not qualify).
    ``supports_features`` — ``features()`` materializes strictly positive
    factors (what a sharded solve and the fused plans consume).
    """

    anneal_capable: bool = False
    supports_log: bool = True
    supports_features: bool = False

    @property
    @abc.abstractmethod
    def shape(self) -> Tuple[int, int]:
        """(n, m): support sizes of the two measures."""

    def tensor_paths(self) -> Tuple[Tuple[str, Optional[int]], ...]:
        """``(field, index)`` of every tensor the geometry holds: index
        ``None`` for a tensor field, the position for a tensor in a tuple
        or list field (a grid's axes)."""
        paths = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                paths.append((f.name, None))
            elif isinstance(v, (tuple, list)):
                paths += [(f.name, i) for i, t in enumerate(v)
                          if isinstance(t, torch.Tensor)]
        return tuple(paths)

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """Every tensor the geometry holds, in ``tensor_paths`` order."""
        out = []
        for name, i in self.tensor_paths():
            v = getattr(self, name)
            out.append(v if i is None else v[i])
        return tuple(out)

    def with_tensors(self, paths, tensors) -> "Geometry":
        """This geometry with the tensors at ``paths`` (of
        :meth:`tensor_paths`) replaced by ``tensors``."""
        fields = {}
        for (name, i), t in zip(paths, tensors):
            if i is None:
                fields[name] = t
            else:
                fields.setdefault(name, list(getattr(self, name)))[i] = t
        return dataclasses.replace(self, **{
            k: type(getattr(self, k))(v) if isinstance(v, list) else v
            for k, v in fields.items()})

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
        raise ValueError(
            f"{type(self).__name__} has no log-domain operators (kernel "
            "entries are not guaranteed positive); use a scaling-space "
            "method")

    def log_apply_kt(self, f: torch.Tensor) -> torch.Tensor:
        """log(K^T e^{f/eps}), shape (n,) -> (m,)."""
        raise ValueError(
            f"{type(self).__name__} has no log-domain operators (kernel "
            "entries are not guaranteed positive); use a scaling-space "
            "method")

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

    def dense_kernel(self) -> torch.Tensor:
        """The exact dense (n, m) kernel the operators apply (the oracle
        the operators are tested against)."""
        return torch.exp(self.log_dense_kernel())

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
        return (lambda g: lse(_compute(negC) + (g / eps)[..., None, :],
                              dim=-1),
                lambda f: lse(_compute(negC) + (f / eps)[..., :, None],
                              dim=-2))

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

    supports_features = True

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

    supports_features = True

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


@dataclasses.dataclass(frozen=True, eq=False)
class ArcCosinePointCloud(_FeatureKernelOps, Geometry):
    """Lemma-3 perturbed arc-cosine kernel k_s(x, y) + kappa on point
    clouds: relu-rectified random projections plus one constant
    sqrt(kappa) coordinate, so the kernel is at least kappa > 0 while
    single features (and whole anchor columns) may be 0 and their logs
    -inf. The kernel does not depend on eps (the cost is -eps log(k_s +
    kappa)), so the family is not anneal-capable."""

    supports_features = True

    x: torch.Tensor                     # (n, d)
    y: torch.Tensor                     # (m, d)
    anchors: torch.Tensor               # (r, d), u ~ N(0, sigma^2 I)
    eps: float
    s: int = 1
    sigma: float = 1.5
    kappa: float = 1e-3

    def __post_init__(self):
        if not self.kappa > 0:
            raise ValueError(
                "ArcCosinePointCloud needs kappa > 0 (Lemma 3's positivity "
                f"floor), got {self.kappa}")

    @property
    def shape(self) -> Tuple[int, int]:
        return self.x.shape[0], self.y.shape[0]

    def features(self):
        kw = dict(s=self.s, sigma=self.sigma, kappa=self.kappa)
        return (arccos_features(self.x, self.anchors, **kw),
                arccos_features(self.y, self.anchors, **kw))

    def cost_matrix(self):
        return -self.eps * self.log_dense_kernel()

    def xx(self) -> "ArcCosinePointCloud":
        return dataclasses.replace(self, y=self.x)

    def yy(self) -> "ArcCosinePointCloud":
        return dataclasses.replace(self, x=self.y)

    def pallas_ops(self):
        xi, zeta = self.features()
        return {"kind": "factored", "xi": xi, "zeta": zeta}


def _gibbs(x: torch.Tensor, y: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.exp(-squared_euclidean(x, y) / eps)


@dataclasses.dataclass(frozen=True, eq=False)
class NystromLowRank(Geometry):
    """K_tilde = L @ Rt: landmark-Nystrom factors of the Gibbs kernel (the
    paper's ``Nys`` baseline). The same O(l (n + m)) matvec as positive
    features, but K_tilde may have NEGATIVE entries: the scalings can
    cross zero and the iteration diverges at small eps (paper Figs. 1/3/5),
    which a solve reports as ``SinkhornResult.diverged``. No log-domain
    operators and no induced cost."""

    supports_log = False

    L: torch.Tensor                     # (n, l)
    Rt: torch.Tensor                    # (l, m)
    eps: float

    @classmethod
    def from_point_clouds(cls, x: torch.Tensor, y: torch.Tensor, *,
                          eps: float, rank: int,
                          generator: torch.Generator,
                          ridge: float = 1e-10) -> "NystromLowRank":
        """Uniform landmarks, ``rank`` of the n + m points drawn without
        replacement by ``generator`` (a CPU generator, so one seed picks
        the same landmarks on every device); see :meth:`from_landmarks`."""
        pool = torch.cat([x, y], dim=0)
        idx = torch.randperm(pool.shape[0], generator=generator)[:rank]
        return cls.from_landmarks(x, y, pool[idx.to(pool.device)], eps=eps,
                                  ridge=ridge)

    @classmethod
    def from_landmarks(cls, x: torch.Tensor, y: torch.Tensor,
                       z: torch.Tensor, *, eps: float,
                       ridge: float = 1e-10) -> "NystromLowRank":
        """Nystrom factors of exp(-||x - y||^2 / eps) on the landmarks
        ``z`` (l, d): L = K_xz K_zz^+, Rt = K_zy, the pseudo-inverse
        inverting only the spectrum above tau * lambda_max (tau = ``ridge``
        where it exceeds 1e-8, else 1e-5), which keeps float32 stable.
        K_zz is symmetrized before ``eigh``, as ``jnp.linalg.eigh`` does."""
        K_xz, K_zy, K_zz = _gibbs(x, z, eps), _gibbs(z, y, eps), \
            _gibbs(z, z, eps)
        w, Q = torch.linalg.eigh(0.5 * (K_zz + K_zz.T))
        tau = ridge if ridge > 1e-8 else 1e-5
        keep = w > tau * torch.max(w)
        w_inv = torch.where(keep, 1.0 / torch.where(keep, w,
                                                     torch.ones_like(w)),
                            torch.zeros_like(w))
        with ieee_fp32():
            inv = (Q * w_inv[None, :]) @ Q.T
            L = K_xz @ inv
        return cls(L=L, Rt=K_zy, eps=float(eps))

    @property
    def shape(self) -> Tuple[int, int]:
        return self.L.shape[0], self.Rt.shape[1]

    @property
    def rank(self) -> int:
        return self.L.shape[1]

    def operators(self, *, precision: str = "highest"):
        L, Rt = _stored(self.L, precision), _stored(self.Rt, precision)

        def matvec(v):
            with ieee_fp32():
                return _compute(L) @ (_compute(Rt) @ v)

        def rmatvec(u):
            with ieee_fp32():
                return _compute(Rt).T @ (_compute(L).T @ u)

        return matvec, rmatvec

    def apply_k(self, v):
        return self.operators()[0](v)

    def apply_kt(self, u):
        return self.operators()[1](u)

    def dense_kernel(self):
        with ieee_fp32():
            return self.L @ self.Rt

    def cost_matrix(self):
        raise ValueError(
            "the signed Nystrom kernel has no well-defined induced cost "
            "(-eps log K_tilde hits negative entries); build a DenseCost "
            "from the true ground cost instead")


@dataclasses.dataclass(frozen=True, eq=False)
class GridSeparable(Geometry):
    """Separable cost on a regular grid, C = sum_k (i_k - j_k)^2 over the
    axes: the Gibbs kernel is a Kronecker product K_1 x ... x K_d, so a
    matvec is d small contractions, one an axis, O(n^{1+1/d}) for n grid
    points (convolutional Wasserstein). ``axes_x`` / ``axes_y`` hold one
    coordinate vector an axis; a weight vector is the grid in C order
    (``image.reshape(-1)``). Anneal-capable."""

    axes_x: Tuple[torch.Tensor, ...]    # d tensors, lengths (n_1, ..., n_d)
    axes_y: Tuple[torch.Tensor, ...]    # d tensors, lengths (m_1, ..., m_d)
    eps: float

    anneal_capable = True

    @classmethod
    def build(cls, axes_x, axes_y=None, *, eps: float,
              device=None) -> "GridSeparable":
        """From per-axis coordinate vectors (tensors or arrays) on
        ``device`` (default: the first axis's device for a tensor, the
        card for an array)."""
        first = next(iter(axes_x), None)
        if device is None and isinstance(first, torch.Tensor):
            device = first.device
        dev = resolve_device(device)
        axes_x = tuple(as_f32(t, dev) for t in axes_x)
        axes_y = axes_x if axes_y is None else \
            tuple(as_f32(t, dev) for t in axes_y)
        return cls(axes_x=axes_x, axes_y=axes_y, eps=float(eps))

    def __post_init__(self):
        if len(self.axes_x) != len(self.axes_y) or not self.axes_x:
            raise ValueError(
                "GridSeparable needs matching, non-empty per-dimension axis "
                f"tuples; got {len(self.axes_x)} x and {len(self.axes_y)} y")

    @property
    def ndim(self) -> int:
        return len(self.axes_x)

    @property
    def grid_shape_x(self) -> Tuple[int, ...]:
        return tuple(t.shape[0] for t in self.axes_x)

    @property
    def grid_shape_y(self) -> Tuple[int, ...]:
        return tuple(t.shape[0] for t in self.axes_y)

    @property
    def shape(self) -> Tuple[int, int]:
        return math.prod(self.grid_shape_x), math.prod(self.grid_shape_y)

    def _axis_costs(self):
        """Per-axis (n_k, m_k) squared-distance costs."""
        return tuple((tx[:, None] - ty[None, :]) ** 2
                     for tx, ty in zip(self.axes_x, self.axes_y))

    @staticmethod
    def _conv(mats, grid, v):
        """One small (n_k, m_k) contraction an axis."""
        V = v.reshape(grid)
        with ieee_fp32():
            for k, Mk in enumerate(mats):
                V = torch.movedim(torch.tensordot(Mk, V, dims=([1], [k])),
                                  0, k)
        return V.reshape(-1)

    @staticmethod
    def _log_conv(log_mats, grid, s):
        """An LSE an axis, exact because every K_k is positive; ``s`` is
        (m,) or a batch (k, m)."""
        batch = s.shape[:-1]
        nb = len(batch)
        out = s.reshape(*batch, *grid)
        for k, logK in enumerate(log_mats):
            t = torch.movedim(out, nb + k, -1)                  # (..., in_k)
            t = lse(logK + t[..., None, :], dim=-1)             # (..., out_k)
            out = torch.movedim(t, -1, nb + k)
        return out.reshape(*batch, -1)

    def operators(self, *, precision: str = "highest"):
        Ks = tuple(_stored(torch.exp(-ck / self.eps), precision)
                   for ck in self._axis_costs())
        KTs = tuple(Kk.T for Kk in Ks)
        gy, gx = self.grid_shape_y, self.grid_shape_x
        return (lambda v: self._conv([_compute(k) for k in Ks], gy, v),
                lambda u: self._conv([_compute(k) for k in KTs], gx, u))

    def log_operators(self, *, precision: str = "highest"):
        eps = self.eps
        logKs = tuple(_stored(-ck / eps, precision)
                      for ck in self._axis_costs())
        logKTs = tuple(lk.T for lk in logKs)
        gy, gx = self.grid_shape_y, self.grid_shape_x
        return (lambda g: self._log_conv([_compute(k) for k in logKs], gy,
                                         g / eps),
                lambda f: self._log_conv([_compute(k) for k in logKTs], gx,
                                         f / eps))

    def apply_k(self, v):
        return self.operators()[0](v)

    def apply_kt(self, u):
        return self.operators()[1](u)

    def log_apply_k(self, g):
        return self.log_operators()[0](g)

    def log_apply_kt(self, f):
        return self.log_operators()[1](f)

    def cost_matrix(self):
        C = None
        for ck in self._axis_costs():
            if C is None:
                C = ck
            else:
                n0, m0 = C.shape
                nk, mk = ck.shape
                C = (C[:, None, :, None] + ck[None, :, None, :]) \
                    .reshape(n0 * nk, m0 * mk)
        return C

    def log_dense_kernel(self):
        return -self.cost_matrix() / self.eps

    def rebuild_at(self, eps: float) -> "GridSeparable":
        return self if float(eps) == float(self.eps) else \
            GridSeparable(self.axes_x, self.axes_y, eps=float(eps))

    def xx(self) -> "GridSeparable":
        return GridSeparable(self.axes_x, self.axes_x, eps=self.eps)

    def yy(self) -> "GridSeparable":
        return GridSeparable(self.axes_y, self.axes_y, eps=self.eps)


def as_geometry(obj, *, eps: Optional[float] = None,
                device=None) -> Geometry:
    """``obj`` as a Geometry: a geometry passes through (rebuilt at
    ``eps`` where given); a dense (n, m) cost (tensor or array) becomes a
    :class:`DenseCost` on ``device`` (default: the cost's own device for a
    tensor, the card for an array), which needs ``eps``."""
    if isinstance(obj, Geometry):
        return obj if eps is None else obj.rebuild_at(eps)
    if device is None and isinstance(obj, torch.Tensor):
        device = obj.device
    arr = as_f32(obj, resolve_device(device))
    if arr.ndim == 2:
        if eps is None:
            raise ValueError("as_geometry(cost_array) requires eps=")
        return DenseCost(arr, float(eps))
    raise TypeError(f"cannot interpret {type(obj).__name__} as a Geometry")
