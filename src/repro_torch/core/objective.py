"""The training-facing OT objective layer: ``ExecutionPolicy`` and
``OTObjective``.

* :class:`ExecutionPolicy` — HOW a solve runs: the device, the factor
  storage precision (bf16 factors with float32 accumulation), the
  ``use_pallas`` fused-plan switch and the megakernel cadence
  (``inner_steps`` / ``check_every``).
* :class:`OTObjective` — WHAT is optimized: ``eps``, the iteration budget
  and the policy. It builds geometries from embeddings (log-features,
  Gaussian point clouds with learnable anchors) and evaluates the debiased
  divergence through the envelope-theorem VJP of ``grad.rot_geometry``,
  with no backprop through the loop.

Counterpart of ``repro.core.objective``. The JAX ``backend`` field is a
``device`` here; ``mesh`` is a ``DeviceMesh``, and a policy with one runs
the divergence sharded (``core.sharded``). ``from_config`` builds the
run-wide policy of an LM run from its ``ArchConfig``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch

from ..kernels.backend import device_scope, resolve_device
from ..kernels.ops import check_precision
from .divergence import sinkhorn_divergence_geometry
from .geometry import FactoredPositive, GaussianPointCloud, Geometry
from .sinkhorn import SinkhornResult, sinkhorn_geometry

__all__ = ["ExecutionPolicy", "OTObjective"]


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """How every solve issued by an :class:`OTObjective` executes.

    device       the device solves must run on (``"cuda"``, ``"cpu"``);
                 ``None`` takes the geometry's. A geometry elsewhere is
                 refused, never moved.
    precision    ``"highest"`` or ``"bf16"`` (bf16 factor storage, float32
                 accumulation).
    use_pallas   ``None``/``True`` run the fused plan (the CUDA kernels on
                 the card, their plain versions on the CPU), ``False`` the
                 geometry's plain torch operators.
    inner_steps  iterations per megakernel launch (``None`` = auto: 8 on
                 the card where the megakernel is admitted).
    check_every  convergence-check cadence in iterations (a multiple of
                 ``inner_steps``; ``None`` = auto).
    mesh         optional ``DeviceMesh``: divergences run sharded over its
                 dimension ``mesh_axis``, the all-reduced log operators on
                 each rank's rows (the other knobs do not apply there).
    """

    device: Optional[str] = None
    precision: str = "highest"
    use_pallas: Optional[bool] = None
    inner_steps: Optional[int] = None
    check_every: Optional[int] = None
    mesh: Optional[Any] = None
    mesh_axis: str = "data"

    def __post_init__(self):
        check_precision(self.precision)

    @classmethod
    def training(cls, **overrides) -> "ExecutionPolicy":
        """The default policy of training-time losses: bf16 factor storage,
        the fused plan and its megakernel wherever they apply."""
        kw: Dict[str, Any] = dict(precision="bf16")
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def from_config(cls, cfg, mesh: Optional[Any] = None, *,
                    device=None) -> "ExecutionPolicy":
        """The run-wide policy from an ``ArchConfig``'s ``ot_*`` execution
        fields (missing fields fall back to the training defaults), on
        ``device`` (``None``: the geometry's). The JAX package's
        ``ot_backend`` pin names a Pallas backend and has no counterpart:
        the port's one compiled route is the card's CUDA kernels."""
        return cls(
            device=None if device is None else str(device),
            precision=getattr(cfg, "ot_precision", "bf16"),
            use_pallas=getattr(cfg, "ot_use_pallas", None),
            inner_steps=getattr(cfg, "ot_inner_steps", None),
            check_every=getattr(cfg, "ot_check_every", None),
            mesh=mesh,
        )

    def solver_kwargs(self) -> Dict[str, Any]:
        """The knobs threaded into ``sinkhorn_*`` / ``rot_geometry`` calls."""
        return dict(use_pallas=self.use_pallas, inner_steps=self.inner_steps,
                    check_every=self.check_every, precision=self.precision)

    def scope(self):
        """Context manager pinning the policy's device for the enclosed
        solves (``kernels.backend.device_scope``); a no-op where the policy
        keeps the geometry's device."""
        if self.device is None:
            return contextlib.nullcontext()
        return device_scope(self.device)

    def check_device(self, geom: Geometry) -> None:
        """Refuse a geometry that is not on the policy's device."""
        if self.device is not None and \
                geom.device != resolve_device(self.device):
            raise ValueError(f"geometry on {geom.device}, policy pins "
                             f"{self.device}")

    def describe(self) -> str:
        """One-line summary for run and step logs."""
        pallas = {None: "auto", True: "on", False: "off"}[self.use_pallas]
        cadence = ("auto" if self.inner_steps is None
                   and self.check_every is None
                   else f"{self.inner_steps or 1}/{self.check_every or 1}")
        mesh = "-" if self.mesh is None else (
            f"{dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))}"
            f"@{self.mesh_axis}")
        return (f"device={self.device or 'geometry'} "
                f"precision={self.precision} pallas={pallas} "
                f"cadence={cadence} mesh={mesh}")


@dataclasses.dataclass(frozen=True)
class OTObjective:
    """A differentiable Sinkhorn-divergence objective bound to one policy.

    ``eps``/``tol``/``max_iter`` are the problem constants; with the
    default ``tol=0`` every solve runs exactly ``max_iter`` iterations
    (rounded up to the cadence). Gradients flow through the envelope VJP
    of ``rot_geometry`` into supports, weights, learnable anchors and
    log-features.
    """

    eps: float
    tol: float = 0.0
    max_iter: int = 100
    policy: ExecutionPolicy = ExecutionPolicy()

    def __post_init__(self):
        if self.max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {self.max_iter}")

    def factored(self, log_xi: torch.Tensor,
                 log_zeta: torch.Tensor) -> FactoredPositive:
        """Positive-feature geometry from LOG features (n, r) / (m, r)."""
        return FactoredPositive(log_xi=log_xi, log_zeta=log_zeta,
                                eps=self.eps)

    def gaussian(self, x: torch.Tensor, y: torch.Tensor,
                 anchors: torch.Tensor, *,
                 R: Optional[float] = None) -> GaussianPointCloud:
        """Point-cloud geometry under Lemma-1 features with (learnable)
        ``anchors``; ``R`` bounds the embedded data (``None`` derives it
        from the clouds)."""
        return GaussianPointCloud.build(x, y, anchors, eps=self.eps, R=R)

    def _check(self, geom: Geometry) -> None:
        if geom.eps != self.eps:
            raise ValueError(
                f"geometry eps={geom.eps} != objective eps={self.eps}; "
                "build geometries through the objective")
        self.policy.check_device(geom)

    def divergence(self, geom: Geometry, a: Optional[torch.Tensor] = None,
                   b: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Debiased divergence Wbar(mu, nu) = W(mu,nu) - (W(mu,mu) +
        W(nu,nu))/2: three envelope solves under this policy (sharded over
        the policy's mesh where it has one)."""
        self._check(geom)
        p = self.policy
        if p.mesh is not None:
            return sinkhorn_divergence_geometry(
                geom, a, b, tol=self.tol, max_iter=self.max_iter,
                mesh=p.mesh, mesh_axis=p.mesh_axis)
        return sinkhorn_divergence_geometry(
            geom, a, b, tol=self.tol, max_iter=self.max_iter,
            **p.solver_kwargs())

    def __call__(self, geom: Geometry, a: Optional[torch.Tensor] = None,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.divergence(geom, a, b)

    def solve(self, geom: Geometry, a: torch.Tensor,
              b: torch.Tensor) -> SinkhornResult:
        """Raw balanced-transport solve in scaling space under this policy
        (the routing entry point), not differentiable: the fused scaling
        plan, with the megakernel ``sinkhorn_block`` where it is admitted,
        or the plain operators with ``use_pallas=False``. The fused plan's
        loop replays one runner per cell (``core.runners``) across
        calls."""
        self._check(geom)
        return sinkhorn_geometry(geom, a, b, tol=self.tol,
                                 max_iter=self.max_iter,
                                 **self.policy.solver_kwargs())

    def uniform_weights(self, geom: Geometry):
        n, m = geom.shape
        dev = geom.device
        return (torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev),
                torch.full((m,), 1.0 / m, dtype=torch.float32, device=dev))

    def spec(self, geom: Geometry, a: Optional[torch.Tensor] = None,
             b: Optional[torch.Tensor] = None, *, method: str = "auto"):
        """The :class:`~repro_torch.core.spec.SolveSpec` naming this
        objective's solve of ``geom``: a training loss's configuration and
        an offline ``solve`` of the same problem are one record."""
        from .spec import SolveSpec     # spec imports this module
        if geom.eps != self.eps:
            raise ValueError(
                f"geometry eps={geom.eps} != objective eps={self.eps}")
        return SolveSpec(geometry=geom, a=a, b=b, method=method,
                         tol=self.tol, max_iter=self.max_iter,
                         policy=self.policy)
