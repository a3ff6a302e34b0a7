"""SolveSpec: the one record that names a solve.

A :class:`SolveSpec` holds, in one frozen record,

    WHAT   — ``geometry`` (and optional ``a`` / ``b`` weights)
    TARGET — ``tol`` / ``max_iter`` / ``momentum`` / an optional eps
             ``schedule``
    HOW    — ``method`` and an ``ExecutionPolicy`` (device, precision,
             fused-plan switch, megakernel cadence)

and the front doors take it: ``solve(spec)`` and ``solve_many([spec,
...])`` (``core.api``). The keyword forms stay as wrappers; their
execution kwargs with a bare problem emit a ``DeprecationWarning``.
Training code bridges through ``OTObjective.spec``, so a loss's
configuration and an offline solve of the same problem are one record.
``key`` is a ``torch.Generator``, as ``solve``'s. ``recovery`` holds a
:class:`~repro_torch.resilience.RecoveryPolicy`: ``solve(spec)`` then runs
the ladder (:func:`~repro_torch.resilience.ladder.solve_with_recovery`)
and ``solve_many(specs)`` sends each failed lane up it alone.
Counterpart of ``repro.core.spec``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..resilience.policy import RecoveryPolicy
from .api import METHODS, EpsSchedule, OTProblem
from .geometry import Geometry
from .objective import ExecutionPolicy

__all__ = ["SolveSpec"]


@dataclasses.dataclass(frozen=True)
class SolveSpec:
    """One solve, fully specified (see the module doc). ``a``/``b``
    default to uniform weights over the geometry's supports, on its
    device; ``rank``/``key`` feed the cost-family-converting methods
    ("arccos", "nystrom")."""

    geometry: Geometry
    a: Optional[torch.Tensor] = None
    b: Optional[torch.Tensor] = None
    method: str = "auto"
    schedule: Optional[EpsSchedule] = None
    tol: float = 1e-6
    max_iter: int = 2000
    momentum: float = 1.0
    policy: ExecutionPolicy = ExecutionPolicy()
    rank: Optional[int] = None
    key: Optional[torch.Generator] = None
    recovery: Optional[RecoveryPolicy] = None

    def __post_init__(self):
        if not isinstance(self.geometry, Geometry):
            raise TypeError(
                "SolveSpec.geometry must be a Geometry (wrap raw factors "
                "via repro_torch.core.geometry or OTProblem.from_*)")
        if self.method not in METHODS:
            raise ValueError(
                f"method must be one of {METHODS}, got {self.method!r}")
        if not isinstance(self.policy, ExecutionPolicy):
            raise TypeError("SolveSpec.policy must be an ExecutionPolicy")
        if self.recovery is not None and not isinstance(self.recovery,
                                                        RecoveryPolicy):
            raise TypeError(
                "SolveSpec.recovery must be a "
                "repro_torch.resilience.RecoveryPolicy (or None)")
        if self.key is not None and not isinstance(self.key,
                                                   torch.Generator):
            raise TypeError("SolveSpec.key must be a torch.Generator")

    @property
    def eps(self) -> float:
        return self.geometry.eps

    def problem(self) -> OTProblem:
        """The (geometry, a, b) record the solvers consume, on the
        geometry's device (which the policy's device, if any, must be)."""
        self.policy.check_device(self.geometry)
        return OTProblem.from_geometry(self.geometry, self.a, self.b,
                                       device=self.geometry.device)

    @classmethod
    def from_problem(cls, problem: OTProblem, **overrides) -> "SolveSpec":
        """Lift an :class:`OTProblem` (plus optional field overrides) into
        a spec."""
        return cls(geometry=problem.geometry, a=problem.a, b=problem.b,
                   **overrides)

    def replace(self, **changes) -> "SolveSpec":
        return dataclasses.replace(self, **changes)

    def solver_kwargs(self) -> dict:
        """Every keyword ``api.solve`` takes, in one dict."""
        return dict(method=self.method, schedule=self.schedule, tol=self.tol,
                    max_iter=self.max_iter, momentum=self.momentum,
                    rank=self.rank, key=self.key,
                    **self.policy.solver_kwargs())

    def describe(self) -> str:
        n, m = self.geometry.shape
        sched = "-" if self.schedule is None else "anneal"
        return (f"{type(self.geometry).__name__}({n}x{m}) eps={self.eps} "
                f"method={self.method} tol={self.tol} sched={sched} | "
                f"{self.policy.describe()}")
