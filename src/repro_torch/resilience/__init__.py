"""Resilient solves: failure classification, recovery ladders, chaos.

  health — SolveHealth verdicts (ok / maxed_out / diverged /
           poisoned_warm_start) classified on the host from any solve
  policy — RecoveryPolicy: the ordered, bounded, cumulative fallback
           ladder (log domain, f32, raise-eps annealing, per-iteration
           plan, cold restart)
  ladder — solve_with_recovery: the ladder executor for the core
           ``solve(spec)`` surface (serving has its own pre-captured twin)
  chaos  — deterministic seeded fault injection (NaN/Inf rows, runner
           exceptions, clock skew, warm-cache poisoning) for the
           ``ot_service --chaos`` lane and the tests

Counterpart of ``repro.resilience``.
"""
from __future__ import annotations

from .chaos import ChaosInjector, ChaosSpec
from .health import VERDICTS, SolveHealth, classify, warm_is_poisoned
from .ladder import LOG_TWIN, RecoveredSolve, solve_with_recovery
from .policy import RUNGS, RecoveryPolicy

__all__ = [
    "ChaosInjector",
    "ChaosSpec",
    "LOG_TWIN",
    "RUNGS",
    "RecoveredSolve",
    "RecoveryPolicy",
    "SolveHealth",
    "VERDICTS",
    "classify",
    "solve_with_recovery",
    "warm_is_poisoned",
]
