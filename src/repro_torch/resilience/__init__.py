"""Failure classification of solves (the verdicts the streaming solver
reads) and the recovery policy record a ``SolveSpec`` carries. The
recovery ladder and chaos modules are not ported yet."""
from __future__ import annotations

from .health import VERDICTS, SolveHealth, classify, warm_is_poisoned
from .policy import RUNGS, RecoveryPolicy

__all__ = ["VERDICTS", "SolveHealth", "classify", "warm_is_poisoned",
           "RUNGS", "RecoveryPolicy"]
